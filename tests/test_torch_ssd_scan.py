"""The SSD prefill scan's entry point (`kernels/ops.py::ssd_chunked`) on
the CPU and on 'meta', where its plain version runs.

On the CPU the entry point is bitwise the plain version
(`kernels/ref.py::ssd_chunked`, the mixer's scan before the kernel), also
under autograd; on 'meta' it gives the plain version's shapes and dtypes
and the products the dry run counts, which `ssd_scan.flops` (what the
card's kernel adds to `ops.kernel_flops`) equals; under a wall-clock span
it counts `ssd.plain` once a call and charges one kernel entry. The
card's autograd path (the kernel's forward, the plain version's
gradients) runs here with the plain version standing in for the kernel;
the kernel itself runs on the card only (`tests/test_torch_cuda.py`).
"""
import pytest
import torch

from repro_torch.core import telemetry
from repro_torch.kernels import ops, ref, ssd_scan
from repro_torch.launch import analysis
from repro_torch.models import ssm

# (N, S, H, P, n, chunk): the reduced configs' widths, mamba2's and
# Granite's state and head widths, a prompt shorter than a chunk, one
# chunk exactly
SHAPES = [(2, 48, 4, 16, 16, 16), (2, 64, 3, 64, 128, 16),
          (1, 40, 2, 64, 16, 256), (3, 32, 2, 16, 128, 32)]


def _inputs(N, S, H, P, n, dtype=torch.float32, seed=0, device="cpu",
            a_rows=False):
    g = torch.Generator().manual_seed(seed)
    xh = torch.randn((N, S, H, P), generator=g).to(dtype)
    dt = torch.rand((N, S, H), generator=g) * 0.2 + 0.005
    a = -(torch.rand((N, H) if a_rows else (H,), generator=g) * 15 + 1)
    b = torch.randn((N, S, n), generator=g).to(dtype)
    c = torch.randn((N, S, n), generator=g).to(dtype)
    return tuple(t.to(device) for t in (xh, dt, a, b, c))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_cpu_entry_is_the_plain_version_bitwise(shape, dtype):
    *dims, chunk = shape
    args = _inputs(*dims, dtype=dtype, a_rows=dims[0] > 2)
    y, h = ops.ssd_chunked(*args, chunk)
    y_r, h_r = ref.ssd_chunked(*args, chunk)
    y_m, h_m = ssm._ssd_chunked(*args, chunk)
    assert y.dtype == dtype and h.dtype == torch.float32
    assert h.shape == (dims[0], dims[2], dims[4], dims[3])
    for a, b in ((y, y_r), (h, h_r), (y_m, y_r), (h_m, h_r)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", SHAPES + [(8, 16384, 16, 64, 128, 256)])
def test_meta_gives_the_plain_shapes_and_products(shape):
    """On 'meta' the plain version runs: its shapes and dtypes, and the
    aten products the dry run counts, which `ssd_scan.flops` equals (the
    count the card's kernel charges in their place). The last shape is
    Granite-4.0-H's per-card prefill."""
    *dims, chunk = shape
    args = _inputs(*dims, dtype=torch.bfloat16, device="meta")
    k0 = ops.kernel_flops()
    (y, h), st = analysis.count(lambda: ops.ssd_chunked(*args, chunk))
    (y_r, h_r), st_r = analysis.count(lambda: ref.ssd_chunked(*args, chunk))
    assert ops.kernel_flops() == k0      # no kernel ran
    assert (y.shape, y.dtype, h.shape, h.dtype) == \
        (y_r.shape, y_r.dtype, h_r.shape, h_r.dtype)
    assert y.device.type == h.device.type == "meta"
    assert st.flops == st_r.flops == ssd_scan.flops(*dims, chunk)
    assert st.bytes_accessed == st_r.bytes_accessed


@pytest.mark.parametrize("shape", SHAPES)
def test_float64_recurrence_is_the_chunked_scan(shape):
    """The yardstick the card holds the kernel to (`ref.ssd_recurrence`,
    one position at a time in float64) and the chunked plain version
    compute the same scan: within fp32's rounding of each other, y and
    the final state as shares of their largest entries."""
    *dims, chunk = shape
    args = _inputs(*dims, seed=5, a_rows=True)
    y, h = ref.ssd_chunked(*args, chunk)
    y64, h64 = ref.ssd_recurrence(*args)
    assert y64.dtype == h64.dtype == torch.float64
    for got, want in ((y, y64), (h, h64)):
        assert float((got.double() - want).abs().max()
                     / want.abs().max()) < 2e-5


def test_grad_flows_through_the_plain_version():
    """On the CPU operands that require grad take the plain version, and
    their gradients are the plain version's."""
    args = _inputs(2, 32, 3, 16, 16, seed=3)
    leaves = [t.clone().requires_grad_() for t in args]
    y, h = ops.ssd_chunked(*leaves, 16)
    (y.square().sum() + h.sum()).backward()
    want = [t.clone().requires_grad_() for t in args]
    y_r, h_r = ref.ssd_chunked(*want, 16)
    (y_r.square().sum() + h_r.sum()).backward()
    assert torch.equal(y, y_r) and torch.equal(h, h_r)
    for a, b in zip(leaves, want):
        assert torch.equal(a.grad, b.grad)


@pytest.mark.parametrize("need", [(1, 1, 1, 1, 1), (1, 0, 0, 0, 0),
                                  (0, 1, 1, 0, 1)])
@pytest.mark.parametrize("use_final", [True, False])
def test_card_backward_differentiates_the_plain_version(monkeypatch, need,
                                                        use_final):
    """The card's autograd path (`ops._SSDScan`: the kernel's forward, the
    plain version's gradients), run here with the plain version standing
    in for the kernel: the gradients of the operands that require grad
    equal the plain version's bitwise, with or without a gradient of the
    final state, and no other operand gets one."""
    launched = []

    def kernel(*args):
        launched.append(torch.is_grad_enabled())
        return ref.ssd_chunked(*args)

    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(ops._ssd, "ssd_chunked", kernel)
    args = _inputs(2, 32, 3, 16, 16, seed=8)
    leaves = [t.clone().requires_grad_(bool(r)) for t, r in zip(args, need)]
    y, h = ops.ssd_chunked(*leaves, 16)
    assert launched == [False]           # the forward ran without a graph
    assert type(y.grad_fn).__name__ == "_SSDScanBackward"
    (y.square().sum() + (h.sum() if use_final else 0)).backward()
    assert launched == [False]           # the backward launched nothing
    want = [t.clone().requires_grad_(bool(r)) for t, r in zip(args, need)]
    y_r, h_r = ref.ssd_chunked(*want, 16)
    (y_r.square().sum() + (h_r.sum() if use_final else 0)).backward()
    assert torch.equal(y, y_r) and torch.equal(h, h_r)
    for a, b, r in zip(leaves, want, need):
        assert (a.grad is None) == (not r)
        if r:
            assert torch.equal(a.grad, b.grad)


def test_span_counts_the_plain_scan_once_a_call():
    rec = telemetry.WallTracer()
    args = _inputs(2, 32, 3, 16, 16, seed=4)
    with telemetry.use(rec), rec.span("ssm.scan", track="lm"):
        ops.ssd_chunked(*args, 16)
        ops.ssd_chunked(*args, 32)
    ops.ssd_chunked(*args, 16)           # no span open: nothing counted
    span, = rec.spans()
    assert span["counters"][telemetry.SSD_PLAIN] == 2
    assert telemetry.SSD_KERNEL not in span["counters"]
    assert span["counters"][telemetry.ENTRIES] == 2
    assert span["counters"][telemetry.ENTRY_NS] > 0


@pytest.mark.parametrize("S,chunk", [(48, 32), (30, 16)])
def test_non_tiling_chunk_raises(S, chunk):
    args = _inputs(1, S, 2, 16, 16)
    with pytest.raises(ValueError, match="does not tile"):
        ops.ssd_chunked(*args, chunk)
    with pytest.raises(ValueError, match="does not tile"):
        ssd_scan.chunk_len(S, chunk)


def test_kernel_wrapper_takes_cuda_tensors_only():
    args = _inputs(1, 16, 2, 16, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan.ssd_chunked(*args, 16)


@pytest.mark.parametrize("S,chunk,want", [(16384, 256, 256), (100, 256, 100),
                                          (48, 16, 16), (16, 16, 16)])
def test_chunk_len_is_the_plain_versions(S, chunk, want):
    assert ssd_scan.chunk_len(S, chunk) == want == min(chunk, S)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_needs_counts_the_scans_operands_and_causal_products(shape, dtype):
    """`ssd_scan.needs`, the bound's two sides: its bytes are those of the
    operands and the two results, once each; its products are the plain
    version's with the quadratic forms cut to the causal pairs."""
    N, S, H, P, n, chunk = shape
    args = _inputs(N, S, H, P, n, dtype, seed=9)
    y, h = ref.ssd_chunked(*args, chunk)
    nbytes, ops_ = ssd_scan.needs(N, S, H, P, n, chunk,
                                  torch.finfo(dtype).bits // 8)
    a = args[2].expand(N, H)
    assert nbytes == sum(t.numel() * t.element_size()
                         for t in (*args[:2], a, *args[3:], y, h))
    l = ssd_scan.chunk_len(S, chunk)
    causal = N * (S // l) * l * (l + 1) * (n + H * P)
    assert ops_ - causal == ssd_scan.flops(N, S, H, P, n, chunk) \
        - 2 * N * S * l * (n + H * P)


def test_prefill_counts_one_scan_a_mamba_layer():
    """A traced prefill of a small Granite-4.0-H (layers mamba /
    attention) on the CPU: the Mamba layer's `ssm.scan` span counts one
    plain scan and one kernel entry, and nothing else counts a scan."""
    from repro_torch.configs import ParallelConfig, get_config, \
        reduced_config
    from repro_torch.convert import stack_global
    from repro_torch.parallel import stages
    cfg = reduced_config(get_config("granite-4.0-h-small"))
    mesh = {"pod": 1, "data": 1, "model": 2}
    s = 16
    pf, _ctx, _specs, bspec = stages.build_prefill(
        cfg, ParallelConfig(), mesh, 1, s, device="cpu")
    params = stages.init_params(cfg, mesh, 2, seed=1, device="cpu",
                                serve=True)
    tokens = torch.arange(s, dtype=torch.int32)[None]
    batch = {"tokens": stack_global(tokens, mesh, bspec["tokens"])}
    rec = telemetry.WallTracer()
    with telemetry.use(rec):
        pf(params, batch)
    spans = rec.spans()
    root, = [e for e in spans if e["parent"] is None]
    scan, = [e for e in spans if e["name"] == "ssm.scan"]
    assert scan["counters"][telemetry.SSD_PLAIN] == 1
    assert scan["counters"][telemetry.ENTRIES] == 1
    assert root["counters"][telemetry.SSD_PLAIN] == 1
    assert telemetry.SSD_KERNEL not in root["counters"]
