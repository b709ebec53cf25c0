"""K1's whole-exchange entry point (`ops.fused_combine_at`): one call
combines every segment of an exchange, read in place through the
executor's region indices, into a (k, ranks, seg) result.

Each case holds that result, bit for bit, against the concatenation of
the per-segment results of K1's plain version on the gathered operands,
and on the CPU against the JAX reference's `fused_combine` (its Pallas
kernel in interpret mode) on the same operands. The cuda cases run the
CUDA kernel and skip without a card; jax is imported only in the CPU
cases (which skip their JAX comparison where it is missing), so the file
runs on a machine without it:

    PYTHONPATH=src python -m pytest tests/test_torch_k1_exchange.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import engine as engine_mod
from repro_torch.kernels import fused_reduce, ops, ref

RANKS = 8

# name -> (buffer rows, width, region of rank d as (start, length) spans);
# each rank receives from rank d - 1 into the same spans of its own row
LAYOUTS = {
    # one 16-byte unit run per rank and segment (units per segment 1)
    "aligned": (2048, 1, lambda d: ((256 * ((d + 2) % RANKS), 256),)),
    # two spans 4 rows off the chunk grid: 4-element units, several a
    # segment (16-byte vectors in fp32, the scalar path in bf16)
    "multi_unit": (2048, 1, lambda d: ((256 * ((d + 2) % RANKS) + 4, 128),
                                       (256 * ((d + 5) % RANKS) + 124,
                                        128))),
    # one-element units at odd offsets: never a 16-byte vector
    "unaligned": (RANKS * 97, 1, lambda d: ((97 * ((d + 2) % RANKS) + 1,
                                             96),)),
    # rows of 3 elements: 192-element units at k = 1, 6 at k = 32
    "wide": (512, 3, lambda d: ((64 * ((d + 2) % RANKS), 64),)),
}

DTYPES = {  # case -> (operand dtype, out_dtype argument)
    "f32": (torch.float32, None),
    "bf16": (torch.bfloat16, None),
    "f32_to_bf16": (torch.float32, torch.bfloat16),
    "bf16_to_f32": (torch.bfloat16, torch.float32),
}


@pytest.fixture(params=["cpu", "cuda"])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device(request.param)


def _operands(layout: str, dtype, device, seed: int):
    L, width, _region = LAYOUTS[layout]
    g = torch.Generator().manual_seed(seed)
    a, b = (torch.randn((RANKS, L, width), generator=g)
            * torch.exp(2 * torch.randn((RANKS, L, width), generator=g))
            for _ in range(2))
    return a.to(device=device, dtype=dtype), b.to(device=device, dtype=dtype)


def _indices(layout: str, k: int, device):
    _L, _w, region = LAYOUTS[layout]
    spans = tuple(region(d) for d in range(RANKS))
    src = tuple((d - 1) % RANKS for d in range(RANKS))
    return (engine_mod._region_index(tuple(range(RANKS)), spans, k, device),
            engine_mod._region_index(src, spans, k, device))


def _jax_combine(ga, gb, op, out_dtype):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops

    def j(t):
        return jnp.asarray(t.float().numpy()).astype(
            str(t.dtype).replace("torch.", ""))
    want = jops.fused_combine(
        j(ga), j(gb), op=op,
        out_dtype=out_dtype and getattr(jnp, str(out_dtype)[6:]))
    return np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("dtypes", list(DTYPES))
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("k", [1, 4, 32])
@pytest.mark.parametrize("op", ["add", "max", "min", "mul"])
def test_k1_at_whole_exchange(device, op, k, layout, dtypes):
    dtype, out_dtype = DTYPES[dtypes]
    a, b = _operands(layout, dtype, device, seed=29 + k)
    tgt, pay = _indices(layout, k, device)
    units = tgt[2]
    assert tuple(units.shape[:2]) == (k, RANKS)
    if layout in ("multi_unit", "unaligned"):
        assert units.shape[2] > 1                  # several units a segment
    before = fused_reduce.fused_combine.launches
    got = ops.fused_combine_at(a, tgt, b, pay, op, out_dtype=out_dtype)
    launched = fused_reduce.fused_combine.launches - before
    assert launched == (1 if device.type == "cuda" else 0)
    ga, gb = engine_mod._gather(a, tgt), engine_mod._gather(b, pay)
    seg = ga.shape[2]
    assert tuple(got.shape) == (k, RANKS, seg)
    assert got.dtype == (out_dtype or dtype)
    per_segment = torch.stack([ref.fused_combine(ga[j], gb[j], op, out_dtype)
                               for j in range(k)])
    assert torch.equal(got, per_segment)
    assert torch.equal(got, ref.fused_combine_at(a, tgt, b, pay, op,
                                                 out_dtype))
    out = torch.full_like(got, float("nan"))
    assert ops.fused_combine_at(a, tgt, b, pay, op, out_dtype=out_dtype,
                                out=out) is out
    assert torch.equal(out, got)
    meta = ops.fused_combine_at(a.to("meta"), tgt, b.to("meta"), pay, op,
                                out_dtype=out_dtype)
    assert meta.shape == got.shape and meta.dtype == got.dtype
    if device.type == "cpu":
        assert np.array_equal(got.float().numpy(),
                              _jax_combine(ga, gb, op, out_dtype))
