"""The SSD prefill scan (Mamba2's chunked state-space dual) as CUDA
kernels on Hopper.

Replaces no TPU kernel: the reference computes the scan in jnp
(`repro/models/ssm.py::_ssd_chunked`) and leaves it to XLA. Its plain
version, `ref.ssd_chunked`, writes an (l, l, heads) fp32 decay tensor a
chunk and four more of that size around it; the kernels (csrc/ssd_scan.cu)
apply the decay as they stage their operands and write only y, the final
state and small fp32 work buffers: the within-chunk cumulative sums, B and
C transposed, each chunk's C B^T and the chunk states. Five launches a
call, in fp32 throughout.
`ssd_chunked.launches` counts the launches; `ssd_chunked.flops` the
products the plain version would have counted (`flops`), since a ctypes
launch is invisible to torch's dispatch modes (`launch/analysis.py`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

L_MAX = 1024           # the longest chunk the kernels take (csrc L_MAX)
_MAX_GRID_YZ = 65535   # grid y (chunks) and z (sequences)
LAUNCHES = 5           # prep, cb, state, pass, scan


def chunk_len(s: int, chunk: int) -> int:
    """The chunk length l = min(chunk, s) the scan takes for `s`
    positions; raises where it does not tile them, as the plain version
    does."""
    l = min(chunk, s)
    if s % l:
        raise ValueError(f"chunk {l} does not tile {s} positions")
    return l


def flops(N: int, S: int, H: int, P: int, n: int, chunk: int) -> int:
    """The plain version's products over N sequences of S positions, as
    torch's flop counter counts its einsums: C B^T, the decayed
    quadratic form, the chunk states and the inter-chunk read-out."""
    l = chunk_len(S, chunk)
    nc = S // l
    return 2 * N * nc * l * (l * n + H * l * P + 2 * H * n * P)


def needs(N: int, S: int, H: int, P: int, n: int, chunk: int,
          itemsize: int) -> tuple:
    """(bytes, operations) the scan needs, its bound's two sides: x, B and
    C (`itemsize` each), dt and a read once, y and the final state
    written once; C B^T and the quadratic form over the causal pairs
    only, the chunk states and their read-out."""
    l = chunk_len(S, chunk)
    nc = S // l
    pairs = l * (l + 1) // 2
    nbytes = (2 * N * S * H * P + 2 * N * S * n) * itemsize \
        + N * S * H * 4 + N * H * 4 + N * H * n * P * 4
    ops = N * nc * (2 * pairs * n + 2 * pairs * H * P + 4 * l * H * n * P)
    return nbytes, ops


def _dtype_code(dtype) -> int:
    name = str(dtype).replace("torch.", "")
    if name not in _build.DTYPE_CODES:
        raise TypeError(f"ssd_chunked: unsupported dtype {dtype}")
    return _build.DTYPE_CODES[name]


def _last_contiguous(t):
    return t if t.stride(-1) == 1 else t.contiguous()


def ssd_chunked(xh, dt, a_neg, b_in, c_in, chunk: int):
    """Launch the scan on CUDA tensors: xh (N, S, H, P), dt (N, S, H),
    a_neg (H,) or (N, H), b_in and c_in (N, S, n) -> (y (N, S, H, P) in
    xh's dtype, final state (N, H, n, P) fp32), `ref.ssd_chunked`'s
    contract. Any strides; x, B and C are read in their own dtype where
    the three share one (fp32 or bf16), else as fp32 (as the plain
    version reads them all). Raises on anything it cannot take."""
    args = (xh, dt, a_neg, b_in, c_in)
    if xh.device.type != "cuda" or any(t.device != xh.device for t in args):
        raise ValueError(f"ssd_chunked: needs CUDA tensors on one device, "
                         f"got {[str(t.device) for t in args]}")
    if xh.ndim != 4:
        raise ValueError(f"ssd_chunked: xh must be (N, S, H, P), got "
                         f"{tuple(xh.shape)}")
    N, S, H, P = xh.shape
    n = b_in.shape[-1]
    if (tuple(dt.shape) != (N, S, H) or tuple(b_in.shape) != (N, S, n)
            or tuple(c_in.shape) != (N, S, n)
            or tuple(a_neg.shape) not in ((H,), (N, H))):
        raise ValueError(f"ssd_chunked: shapes do not match: xh "
                         f"{tuple(xh.shape)}, dt {tuple(dt.shape)}, a_neg "
                         f"{tuple(a_neg.shape)}, b {tuple(b_in.shape)}, c "
                         f"{tuple(c_in.shape)}")
    l = chunk_len(S, chunk)
    nc = S // l
    if l > L_MAX or nc > _MAX_GRID_YZ or N > _MAX_GRID_YZ:
        raise ValueError(f"ssd_chunked: chunk {l} (at most {L_MAX}), "
                         f"{nc} chunks or {N} sequences (at most "
                         f"{_MAX_GRID_YZ}) exceed the launch grid")
    out_dtype = xh.dtype
    if not out_dtype.is_floating_point:
        raise TypeError(f"ssd_chunked: unsupported dtype {out_dtype}")
    # x, B and C share one operand type; any other mix is read as fp32,
    # as the plain version reads every operand (`.float()`), and y cast
    # back to x's dtype
    dtype = out_dtype if (b_in.dtype == c_in.dtype == out_dtype
                          and out_dtype in (torch.float32, torch.bfloat16)) \
        else torch.float32
    x, b, c = (_last_contiguous(t.to(dtype)) for t in (xh, b_in, c_in))
    dtf = _last_contiguous(dt.float())
    a = _last_contiguous(a_neg.float().expand(N, H))
    dev = xh.device
    f32 = torch.float32
    y = torch.empty((N, S, H, P), dtype=dtype, device=dev)
    final = torch.empty((N, H, n, P), dtype=f32, device=dev)
    ssd_chunked.flops += flops(N, S, H, P, n, chunk)
    if y.numel() == 0 or n == 0:
        return y.zero_().to(out_dtype), final.zero_()
    ll = torch.empty((N, nc, H, l), dtype=f32, device=dev)
    bt = torch.empty((N, nc, n, l), dtype=f32, device=dev)
    ct = torch.empty((N, nc, n, l), dtype=f32, device=dev)
    cbt = torch.empty((N, nc, l, l), dtype=f32, device=dev)
    states = torch.empty((N, nc, H, n, P), dtype=f32, device=dev)
    lib = _build.library()
    rc = lib.ssd_chunked(
        x.data_ptr(), dtf.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), y.data_ptr(), ll.data_ptr(), bt.data_ptr(),
        ct.data_ptr(), cbt.data_ptr(), states.data_ptr(), final.data_ptr(),
        x.stride(0), x.stride(1), x.stride(2), b.stride(0), b.stride(1),
        c.stride(0), c.stride(1), dtf.stride(0), dtf.stride(1), a.stride(0),
        N, l, nc, H, P, n, _dtype_code(dtype), _build.stream_handle(xh))
    ssd_chunked.launches += LAUNCHES
    _build.check(rc, "ssd_chunked")
    return y.to(out_dtype), final


ssd_chunked.launches = 0
ssd_chunked.flops = 0
