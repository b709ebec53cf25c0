"""K1 wrapper: the binary streaming plugin as a CUDA kernel on Hopper.

Replaces the TPU kernel `repro/kernels/fused_reduce.py::fused_combine`
(Pallas, body `_kernel`): `op(x.f32, y.f32).astype(out_dtype)` for op in
add/max/min/mul. The kernel (csrc/fused_combine.cu) is memory-bound on
the H100 — two reads and one write per element — and takes the tensors
as they are, contiguous, with a masked tail instead of the TPU's 256x128
padding. Its plain version is `ref.fused_combine`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

OPS = ("add", "max", "min", "mul")


def _dtype_code(dtype) -> int:
    name = str(dtype).replace("torch.", "")
    if name not in _build.DTYPE_CODES:
        raise TypeError(f"fused_combine: unsupported dtype {dtype}")
    return _build.DTYPE_CODES[name]


def _check_out(out, x, out_dtype) -> None:
    if (out.device != x.device or out.shape != x.shape
            or out.dtype != out_dtype or not out.is_contiguous()):
        raise ValueError(f"fused_combine: `out` must be a contiguous "
                         f"{tuple(x.shape)} {out_dtype} tensor on {x.device}")


def fused_combine(x, y, op: str = "add", out_dtype=None, out=None):
    """Launch K1 on CUDA tensors; returns a tensor of `out_dtype` (default
    x.dtype) with x's shape — `out` when given (it may alias x), else a
    new one. Raises on anything it cannot take."""
    if op not in OPS:
        raise ValueError(f"fused_combine: unknown op {op!r}")
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(f"fused_combine: needs CUDA tensors on one device, "
                         f"got {x.device} and {y.device}")
    if x.shape != y.shape or x.dtype != y.dtype:
        raise ValueError(f"fused_combine: operands differ: {x.shape} "
                         f"{x.dtype} vs {y.shape} {y.dtype}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("fused_combine: operands must be contiguous")
    out_dtype = out_dtype or x.dtype
    if out is None:
        out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    _check_out(out, x, out_dtype)
    n = x.numel()
    if n == 0:
        return out
    vec_ok = int(all(t.data_ptr() % 16 == 0 for t in (x, y, out)))
    lib = _build.library()
    rc = lib.k1_fused_combine(x.data_ptr(), y.data_ptr(), out.data_ptr(), n,
                              _dtype_code(x.dtype), _dtype_code(out_dtype),
                              _build.OP_CODES[op], vec_ok,
                              _build.stream_handle(x))
    fused_combine.launches += 1
    _build.check(rc, "fused_combine")
    return out


fused_combine.launches = 0
