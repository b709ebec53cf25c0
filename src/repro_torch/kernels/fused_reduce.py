"""K1 wrapper: the binary streaming plugin as a CUDA kernel on Hopper.

Replaces the TPU kernel `repro/kernels/fused_reduce.py::fused_combine`
(Pallas, body `_kernel`): `op(x.f32, y.f32).astype(out_dtype)` for op in
add/max/min/mul. The kernel (csrc/fused_combine.cu) is memory-bound on
the H100 — two reads and one write per element — and has two entry
points: `fused_combine` takes contiguous tensors as they are, with a
masked tail instead of the TPU's 256x128 padding; `fused_combine_at`
combines every segment of one exchange in one launch, reading both
operands in place through the executor's region indices
(`core/engine.py::_region_index`), as the TPU kernel's BlockSpec index
maps did. Both count their launches into `fused_combine.launches`. Their
plain versions are `ref.fused_combine` and `ref.fused_combine_at`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._index import check_index, row_and_unit

OPS = ("add", "max", "min", "mul")
_MAX_GRID_YZ = 65535   # grid y (ranks) and z (segments) of the indexed launch


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


def fused_combine_at(a, a_index, b, b_index, op: str = "add",
                     out_dtype=None, out=None):
    """Launch K1 once over every segment of two regions of rank-stacked
    CUDA buffers, read in place: `op(gather(a).f32, gather(b).f32)` as a
    (k, ranks, seg) tensor of `out_dtype` (default a.dtype) — `out` when
    given (it must not overlap a or b), else a new one. Each index is
    `(unit, rows (1, ranks, 1), units (k, ranks, units/k))` as
    `core/engine.py::_region_index` builds it. Raises on anything it
    cannot take."""
    if op not in OPS:
        raise ValueError(f"fused_combine_at: unknown op {op!r}")
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"fused_combine_at: needs CUDA tensors on one "
                         f"device, got {a.device} and {b.device}")
    if a.dtype != b.dtype:
        raise ValueError(f"fused_combine_at: operand dtypes differ: "
                         f"{a.dtype} vs {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("fused_combine_at: operands must be contiguous")
    check_index("fused_combine_at", "a", a_index, a.device)
    check_index("fused_combine_at", "b", b_index, a.device)
    unit_a, rows_a, units_a = a_index
    unit_b, rows_b, units_b = b_index
    row_a, ue_a = row_and_unit("fused_combine_at", "a", a, unit_a)
    row_b, ue_b = row_and_unit("fused_combine_at", "b", b, unit_b)
    k, ranks, upk_a = units_a.shape
    upk_b = units_b.shape[2]
    seg = upk_a * ue_a
    if units_b.shape[:2] != (k, ranks) or upk_b * ue_b != seg:
        raise ValueError(f"fused_combine_at: regions differ: {k} x {ranks} "
                         f"x {seg} vs {tuple(units_b.shape[:2])} x "
                         f"{upk_b * ue_b} elements")
    if max(k, ranks) > _MAX_GRID_YZ or max(seg, ue_a, ue_b) >= 2**31:
        raise ValueError(f"fused_combine_at: {k} segments x {ranks} ranks x "
                         f"{seg} elements exceed the launch grid")
    out_dtype = out_dtype or a.dtype
    if out is None:
        out = torch.empty((k, ranks, seg), dtype=out_dtype, device=a.device)
    if (out.device != a.device or tuple(out.shape) != (k, ranks, seg)
            or out.dtype != out_dtype or not out.is_contiguous()):
        raise ValueError(f"fused_combine_at: `out` must be a contiguous "
                         f"{(k, ranks, seg)} {out_dtype} tensor on "
                         f"{a.device}")
    if out.numel() == 0:
        return out
    v = 16 // a.element_size()
    vec_ok = int(all(t.data_ptr() % 16 == 0 for t in (a, b, out))
                 and ue_a % v == 0 and ue_b % v == 0)
    lib = _build.library()
    rc = lib.k1_fused_combine_at(
        a.data_ptr(), rows_a.data_ptr(), units_a.data_ptr(), row_a, ue_a,
        upk_a, b.data_ptr(), rows_b.data_ptr(), units_b.data_ptr(), row_b,
        ue_b, upk_b, out.data_ptr(), k, ranks, seg, _dtype_code(a.dtype),
        _dtype_code(out_dtype), _build.OP_CODES[op], vec_ok,
        _build.stream_handle(a))
    fused_combine.launches += 1
    _build.check(rc, "fused_combine_at")
    return out
