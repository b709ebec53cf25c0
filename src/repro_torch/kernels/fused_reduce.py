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
maps did, and writes its result either to a fresh tensor or, with
`in_place`, back where it read the target. Both
count their launches into `fused_combine.launches`. Their plain versions
are `ref.fused_combine` and `ref.fused_combine_at`.

Beside K1 in the same source, `region_copy`: the data plane's copy
exchange in one launch, every segment of a region of one rank-stacked
buffer written into a region of another (or the same) through both
region indices. It counts into `region_copy.launches`; its plain version
is `ref.region_copy`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._index import (
    check_in_place, check_index, row_and_unit,
)

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
                     out_dtype=None, out=None, in_place=False):
    """Launch K1 once over every segment of two regions of rank-stacked
    CUDA buffers, read in place: `op(gather(a).f32, gather(b).f32)` as a
    (k, ranks, seg) tensor of `out_dtype` (default a.dtype) — `out` when
    given (it must not overlap a or b), else a new one. With `in_place`
    the result is written back into a's region instead through a_index
    and `a` is returned (b's region must not overlap any
    rank's region of a but its own element). Each index is `(unit, rows
    (1, ranks, 1), units (k, ranks, units/k))` as
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
    if in_place:
        check_in_place("fused_combine_at", a, out_dtype, out)
        out = a
    elif out is None:
        out = torch.empty((k, ranks, seg), dtype=out_dtype, device=a.device)
    elif (out.device != a.device or tuple(out.shape) != (k, ranks, seg)
            or out.dtype != out_dtype or not out.is_contiguous()):
        raise ValueError(f"fused_combine_at: `out` must be a contiguous "
                         f"{(k, ranks, seg)} {out_dtype} tensor on "
                         f"{a.device}")
    if k * ranks * seg == 0:
        return out
    v = 16 // a.element_size()
    vec_ok = int(all(t.data_ptr() % 16 == 0 for t in (a, b, out))
                 and ue_a % v == 0 and ue_b % v == 0)
    lib = _build.library()
    rc = lib.k1_fused_combine_at(
        a.data_ptr(), rows_a.data_ptr(), units_a.data_ptr(), row_a, ue_a,
        upk_a, b.data_ptr(), rows_b.data_ptr(), units_b.data_ptr(), row_b,
        ue_b, upk_b, None if in_place else out.data_ptr(), k,
        ranks, seg, _dtype_code(a.dtype), _dtype_code(out_dtype),
        _build.OP_CODES[op], vec_ok, _build.stream_handle(a))
    fused_combine.launches += 1
    _build.check(rc, "fused_combine_at")
    return out


def region_copy(src, src_index, dst, dst_index):
    """Launch the indexed copy once over every segment of one copy
    exchange: dst's region `dst_index` = src's region `src_index`, both
    rank-stacked CUDA buffers of one dtype (any), read and written in
    place; returns `dst`. The two regions must not overlap (`src` may be
    `dst`). Raises on anything it cannot take."""
    if src.device.type != "cuda" or dst.device != src.device:
        raise ValueError(f"region_copy: needs CUDA tensors on one device, "
                         f"got {src.device} and {dst.device}")
    if src.dtype != dst.dtype:
        raise ValueError(f"region_copy: dtypes differ: {src.dtype} vs "
                         f"{dst.dtype}")
    if not (src.is_contiguous() and dst.is_contiguous()):
        raise ValueError("region_copy: buffers must be contiguous")
    check_index("region_copy", "src", src_index, src.device)
    check_index("region_copy", "dst", dst_index, src.device)
    unit_s, rows_s, units_s = src_index
    unit_d, rows_d, units_d = dst_index
    row_s, ue_s = row_and_unit("region_copy", "src", src, unit_s)
    row_d, ue_d = row_and_unit("region_copy", "dst", dst, unit_d)
    k, ranks, upk_s = units_s.shape
    upk_d = units_d.shape[2]
    seg = upk_s * ue_s
    if units_d.shape[:2] != (k, ranks) or upk_d * ue_d != seg:
        raise ValueError(f"region_copy: regions differ: {k} x {ranks} x "
                         f"{seg} vs {tuple(units_d.shape[:2])} x "
                         f"{upk_d * ue_d} elements")
    if k * ranks * seg == 0:
        return dst
    # the widest word every unit and base holds whole (16 bytes: vectors)
    esize = src.element_size()
    word = next(w for w in (16, 8, 4, 2, 1)
                if (ue_s * esize) % w == 0 and (ue_d * esize) % w == 0
                and src.data_ptr() % w == 0 and dst.data_ptr() % w == 0)
    words = lambda n: n * esize // word  # noqa: E731
    if max(k, ranks) > _MAX_GRID_YZ or max(words(seg), words(ue_s),
                                           words(ue_d)) >= 2**31:
        raise ValueError(f"region_copy: {k} segments x {ranks} ranks x "
                         f"{seg} elements exceed the launch grid")
    lib = _build.library()
    rc = lib.region_copy_at(
        src.data_ptr(), rows_s.data_ptr(), units_s.data_ptr(), words(row_s),
        words(ue_s), upk_s, dst.data_ptr(), rows_d.data_ptr(),
        units_d.data_ptr(), words(row_d), words(ue_d), upk_d, k, ranks,
        words(seg), word, _build.stream_handle(src))
    region_copy.launches += 1
    _build.check(rc, "region_copy")
    return dst


region_copy.launches = 0
