"""K2/K3 wrappers: the int8 wire codec as CUDA kernels on Hopper.

K2 `quantize_blocks` replaces `repro/kernels/quantize.py::quantize_blocks`
and K3 `dequantize_blocks` replaces
`repro/kernels/quantize.py::dequantize_blocks` (Pallas, bodies
`_quant_kernel` / `_dequant_kernel`). Both kernels (csrc/quantize.cu) are
memory-bound on the H100. They work on a stack of codec rows, each padded
to whole 256-element blocks on its own — the reference engine's jnp wire
format, not the 32768-element padding of its Pallas wrapper. K3 can fuse
the combine of the consume site, and for an fp32 add it rounds once, as
the reference does.

Two entry points each, both counting into the kernel's `.launches`:
`quantize_blocks` / `dequantize_blocks` take contiguous (rows, n_valid)
operands; `quantize_blocks_at` / `dequantize_blocks_at` take a whole
compressed exchange in one launch, the payload and the combine target read
in place through the executor's region indices
(`core/engine.py::_region_index`). Plain versions: `ref.quantize_blocks`,
`ref.dequantize_blocks`, `ref.quantize_blocks_at`,
`ref.dequantize_blocks_at`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._index import check_index, row_and_unit
from repro_torch.kernels.ref import QUANT_BLOCK, padded_len

_COMBINE_OPS = ("copy", "add", "max", "min", "mul")


def _dtype_code(dtype, who: str) -> int:
    name = str(dtype).replace("torch.", "")
    if name not in _build.DTYPE_CODES:
        raise TypeError(f"{who}: unsupported dtype {dtype}")
    return _build.DTYPE_CODES[name]


def _check_grid(who: str, rows: int, lp: int) -> None:
    # csrc/quantize.cu keeps a row's length and the block count in int
    if lp >= 2**31 or rows * (lp // QUANT_BLOCK) >= 2**30:
        raise ValueError(f"{who}: {rows} rows of {lp} elements exceed the "
                         f"launch grid")


def _check_codes(who: str, q2d, scales, n_valid: int) -> tuple:
    """(rows, lp) of a wire: int8 codes (rows, lp) and fp32 scales
    (rows, lp/256) on one CUDA device, n_valid padding to lp."""
    if q2d.device.type != "cuda" or scales.device != q2d.device:
        raise ValueError(f"{who}: needs CUDA tensors on one device")
    if q2d.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"{who}: needs int8 codes, fp32 scales")
    if q2d.ndim != 2 or q2d.shape[1] % QUANT_BLOCK:
        raise ValueError(f"{who}: codes must be (rows, k*256), got "
                         f"{tuple(q2d.shape)}")
    rows, lp = q2d.shape
    if tuple(scales.shape) != (rows, lp // QUANT_BLOCK):
        raise ValueError(f"{who}: scales {tuple(scales.shape)} do not match "
                         f"codes {tuple(q2d.shape)}")
    if not 0 <= n_valid <= lp or padded_len(n_valid) != lp:
        raise ValueError(f"{who}: n_valid {n_valid} does not pad to {lp}")
    if not (q2d.is_contiguous() and scales.is_contiguous()) or \
            q2d.data_ptr() % 8:
        raise ValueError(f"{who}: codes (8-byte aligned) and scales must "
                         f"be contiguous")
    _check_grid(who, rows, lp)
    return rows, lp


def _overlaps(a, b) -> bool:
    """Whether the storage of tensors a and b overlaps."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and \
        b0 < a0 + a.numel() * a.element_size()


def quantize_blocks(x2d):
    """Launch K2: (rows, n_valid) fp32/bf16 CUDA tensor -> (int8
    (rows, Lp), fp32 scales (rows, Lp/256)), Lp = n_valid padded to 256."""
    if x2d.device.type != "cuda":
        raise ValueError(f"quantize_blocks: needs a CUDA tensor, got "
                         f"{x2d.device}")
    if x2d.ndim != 2 or not x2d.is_contiguous():
        raise ValueError(f"quantize_blocks: needs a contiguous 2-D tensor, "
                         f"got shape {tuple(x2d.shape)}")
    code = _dtype_code(x2d.dtype, "quantize_blocks")
    rows, n_valid = x2d.shape
    lp = padded_len(n_valid)
    q = torch.empty((rows, lp), dtype=torch.int8, device=x2d.device)
    s = torch.empty((rows, lp // QUANT_BLOCK), dtype=torch.float32,
                    device=x2d.device)
    if rows * lp == 0:
        return q, s
    _check_grid("quantize_blocks", rows, lp)
    lib = _build.library()
    rc = lib.k2_quantize_blocks(x2d.data_ptr(), q.data_ptr(), s.data_ptr(),
                                rows, n_valid, lp, code,
                                _build.stream_handle(x2d))
    quantize_blocks.launches += 1
    _build.check(rc, "quantize_blocks")
    return q, s


def quantize_blocks_at(src, index):
    """Launch K2 once over every segment of a region of the rank-stacked
    CUDA buffer `src`, read in place. `index` is `(unit, rows (1, ranks,
    1), units (k, ranks, units/k))` (`core/engine.py::_region_index`).
    Returns codes (k*ranks, Lp) and scales (k*ranks, Lp/256), row
    j*ranks + r for segment j of rank r, Lp = seg padded to 256: the k
    per-segment wires stacked in j order. Raises on anything it cannot
    take."""
    who = "quantize_blocks_at"
    if src.device.type != "cuda":
        raise ValueError(f"{who}: needs a CUDA tensor, got {src.device}")
    if not src.is_contiguous():
        raise ValueError(f"{who}: the buffer must be contiguous")
    code = _dtype_code(src.dtype, who)
    check_index(who, "src", index, src.device)
    unit, ridx, uidx = index
    row, ue = row_and_unit(who, "src", src, unit)
    k, ranks, upk = uidx.shape
    seg = upk * ue
    lp = padded_len(seg)
    q = torch.empty((k * ranks, lp), dtype=torch.int8, device=src.device)
    s = torch.empty((k * ranks, lp // QUANT_BLOCK), dtype=torch.float32,
                    device=src.device)
    if q.numel() == 0:
        return q, s
    _check_grid(who, k * ranks, lp)
    lib = _build.library()
    rc = lib.k2_quantize_blocks_at(
        src.data_ptr(), ridx.data_ptr(), uidx.data_ptr(), row, ue, upk, k,
        ranks, q.data_ptr(), s.data_ptr(), seg, lp, code,
        _build.stream_handle(src))
    quantize_blocks.launches += 1
    _build.check(rc, who)
    return q, s


def dequantize_blocks(q2d, scales, n_valid: int, old=None, op: str = "copy",
                      out_dtype=None, out=None):
    """Launch K3: `q * s` trimmed to (rows, n_valid), combined into `old`
    (rows, n_valid) with `op` unless op == 'copy'. The result has old's
    dtype (else `out_dtype`, default fp32) and lands in `out` when given
    (it may alias old), else in a new tensor."""
    who = "dequantize_blocks"
    if op not in _COMBINE_OPS:
        raise ValueError(f"{who}: unknown op {op!r}")
    rows, lp = _check_codes(who, q2d, scales, n_valid)
    if op != "copy":
        if old is None:
            raise ValueError(f"{who}: op {op!r} needs `old`")
        if (old.device != q2d.device or old.numel() != rows * n_valid
                or not old.is_contiguous()):
            raise ValueError(f"{who}: `old` must be a contiguous "
                             f"(rows, n_valid) tensor on the codes' device")
        out_dtype = old.dtype
    out_dtype = out_dtype or torch.float32
    code = _dtype_code(out_dtype, who)
    if out is None:
        out = torch.empty((rows, n_valid), dtype=out_dtype,
                          device=q2d.device)
    if (out.device != q2d.device or out.numel() != rows * n_valid
            or out.dtype != out_dtype or not out.is_contiguous()):
        raise ValueError(f"{who}: `out` must be a contiguous ({rows}, "
                         f"{n_valid}) {out_dtype} tensor on the codes' "
                         f"device")
    if rows * n_valid == 0:
        return out
    lib = _build.library()
    rc = lib.k3_dequantize_blocks(
        q2d.data_ptr(), scales.data_ptr(),
        old.data_ptr() if op != "copy" else None, out.data_ptr(),
        rows, n_valid, lp, code, _build.OP_CODES[op],
        _build.stream_handle(q2d))
    dequantize_blocks.launches += 1
    _build.check(rc, who)
    return out


def dequantize_blocks_at(q2d, scales, n_valid: int, old, old_index,
                         op: str = "add", out=None, out_dtype=None):
    """Launch K3 once over a whole exchange's wire (k*ranks rows, as
    `quantize_blocks_at` writes it): `op(old, q * s)` with `old` read in
    place through its region index, as a (k, ranks, n_valid) tensor of
    old's dtype — `out` when given (it must not overlap old), else a new
    one. op 'copy' reads no `old` (it may be None: the result is then
    `out_dtype`, default fp32). Raises on anything it cannot take."""
    who = "dequantize_blocks_at"
    if op not in _COMBINE_OPS:
        raise ValueError(f"{who}: unknown op {op!r}")
    rows, lp = _check_codes(who, q2d, scales, n_valid)
    check_index(who, "old", old_index, q2d.device)
    unit, ridx, uidx = old_index
    k, ranks, upk = uidx.shape
    if rows != k * ranks:
        raise ValueError(f"{who}: {rows} code rows for {k} segments x "
                         f"{ranks} ranks")
    region = (None, None, None, n_valid, n_valid, 1)  # identity: unread
    if old is None:
        if op != "copy":
            raise ValueError(f"{who}: op {op!r} needs `old`")
    else:
        if old.device != q2d.device or not old.is_contiguous():
            raise ValueError(f"{who}: `old` must be contiguous on the "
                             f"codes' device")
        row, ue = row_and_unit(who, "old", old, unit)
        if upk * ue != n_valid:
            raise ValueError(f"{who}: old's region holds {upk * ue} "
                             f"elements per segment, not {n_valid}")
        out_dtype = old.dtype
        if op != "copy":
            region = (old.data_ptr(), ridx.data_ptr(), uidx.data_ptr(), row,
                      ue, upk)
    out_dtype = out_dtype or torch.float32
    code = _dtype_code(out_dtype, who)
    shape = (k, ranks, n_valid)
    if out is None:
        out = torch.empty(shape, dtype=out_dtype, device=q2d.device)
    if (out.device != q2d.device or tuple(out.shape) != shape
            or out.dtype != out_dtype or not out.is_contiguous()):
        raise ValueError(f"{who}: `out` must be a contiguous {shape} "
                         f"{out_dtype} tensor on the codes' device")
    if old is not None and _overlaps(out, old):
        raise ValueError(f"{who}: `out` overlaps the buffer it combines "
                         f"into")
    if out.numel() == 0:
        return out
    lib = _build.library()
    rc = lib.k3_dequantize_blocks_at(
        q2d.data_ptr(), scales.data_ptr(), *region, k, ranks,
        out.data_ptr(), n_valid, lp, code, _build.OP_CODES[op],
        _build.stream_handle(q2d))
    dequantize_blocks.launches += 1
    _build.check(rc, who)
    return out


quantize_blocks.launches = 0
dequantize_blocks.launches = 0
