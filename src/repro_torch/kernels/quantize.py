"""K2/K3 wrappers: the int8 wire codec as CUDA kernels on Hopper.

K2 `quantize_blocks` replaces `repro/kernels/quantize.py::quantize_blocks`
and K3 `dequantize_blocks` replaces
`repro/kernels/quantize.py::dequantize_blocks` (Pallas, bodies
`_quant_kernel` / `_dequant_kernel`). Both kernels (csrc/quantize.cu) are
memory-bound on the H100. They work on the rank-stacked payload of one
exchange: (rows, n_valid) with every row (one rank) padded to whole
256-element blocks on its own — the reference engine's jnp wire format,
not the 32768-element padding of its Pallas wrapper. K3 can fuse the
combine of the consume site, and for an fp32 add it rounds once, as the
reference does. Plain versions: `ref.quantize_blocks`,
`ref.dequantize_blocks`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import QUANT_BLOCK, padded_len

_COMBINE_OPS = ("copy", "add", "max", "min", "mul")


def _dtype_code(dtype, who: str) -> int:
    name = str(dtype).replace("torch.", "")
    if name not in _build.DTYPE_CODES:
        raise TypeError(f"{who}: unsupported dtype {dtype}")
    return _build.DTYPE_CODES[name]


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
    lib = _build.library()
    rc = lib.k2_quantize_blocks(x2d.data_ptr(), q.data_ptr(), s.data_ptr(),
                                rows, n_valid, lp, code,
                                _build.stream_handle(x2d))
    quantize_blocks.launches += 1
    _build.check(rc, "quantize_blocks")
    return q, s


def dequantize_blocks(q2d, scales, n_valid: int, old=None, op: str = "copy",
                      out_dtype=None, out=None):
    """Launch K3: `q * s` trimmed to (rows, n_valid), combined into `old`
    (rows, n_valid) with `op` unless op == 'copy'. The result has old's
    dtype (else `out_dtype`, default fp32) and lands in `out` when given
    (it may alias old), else in a new tensor."""
    if op not in _COMBINE_OPS:
        raise ValueError(f"dequantize_blocks: unknown op {op!r}")
    if q2d.device.type != "cuda" or scales.device != q2d.device:
        raise ValueError("dequantize_blocks: needs CUDA tensors on one device")
    if q2d.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError("dequantize_blocks: needs int8 codes, fp32 scales")
    if q2d.ndim != 2 or q2d.shape[1] % QUANT_BLOCK:
        raise ValueError(f"dequantize_blocks: codes must be (rows, k*256), "
                         f"got {tuple(q2d.shape)}")
    rows, lp = q2d.shape
    if tuple(scales.shape) != (rows, lp // QUANT_BLOCK):
        raise ValueError(f"dequantize_blocks: scales {tuple(scales.shape)} "
                         f"do not match codes {tuple(q2d.shape)}")
    if not 0 <= n_valid <= lp or padded_len(n_valid) != lp:
        raise ValueError(f"dequantize_blocks: n_valid {n_valid} does not "
                         f"pad to {lp}")
    if not (q2d.is_contiguous() and scales.is_contiguous()):
        raise ValueError("dequantize_blocks: operands must be contiguous")
    if op != "copy":
        if old is None:
            raise ValueError(f"dequantize_blocks: op {op!r} needs `old`")
        if (old.device != q2d.device or old.numel() != rows * n_valid
                or not old.is_contiguous()):
            raise ValueError("dequantize_blocks: `old` must be a contiguous "
                             "(rows, n_valid) tensor on the codes' device")
        out_dtype = old.dtype
    out_dtype = out_dtype or torch.float32
    code = _dtype_code(out_dtype, "dequantize_blocks")
    if out is None:
        out = torch.empty((rows, n_valid), dtype=out_dtype,
                          device=q2d.device)
    if (out.device != q2d.device or out.numel() != rows * n_valid
            or out.dtype != out_dtype or not out.is_contiguous()):
        raise ValueError(f"dequantize_blocks: `out` must be a contiguous "
                         f"({rows}, {n_valid}) {out_dtype} tensor on the "
                         f"codes' device")
    if rows * n_valid == 0:
        return out
    lib = _build.library()
    rc = lib.k3_dequantize_blocks(
        q2d.data_ptr(), scales.data_ptr(),
        old.data_ptr() if op != "copy" else None, out.data_ptr(),
        rows, n_valid, lp, code, _build.OP_CODES[op],
        _build.stream_handle(q2d))
    dequantize_blocks.launches += 1
    _build.check(rc, "dequantize_blocks")
    return out


quantize_blocks.launches = 0
dequantize_blocks.launches = 0
