"""Public entry points of the port's kernels: the kernel on the card, its
plain PyTorch version on the CPU.

A CUDA tensor launches the hand-written kernel (fused_reduce.py,
quantize.py) or raises; a CPU tensor takes the plain version in ref.py.
The choice follows the tensor's device alone — there is no fallback and
no flag. Mirrors `repro/kernels/ops.py`, whose `_interpret` picks the
Pallas interpreter off a TPU.
"""
from __future__ import annotations

from repro_torch.kernels import fused_reduce as _fr
from repro_torch.kernels import quantize as _qz
from repro_torch.kernels import ref

KERNELS = {
    "fused_combine": _fr.fused_combine,
    "quantize_blocks": _qz.quantize_blocks,
    "dequantize_blocks": _qz.dequantize_blocks,
}


def _on_card(t) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def _into(out, res):
    return res if out is None else out.copy_(res)


def fused_combine(x, y, op: str = "add", out_dtype=None, out=None):
    """K1: `op(x.f32, y.f32).to(out_dtype)`, elementwise; written into
    `out` (which may alias x) when given."""
    if _on_card(x):
        return _fr.fused_combine(x.contiguous(), y.contiguous(), op=op,
                                 out_dtype=out_dtype, out=out)
    return _into(out, ref.fused_combine(x, y, op, out_dtype))


def quantize_int8(x2d):
    """K2 on a rank-stacked payload (rows, n): int8 codes (rows, Lp) and
    fp32 scales (rows, Lp/256), each row padded to 256 on its own."""
    if _on_card(x2d):
        return _qz.quantize_blocks(x2d.contiguous())
    return ref.quantize_blocks(x2d)


def dequantize_int8(q2d, scales, n_valid: int, old=None, op: str = "copy",
                    out_dtype=None, out=None):
    """K3: codes back to (rows, n_valid), optionally combined into `old`;
    written into `out` (which may alias old) when given."""
    if _on_card(q2d):
        return _qz.dequantize_blocks(
            q2d, scales, n_valid,
            old=None if old is None else old.contiguous(), op=op,
            out_dtype=out_dtype, out=out)
    return _into(out, ref.dequantize_blocks(q2d, scales, n_valid, old=old,
                                            op=op, out_dtype=out_dtype))


def launch_counts() -> dict:
    """Launches of each kernel since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
