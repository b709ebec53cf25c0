"""Public entry points of the port's kernels: the kernel on the card, its
plain PyTorch version on the CPU.

A CUDA tensor launches the hand-written kernel (fused_reduce.py,
quantize.py, matmul.py, embedding_gather.py, ssd_scan.py) or raises; a
CPU tensor takes the plain version in ref.py. A storage-free 'meta'
tensor (the dry run, `launch/dryrun.py`) gets the kernel's result as the
kernel makes it: its output alone, by shape and dtype, with none of the
plain version's temporaries; K4 alone runs its plain version there, so
that its products are counted as aten products, and so does the SSD
scan (whose kernel has no backward: under autograd its backward
differentiates the plain version, run again). The choice follows the
tensor's device alone — there is no fallback and no flag. Mirrors `repro/kernels/ops.py`, whose `_interpret`
picks the Pallas interpreter off a TPU.

Each entry point below, while a wall-clock span is open
(`telemetry.LIVE`), charges its call and its ns — argument and index
checks, the launch or the plain version — to the recorder
(`WallTracer.entry`): one global read and a branch a call otherwise.
"""
from __future__ import annotations

import math
import time

import torch

from repro_torch.core import telemetry as _tel
from repro_torch.kernels import embedding_gather as _eg
from repro_torch.kernels import fused_reduce as _fr
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import quantize as _qz
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ssd

COMBINE_OPS = _fr.OPS     # the ops K1 computes

KERNELS = {
    "fused_combine": _fr.fused_combine,
    "quantize_blocks": _qz.quantize_blocks,
    "dequantize_blocks": _qz.dequantize_blocks,
    "matmul_tiled": _mm.matmul_tiled,
    "gather_rows": _eg.gather_rows,
    "region_copy": _fr.region_copy,
}


def _on_card(t) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def _into(out, res):
    return res if out is None else out.copy_(res)


def _meta(t) -> bool:
    return t.device.type == "meta"


def _meta_out(out, shape, dtype):
    """A kernel's result on 'meta': `out`, or a new output of its shape
    and dtype."""
    if out is not None:
        return out
    return torch.empty(shape, dtype=dtype, device="meta")


def _region_len(t, index) -> int:
    """Elements of one rank's segment of a region of `t` (`_index.py`)."""
    unit, _rows, units = index
    return int(unit) * units.shape[2] * math.prod(t.shape[2:])


def fused_combine(x, y, op: str = "add", out_dtype=None, out=None):
    """K1: `op(x.f32, y.f32).to(out_dtype)`, elementwise; written into
    `out` (which may alias x) when given."""
    live = _tel.LIVE
    if live is not None:
        t0 = time.perf_counter_ns()
    if _meta(x):
        res = _meta_out(out, x.shape, out_dtype or x.dtype)
    elif _on_card(x):
        res = _fr.fused_combine(x.contiguous(), y.contiguous(), op=op,
                                out_dtype=out_dtype, out=out)
    else:
        res = _into(out, ref.fused_combine(x, y, op, out_dtype))
    if live is not None:
        live.entry(t0)
    return res


def fused_add(x, y, out_dtype=None):
    """K1 with op 'add': `(x.f32 + y.f32).to(out_dtype)` (default
    x.dtype), any shape — the reference's streaming binary plugin
    `ops.fused_add`."""
    return fused_combine(x, y, "add", out_dtype)


def fused_combine_at(a, a_index, b, b_index, op: str = "add",
                     out_dtype=None, out=None, in_place=False):
    """K1 over a whole exchange, reading its operands in place: `op` of
    every segment of two regions of rank-stacked buffers
    (`core/engine.py::_region_index` triples), as a (k, ranks, seg)
    tensor; one launch on the card; written into `out` (which must not
    overlap a or b) when given, or with `in_place` back into a's region
    through a_index, returning `a`. While a span records, counts its k
    segments into `k1.segments`."""
    live = _tel.LIVE
    if live is not None:
        t0 = time.perf_counter_ns()
    if _meta(a):
        k, ranks = a_index[2].shape[:2]
        res = a if in_place else _meta_out(
            out, (k, ranks, _region_len(a, a_index)), out_dtype or a.dtype)
    elif _on_card(a):
        res = _fr.fused_combine_at(a, a_index, b, b_index, op=op,
                                   out_dtype=out_dtype, out=out,
                                   in_place=in_place)
    elif in_place:
        if out is not None:
            raise ValueError("fused_combine_at: an in-place write takes "
                             "no `out`")
        res = ref.fused_combine_at(a, a_index, b, b_index, op, out_dtype,
                                   in_place=True)
    else:
        res = _into(out, ref.fused_combine_at(a, a_index, b, b_index, op,
                                              out_dtype))
    if live is not None:
        live.count(_tel.K1_SEGMENTS, int(a_index[2].shape[0]))
        live.entry(t0)
    return res


def region_copy(src, src_index, dst, dst_index):
    """The data plane's copy exchange: every segment of the region
    `src_index` of the rank-stacked buffer `src` written into the region
    `dst_index` of `dst` (`core/engine.py::_region_index` triples; the
    regions must not overlap); one launch on the card. Returns `dst`."""
    live = _tel.LIVE
    if live is not None:
        t0 = time.perf_counter_ns()
    if _meta(src):
        res = dst
    elif _on_card(src):
        res = _fr.region_copy(src, src_index, dst, dst_index)
    else:
        res = ref.region_copy(src, src_index, dst, dst_index)
    if live is not None:
        live.entry(t0)
    return res


def quantize_int8(x2d):
    """K2 on a rank-stacked payload (rows, n): int8 codes (rows, Lp) and
    fp32 scales (rows, Lp/256), each row padded to 256 on its own."""
    live = _tel.LIVE
    if live is not None:
        t0 = time.perf_counter_ns()
    if _on_card(x2d):
        res = _qz.quantize_blocks(x2d.contiguous())
    else:
        res = ref.quantize_blocks(x2d)
    if live is not None:
        live.entry(t0)
    return res


def dequantize_int8(q2d, scales, n_valid: int, old=None, op: str = "copy",
                    out_dtype=None, out=None):
    """K3: codes back to (rows, n_valid), optionally combined into `old`;
    written into `out` (which may alias old) when given."""
    live = _tel.LIVE
    if live is not None:
        t0 = time.perf_counter_ns()
    if _on_card(q2d):
        res = _qz.dequantize_blocks(
            q2d, scales, n_valid,
            old=None if old is None else old.contiguous(), op=op,
            out_dtype=out_dtype, out=out)
    else:
        res = _into(out, ref.dequantize_blocks(q2d, scales, n_valid,
                                               old=old, op=op,
                                               out_dtype=out_dtype))
    if live is not None:
        live.entry(t0)
    return res


def quantize_int8_at(src, index):
    """K2 over a whole exchange, reading every segment of a region of the
    rank-stacked buffer `src` in place (a `core/engine.py::_region_index`
    triple): codes (k*ranks, Lp) and scales (k*ranks, Lp/256), row
    j*ranks + r for segment j of rank r."""
    live = _tel.LIVE
    if live is not None:
        t0 = time.perf_counter_ns()
    if _meta(src):
        k, ranks = index[2].shape[:2]
        lp = ref.padded_len(_region_len(src, index))
        res = (_meta_out(None, (k * ranks, lp), torch.int8),
               _meta_out(None, (k * ranks, lp // ref.QUANT_BLOCK),
                         torch.float32))
    elif _on_card(src):
        res = _qz.quantize_blocks_at(src, index)
    else:
        res = ref.quantize_blocks_at(src, index)
    if live is not None:
        live.entry(t0)
    return res


def dequantize_int8_at(q2d, scales, n_valid: int, old, old_index,
                       op: str = "add", out=None, out_dtype=None):
    """K3 over a whole exchange's wire, combined with `op` into the region
    `old_index` of the rank-stacked buffer `old`, read in place: a (k,
    ranks, n_valid) tensor, written into `out` (which must not overlap
    old) when given. 'copy' reads no `old`."""
    live = _tel.LIVE
    if live is not None:
        t0 = time.perf_counter_ns()
    if _meta(q2d):
        k, ranks = old_index[2].shape[:2]
        res = _meta_out(out, (k, ranks, n_valid),
                        old.dtype if old is not None else out_dtype)
    elif _on_card(q2d):
        res = _qz.dequantize_blocks_at(q2d, scales, n_valid, old, old_index,
                                       op=op, out=out, out_dtype=out_dtype)
    else:
        res = _into(out, ref.dequantize_blocks_at(q2d, scales, n_valid, old,
                                                  old_index, op, out_dtype))
    if live is not None:
        live.entry(t0)
    return res


def matmul(x, y, out_dtype=None):
    """K4: `x @ y` with an fp32 accumulator, cast to `out_dtype` (default
    x.dtype); (M, K) @ (K, N), or batched over matching leading dims."""
    live = _tel.LIVE
    if live is not None:
        t0 = time.perf_counter_ns()
    if not _on_card(x):
        res = ref.matmul(x, y, out_dtype)
    else:
        lead = tuple(x.shape[:-2])
        if tuple(y.shape[:-2]) != lead:
            raise ValueError(f"matmul: leading dims differ: "
                             f"{tuple(x.shape)} @ {tuple(y.shape)}")
        x3 = x.reshape((-1,) + tuple(x.shape[-2:])).contiguous()
        y3 = y.reshape((-1,) + tuple(y.shape[-2:])).contiguous()
        out = _mm.matmul_tiled(x3, y3, out_dtype=out_dtype)
        res = out.reshape(lead + tuple(out.shape[-2:]))
    if live is not None:
        live.entry(t0)
    return res


def embedding_gather(table, indices):
    """K5: rows `indices` of a (V, D) table -> (B, D), or of every table
    of a (G, V, D) stack with (G, B) indices -> (G, B, D). Indices are
    int32 and already clipped into [0, V)."""
    live = _tel.LIVE
    if live is not None:
        t0 = time.perf_counter_ns()
    if not _on_card(table):
        res = ref.gather_rows(table, indices)
    elif table.ndim == 2:
        res = _eg.gather_rows(table[None].contiguous(),
                              indices[None].contiguous())[0]
    else:
        res = _eg.gather_rows(table.contiguous(), indices.contiguous())
    if live is not None:
        live.entry(t0)
    return res


def embedding_lookup_rows(tables, ids, lo):
    """K5 as the DLRM lookup: stacked tables (G, T, rows_l, D), global ids
    (G, B, T) int32 (any strides), `lo` (G,) int64, each stacked rank's
    first row -> (G, B, T*D), each rank's partial concat vector (rows it
    does not hold are +0.0). One K5 launch on the card."""
    live = _tel.LIVE
    if live is not None:
        t0 = time.perf_counter_ns()
    if _meta(tables):
        G, T, _rows, D = tables.shape
        res = _meta_out(None, (G, ids.shape[1], T * D), tables.dtype)
    elif _on_card(tables):
        res = _eg.lookup_rows(tables, ids, lo)
    else:
        res = ref.lookup_rows(tables, ids, lo)
    if live is not None:
        live.entry(t0)
    return res


class _SSDScan(torch.autograd.Function):
    """The kernel's forward with the plain version's gradients: the
    backward runs `ref.ssd_chunked` again on the saved operands under
    autograd and differentiates it (the kernel has no backward)."""

    @staticmethod
    def forward(ctx, xh, dt, a_neg, b_in, c_in, chunk: int):
        ctx.save_for_backward(xh, dt, a_neg, b_in, c_in)
        ctx.chunk = chunk
        return _ssd.ssd_chunked(xh, dt, a_neg, b_in, c_in, chunk)

    @staticmethod
    def backward(ctx, dy, dfinal):
        args = ctx.saved_tensors
        need = ctx.needs_input_grad[:5]
        leaves = [t.detach().requires_grad_(r) for t, r in zip(args, need)]
        with torch.enable_grad():
            y, final = ref.ssd_chunked(*leaves, ctx.chunk)
        wrt = [t for t, r in zip(leaves, need) if r]
        grads = iter(torch.autograd.grad((y, final), wrt, (dy, dfinal),
                                         allow_unused=True))
        return tuple(next(grads) if r else None for r in need) + (None,)


def ssd_chunked(xh, dt, a_neg, b_in, c_in, chunk: int):
    """The SSD prefill scan: xh (N, S, H, P), dt (N, S, H), a_neg (H,) or
    (N, H), b_in and c_in (N, S, n) -> (y (N, S, H, P) in xh's dtype,
    final state (N, H, n, P) fp32), `ref.ssd_chunked`'s contract. The
    kernel on the card (where an operand requires grad, through
    `_SSDScan`, whose backward differentiates the plain version); the
    plain version on the CPU and on 'meta'. While a span records, counts
    the call into `ssd.kernel` or `ssd.plain`."""
    live = _tel.LIVE
    if live is not None:
        t0 = time.perf_counter_ns()
    args = (xh, dt, a_neg, b_in, c_in)
    kernel = _on_card(xh)
    if not kernel:
        res = ref.ssd_chunked(*args, chunk)
    elif torch.is_grad_enabled() and any(t.requires_grad for t in args):
        res = _SSDScan.apply(*args, chunk)
    else:
        res = _ssd.ssd_chunked(*args, chunk)
    if live is not None:
        live.count(_tel.SSD_KERNEL if kernel else _tel.SSD_PLAIN)
        live.entry(t0)
    return res


def launch_counts() -> dict:
    """Launches of each kernel since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def kernel_flops() -> int:
    """Products of the kernel launches no dispatch mode sees (a ctypes
    launch) since import: K4's 2 G M N K per launch and the SSD scan's
    plain-version count per call (`ssd_scan.flops`). The other kernels
    compute no products."""
    return _mm.matmul_tiled.flops + _ssd.ssd_chunked.flops


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
