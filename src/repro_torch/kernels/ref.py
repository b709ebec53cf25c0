"""Plain PyTorch versions of the port's CUDA kernels (K1-K5 and the SSD
scan).

The indexed entry points (`fused_combine_at`, `quantize_blocks_at`,
`dequantize_blocks_at`) gather their operands' regions and run the
contiguous version on the copies, so they are bitwise equal to it by
construction; an in-place `fused_combine_at` and the indexed copy
`region_copy` scatter the result back through the write index.

K5's `lookup_rows` is the reference DLRM lookup's sequence of ops (shift,
hit mask, clamp, gather, zeroed misses, concat layout), so it equals
`repro/models/dlrm.py::embedding_lookup`'s per-rank vector bitwise.

K1-K3 and K5 compute exactly what their kernels compute, bit for bit;
K4 (`matmul`) and the SSD scan (`ssd_chunked`, the Mamba2 prefill's
chunked scan, moved here from `models/ssm.py` unchanged) sum in another
order than their kernels, so the card holds K4 to it within a per-element
bound and the scan to twice its own error against float64
(`chip_smoke.py`, `tests/test_torch_cuda.py`). Either way
the CPU path of `ops` runs these, and `chip_smoke.py` holds every kernel
against them on the card. They mirror the reference package's oracles in
`repro/kernels/ref.py` and its jnp codec in `repro/core/plugins.py`,
including the two places where the reference's compiler changed the
arithmetic:

* the int8 scale is `amax * float32(1/127)` (XLA rewrites the division
  by the constant 127 into a multiply by its reciprocal);
* a dequantize feeding an fp32 add is ONE rounding, `fma(q, s, old)`
  (XLA contracts the multiply into the add).
"""
from __future__ import annotations

import torch

from repro_torch.kernels._index import (
    check_in_place, gather_regions, scatter_regions,
)

QUANT_BLOCK = 256   # elements per int8 scale block

_COMBINE = {
    "add": torch.add,
    "max": torch.maximum,
    "min": torch.minimum,
    "mul": torch.mul,
}


def fused_combine(x, y, op: str = "add", out_dtype=None):
    """K1: `op(x.f32, y.f32).to(out_dtype)` elementwise."""
    out_dtype = out_dtype or x.dtype
    return _COMBINE[op](x.float(), y.float()).to(out_dtype)


def fused_combine_at(a, a_index, b, b_index, op: str = "add",
                     out_dtype=None, in_place=False):
    """K1 over every segment of two regions: `fused_combine` of the two
    gathered (k, ranks, seg) operands; with `in_place` written back into
    a's region through a_index, returning `a`."""
    res = fused_combine(gather_regions(a, a_index),
                        gather_regions(b, b_index), op, out_dtype)
    if not in_place:
        return res
    check_in_place("fused_combine_at", a, out_dtype or a.dtype, None)
    scatter_regions(a, a_index, res)
    return a


def region_copy(src, src_index, dst, dst_index):
    """The indexed copy: dst's region `dst_index` = src's region
    `src_index`, gathered then written; returns `dst`."""
    scatter_regions(dst, dst_index, gather_regions(src, src_index))
    return dst


def padded_len(n_valid: int) -> int:
    """A rank row's length padded to whole scale blocks."""
    return -(-int(n_valid) // QUANT_BLOCK) * QUANT_BLOCK


def quantize_blocks(x2d):
    """K2: (rows, n_valid) fp -> (int8 (rows, Lp), fp32 scales (rows, Lp/256)).

    Every row (one rank's flat payload) is zero-padded to whole 256-element
    blocks on its own, so a block never straddles two rows. fp32 input:
    `scale = max(amax * f32(1/127), 1e-12)`, `q = rint(x / scale)`. bf16
    input follows the reference's bf16 arithmetic: the scale, its floor
    and the quotient `x / scale` are each rounded to bf16."""
    rows, n_valid = x2d.shape
    lp = padded_len(n_valid)
    x = x2d.float()
    if lp != n_valid:
        x = torch.nn.functional.pad(x, (0, lp - n_valid))
    blocks = x.reshape(rows, lp // QUANT_BLOCK, QUANT_BLOCK)
    inv127 = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=x.device)
    floor = torch.tensor(1e-12, dtype=torch.float32, device=x.device)
    scale = blocks.abs().amax(dim=2) * inv127
    if x2d.dtype == torch.bfloat16:
        # the reference computes a bf16 payload's codec in bf16: the scale
        # and the quotient each round to bf16 before the next step
        scale = scale.to(torch.bfloat16).float()
        floor = floor.to(torch.bfloat16).float()
    scale = torch.maximum(scale, floor)
    ratio = blocks / scale[..., None]
    if x2d.dtype == torch.bfloat16:
        ratio = ratio.to(torch.bfloat16).float()
    q = torch.round(ratio).clamp(-127, 127)
    return q.to(torch.int8).reshape(rows, lp), scale


def _fma_f32(a, b, c):
    """Single-rounding float32 `a * b + c` for a product that is exact in
    float64 (int8 code times fp32 scale).

    The sum is taken in float64 with its exact error term (TwoSum); the
    float64 sum rounds to the same float32 as the exact value except when
    it sits exactly on a float32 midpoint, where the error's sign decides.
    """
    p = a.double() * b.double()
    c64 = c.double()
    s = c64 + p
    bb = s - c64
    err = (c64 - (s - bb)) + (p - bb)
    r = s.float()
    d = s - r.double()
    toward = torch.where(d > 0, torch.full_like(r, float("inf")),
                         torch.full_like(r, float("-inf")))
    nb = torch.nextafter(r, toward)
    mid = (r.double() + nb.double()) * 0.5
    fix = (d != 0) & (s == mid) & (err != 0) & ((err > 0) == (d > 0))
    return torch.where(fix, nb, r)


def dequantize_blocks(q2d, scales, n_valid: int, old=None, op: str = "copy",
                      out_dtype=None):
    """K3: `q * s` per block, trimmed to `n_valid` per row, optionally
    combined into `old` at the consume site.

    op 'copy' is the plain dequantize. fp32 'add' rounds once (FMA); a
    bf16 buffer, or max/min/mul, rounds `q * s` to the buffer's dtype
    first and then combines, as the reference does."""
    out_dtype = old.dtype if old is not None else (out_dtype or torch.float32)
    rows, lp = q2d.shape
    qf = q2d.float().reshape(rows, lp // QUANT_BLOCK, QUANT_BLOCK)
    sf = scales[..., None].expand_as(qf)
    if op == "add" and out_dtype == torch.float32:
        return _fma_f32(qf.reshape(rows, lp)[:, :n_valid],
                        sf.reshape(rows, lp)[:, :n_valid],
                        old.reshape(rows, n_valid))
    v = (qf * sf).reshape(rows, lp)[:, :n_valid].to(out_dtype)
    if op == "copy":
        return v
    return fused_combine(old.reshape(rows, n_valid), v, op, out_dtype)


def quantize_blocks_at(src, index):
    """K2 over every segment of a region of `src`: `quantize_blocks` of
    the gathered segments stacked in j order, (k * ranks, seg) rows."""
    g = gather_regions(src, index)
    return quantize_blocks(g.reshape(-1, g.shape[2]))


def dequantize_blocks_at(q2d, scales, n_valid: int, old, old_index,
                         op: str = "add", out_dtype=None):
    """K3 over a whole exchange's wire: `dequantize_blocks` into the
    gathered segments of old's region (none for 'copy'), as a (k, ranks,
    n_valid) tensor of old's dtype (else `out_dtype`)."""
    k, ranks = old_index[2].shape[:2]
    g = None if op == "copy" else \
        gather_regions(old, old_index).reshape(k * ranks, n_valid)
    res = dequantize_blocks(q2d, scales, n_valid, old=g, op=op,
                            out_dtype=old.dtype if old is not None
                            else out_dtype)
    return res.reshape(k, ranks, n_valid)


def matmul(x, y, out_dtype=None):
    """K4: `x @ y` accumulated in fp32, then cast to `out_dtype` (default
    x.dtype); batched over matching leading dims."""
    out_dtype = out_dtype or x.dtype
    return torch.matmul(x.float(), y.float()).to(out_dtype)


def gather_rows(table, indices):
    """K5: `out[..., i, :] = table[..., indices[..., i], :]` — rows of a
    (V, D) table, or of each (V, D) table of a (G, V, D) stack with
    (G, B) indices."""
    if table.ndim == 2:
        return table[indices.long()]
    g = torch.arange(table.shape[0], device=table.device)[:, None]
    return table[g, indices.long()]


def lookup_rows(tables, ids, lo, gather=gather_rows):
    """K5 as the DLRM lookup: stacked tables (G, T, rows_l, D), global ids
    (G, B, T) int32, `lo` (G,), each stacked rank's first row -> (G, B,
    T*D), rank g's partial concat vector: `tables[g, t, id - lo[g]]` where
    `id - lo[g]` (int32 arithmetic) lies in [0, rows_l), else +0.0.
    `gather` runs the row gather (the kernel's plain version by default)."""
    G, T, rows_l, D = tables.shape
    B = ids.shape[1]
    local = ids.to(torch.int32).transpose(1, 2) - \
        lo.to(torch.int32)[:, None, None]                  # (G, T, B)
    hit = (local >= 0) & (local < rows_l)
    safe = local.clamp(0, rows_l - 1)
    rows = gather(tables.reshape(G * T, rows_l, D), safe.reshape(G * T, B))
    rows = torch.where(hit[..., None], rows.reshape(G, T, B, D), 0.0)
    return rows.movedim(1, 2).reshape(G, B, T * D)


def ssd_chunked(xh, dt, a_neg, b_in, c_in, chunk: int):
    """The SSD prefill scan (chunked, paper Alg. 1 of arXiv:2405.21060),
    `repro/models/ssm.py::_ssd_chunked` in PyTorch.

    xh: (N, S, H, P); dt: (N, S, H) (post-softplus); a_neg: (H,) or
    (N, H), negative; b_in, c_in: (N, S, n). Returns (y: (N, S, H, P) in
    xh's dtype, final state (N, H, n, P) fp32).
    """
    bsz, s, h, p = xh.shape
    n = b_in.shape[-1]
    l = min(chunk, s)
    if s % l:
        raise ValueError(f"chunk {l} does not tile {s} positions")
    nc = s // l

    xc = xh.reshape(bsz, nc, l, h, p).float()
    dtc = dt.reshape(bsz, nc, l, h).float()
    bc = b_in.reshape(bsz, nc, l, n).float()
    cc = c_in.reshape(bsz, nc, l, n).float()

    log_a = dtc * a_neg[..., None, None, :]               # (b,c,l,h) <= 0
    ll = torch.cumsum(log_a, dim=2)                       # within-chunk
    ll_last = ll[:, :, -1:]                               # (b,c,1,h)

    # intra-chunk quadratic form
    scores = torch.einsum("bcln,bcsn->bcls", cc, bc)      # (b,c,l,s)
    decay = ll[:, :, :, None, :] - ll[:, :, None, :, :]   # (b,c,l,s,h)
    mask = torch.ones((l, l), dtype=torch.bool, device=xh.device).tril()
    m = torch.where(mask[None, None, :, :, None], torch.exp(decay),
                    0.0) * scores[..., None]
    xdt = xc * dtc[..., None]                             # (b,c,l,h,p)
    y_intra = torch.einsum("bclsh,bcshp->bclhp", m, xdt)

    # chunk-end states and the inter-chunk recurrence
    decay_to_end = torch.exp(ll_last - ll)                # (b,c,l,h)
    s_chunk = torch.einsum("bcln,bclh,bclhp->bchnp",
                           bc, decay_to_end * dtc, xc)
    a_chunk = torch.exp(ll_last[:, :, 0])                 # (b,c,h)

    h_prev = torch.zeros((bsz, h, n, p), dtype=torch.float32,
                         device=xh.device)
    h_prevs = []
    for ci in range(nc):
        h_prevs.append(h_prev)
        h_prev = a_chunk[:, ci, :, None, None] * h_prev + s_chunk[:, ci]
    h_prevs = torch.stack(h_prevs, dim=1)                 # (b,c,h,n,p)

    y_inter = torch.einsum("bcln,bchnp->bclhp", cc, h_prevs) \
        * torch.exp(ll)[..., None]
    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    return y.to(xh.dtype), h_prev


def ssd_recurrence(xh, dt, a_neg, b_in, c_in):
    """The SSD scan's recurrence in float64, one position at a time:
    h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t^T, y_t = C_t . h_t ->
    (y (N, S, H, P), h_S (N, H, n, P)), both float64. The yardstick the
    card holds the scan's kernel and `ssd_chunked` to (their errors
    against it), not a plain version of either."""
    N, S, H, P = xh.shape
    x, dt, b, c = (t.double() for t in (xh, dt, b_in, c_in))
    a = a_neg.double().expand(N, H)
    h = torch.zeros((N, H, b.shape[-1], P), dtype=torch.float64,
                    device=xh.device)
    y = torch.empty((N, S, H, P), dtype=torch.float64, device=xh.device)
    for t in range(S):
        h = h * torch.exp(dt[:, t] * a)[..., None, None] + (
            dt[:, t, :, None, None] * b[:, t, None, :, None]
            * x[:, t, :, None, :])
        y[:, t] = torch.einsum("bn,bhnp->bhp", c[:, t], h)
    return y, h
