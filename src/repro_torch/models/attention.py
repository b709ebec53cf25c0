"""Attention: GQA with RoPE/qk-norm/SWA, flash-style blocked attention,
sequence-sharded decode with the engine flash-combine.

Port of `repro/models/attention.py`. The blocked algorithm is the
reference's, op for op, in torch: an outer
loop over q blocks, an inner loop over kv blocks carrying the running
(max, sum, acc) in fp32, so scores never exist beyond one
(q_block, kv_block) tile. Every product the reference writes with
`preferred_element_type=float32` upcasts its operands here, so scores
and `acc` are never rounded to the compute dtype before the softmax and
the combine; the probabilities are rounded to v's dtype before the
second product, as there. Its backward is the reference's custom VJP
(`_make_flash`) as a `torch.autograd.Function` (`_Flash`): it saves only
(q, k, v, out, lse), O(S) residuals, and recomputes each P tile in the
backward with the same mask, accumulating dq, dk, dv in fp32.

Activations are mesh-stacked (`parallel/ops.py`); the blocked attention
and the decode attention act on trailing dims only, so their leading
dims may be the mesh's. Decode over a sequence-sharded cache merges the
partial softmax statistics (m, l, acc) across the TP group with engine
allreduces — a distributed flash-combine.

A config may set the softmax scale (`attention_multiplier`; 0 keeps
1 / sqrt(head_dim)) and leave out the rotary embedding (`use_rope`
False: NoPE), in prefill and decode alike (`softmax_scale`).

Multi-head latent attention (MLA, DeepSeek-V3; a config with
`kv_lora_rank`), per token x and head i:

    q        = rmsnorm(x W_qa) W_qb          -> [q_nope_i, q_pe_i]
    c_kv     = rmsnorm((x W_kva)[:r])        the latent, r wide
    k_pe     = rope((x W_kva)[r:])           one rotated key, every head's
    [k_nope_i, v_i] = c_kv W_kvb,i
    o_i      = softmax_s(s ([q_nope_i, rope(q_pe_i)] . [k_nope_i, k_pe]))
               v_i,   s = m^2 / sqrt(nope + rope), m YaRN's mscale
    y        = [o_1 .. o_H] W_o

with the rotation YaRN's on interleaved pairs (`common.rope`). Prefill
(`mla_block`) computes it in this expanded per-head form through the
blocked core, v at its own width; heads split over TP, the latent
projections replicated. Each layer's cache is the latent pair (c_kv,
k_pe), the same on every rank; decode (`serve.mla_decode`) reads it in
the absorbed form. While the wall-clock recorder records, `mla.mixer`
holds `mla.q`, `mla.kv`, `mla.core` and `mla.out`, and `mla.cache_bytes`
counts the latent cache bytes written.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import telemetry
from repro_torch.models.common import Builder, rms_norm, rope, yarn_mscale
from repro_torch.parallel.ops import ParCtx, local_matmul

NEG_INF = -1e30


def padded_heads(cfg: ArchConfig, tp: int) -> int:
    """Q heads padded to a TP multiple (dead heads are masked out)."""
    h = cfg.n_heads
    return ((h + tp - 1) // tp) * tp


def kv_layout(cfg: ArchConfig, tp: int):
    """(kv_heads_local, sharded?) — replicate KV when tp > n_kv.

    KV sharding additionally requires unpadded Q heads, so that the local
    q-head block aligns with the local kv-head block (GQA grouping).
    """
    if (cfg.n_kv_heads >= tp and cfg.n_kv_heads % tp == 0
            and cfg.n_heads % tp == 0):
        return cfg.n_kv_heads // tp, True
    return cfg.n_kv_heads, False


def attn_params(b: Builder, cfg: ArchConfig, tp: int):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hp = padded_heads(cfg, tp)
    _, kv_sharded = kv_layout(cfg, tp)
    kv_spec = ("data", "model") if kv_sharded else ("data", None)
    p = {
        "wq": b.param((d, hp * hd), ("data", "model")),
        "wk": b.param((d, cfg.n_kv_heads * hd), kv_spec),
        "wv": b.param((d, cfg.n_kv_heads * hd), kv_spec),
        "wo": b.param((hp * hd, d), ("model", "data")),
    }
    if cfg.qk_norm:
        p["q_norm"] = b.param((hd,), (None,), init="ones")
        p["k_norm"] = b.param((hd,), (None,), init="ones")
    return p


# --------------------------------------------------------------------------
# Flash-style blocked attention (prefill)
# --------------------------------------------------------------------------

def softmax_scale(cfg: ArchConfig) -> Optional[float]:
    """The config's softmax scale, or None for 1 / sqrt(head_dim)."""
    return cfg.attention_multiplier or None


def _flash_fwd_blocks(q, k, v, window: int, *, causal: bool, qb: int,
                      kb: int, q_offset: int, scale: Optional[float] = None):
    """Returns (out, lse). Shapes as the reference's (already grouped):
    q: (b, nq, qb, kv, g, hd); k: (nk, b, kb, kv, hd); v: (nk, b, kb,
    kv, hd_v), v's own width (MLA's 128 beside q / k's 192); out
    (b, nq, kv, g, qb, hd_v), lse (b, nq, kv, g, qb)."""
    b, nq, qbs, kv, g, hd = q.shape
    nk = k.shape[0]
    hd_v = v.shape[-1]
    dev = q.device
    scale = scale or 1.0 / math.sqrt(hd)
    eff_w = window if window > 0 else 1 << 30     # 0 means unlimited
    outs, lses = [], []
    for qi in range(nq):
        qblk = q[:, qi].float()
        q_pos = q_offset + qi * qbs + torch.arange(qbs, device=dev)
        m = torch.full((b, kv, g, qbs), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, kv, g, qbs), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kv, g, qbs, hd_v), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            kblk, vblk = k[ki], v[ki]
            k_pos = ki * kb + torch.arange(kb, device=dev)
            s = torch.einsum("bqkgh,bskh->bkgqs", qblk, kblk.float()) * scale
            mask = k_pos[None, :] > q_pos[:, None] - eff_w
            if causal:
                mask &= k_pos[None, :] <= q_pos[:, None]
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bkgqs,bskh->bkgqh",
                              p.to(vblk.dtype).float(), vblk.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        lc = torch.clamp_min(l, 1e-30)
        outs.append((acc / lc[..., None]).to(q.dtype))
        lses.append(m + torch.log(lc))
    return torch.stack(outs, 1), torch.stack(lses, 1)


def _flash_bwd_blocks(q, k, v, out, lse, dout, window: int, *,
                      causal: bool, kb: int, scale: Optional[float] = None):
    """The reference's flash backward (`_make_flash.bwd`): for every
    (kv block, q block) pair, P recomputed from lse under the forward's
    mask, then dv += P^T dO, dS = P (dO V^T - delta) scale, dq += dS K,
    dk += dS^T Q, all in fp32. Shapes as `_flash_fwd_blocks`'s (dout
    like out, v and dv of v's own width); returns (dq, dk, dv) in fp32."""
    b, nq, qbs, kv, g, hd = q.shape
    nk = k.shape[0]
    dev = q.device
    scale = scale or 1.0 / math.sqrt(hd)
    eff_w = window if window > 0 else 1 << 30
    doutf = dout.float()
    delta = torch.sum(doutf * out.float(), dim=-1)     # (b,nq,kv,g,qb)
    dq = torch.zeros((b, nq, qbs, kv, g, hd), dtype=torch.float32,
                     device=dev)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=dev)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=dev)
    for ki in range(nk):
        kblk, vblk = k[ki].float(), v[ki].float()
        k_pos = ki * kb + torch.arange(kb, device=dev)
        for qi in range(nq):
            qblk = q[:, qi].float()
            q_pos = qi * qbs + torch.arange(qbs, device=dev)
            s = torch.einsum("bqkgh,bskh->bkgqs", qblk, kblk) * scale
            mask = k_pos[None, :] > q_pos[:, None] - eff_w
            if causal:
                mask &= k_pos[None, :] <= q_pos[:, None]
            s = torch.where(mask, s, NEG_INF)
            p = torch.exp(s - lse[:, qi][..., None])   # (b,kv,g,qb,kb)
            do = doutf[:, qi]                          # (b,kv,g,qb,hd)
            dv[ki] += torch.einsum("bkgqs,bkgqh->bskh", p, do)
            dp = torch.einsum("bkgqh,bskh->bkgqs", do, vblk)
            ds = p * (dp - delta[:, qi][..., None]) * scale
            dq[:, qi] += torch.einsum("bkgqs,bskh->bqkgh", ds, kblk)
            dk[ki] += torch.einsum("bkgqs,bqkgh->bskh", ds, qblk)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """Flash attention with the reference's custom VJP: the forward is
    `_flash_fwd_blocks`, the residuals (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, causal: bool, qb: int, kb: int,
                scale: Optional[float]):
        out, lse = _flash_fwd_blocks(q, k, v, window, causal=causal, qb=qb,
                                     kb=kb, q_offset=0, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.causal, ctx.kb, ctx.scale = window, causal, kb, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_blocks(q, k, v, out, lse, dout, ctx.window,
                                       causal=ctx.causal, kb=ctx.kb,
                                       scale=ctx.scale)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def _blocked(q, k, v, causal, window, q_block, kv_block, q_offset,
             scale=None):
    """q: (..., Sq, H, hd); k: (..., Skv, KV, hd); v: (..., Skv, KV,
    hd_v); the leading dims (batch and any mesh dims) fold into one batch
    dim. Returns (..., Sq, H, hd_v)."""
    lead = tuple(q.shape[:-3])
    sq, h, hd = q.shape[-3:]
    hd_v = v.shape[-1]
    skv, kv = k.shape[-3], k.shape[-2]
    b = math.prod(lead)
    g = h // kv
    qb = min(q_block, sq)
    kb = min(kv_block, skv)
    nq, nk = sq // qb, skv // kb
    if sq % qb or skv % kb:
        raise ValueError(f"blocks do not tile: {(sq, qb, skv, kb)}")
    qr = q.reshape(b, nq, qb, kv, g, hd)
    kr = k.reshape(b, nk, kb, kv, hd).movedim(1, 0)
    vr = v.reshape(b, nk, kb, kv, hd_v).movedim(1, 0)
    if q_offset == 0 and torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        out = _Flash.apply(qr, kr, vr, int(window), causal, qb, kb, scale)
    else:
        out, _lse = _flash_fwd_blocks(qr, kr, vr, int(window),
                                      causal=causal, qb=qb, kb=kb,
                                      q_offset=q_offset, scale=scale)
    out = out.permute(0, 1, 4, 2, 3, 5)   # (b,nq,kv,g,qb,hd)->(b,nq,qb,..)
    return out.reshape(lead + (sq, h, hd_v))


def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      q_block: int = 512, kv_block: int = 1024,
                      q_offset: int = 0, scale: Optional[float] = None):
    """q: (..., Sq, H, hd); k: (..., Skv, KV, hd); v: (..., Skv, KV,
    hd_v); H % KV == 0.

    Returns (..., Sq, H, hd_v). `window` > 0 masks keys older than `window`
    positions (0 = unlimited); `q_offset` is the absolute position of
    q[0] (for caches); `scale` the softmax scale (None: 1 / sqrt(hd))."""
    return _blocked(q, k, v, causal, window, q_block, kv_block, q_offset,
                    scale)


def flash_attention(q, k, v, *, causal: bool, window: int = 0,
                    q_block: int = 512, kv_block: int = 1024,
                    scale: Optional[float] = None):
    """Memory-efficient attention (the training and prefill path): the
    same contract as `chunked_attention` at offset 0, through the flash
    forward; with grad enabled, through `_Flash` (O(S) residuals)."""
    return _blocked(q, k, v, causal, window, q_block, kv_block, 0, scale)


# --------------------------------------------------------------------------
# Decode attention (single new token over a cache)
# --------------------------------------------------------------------------

def decode_attention(q, k_cache, v_cache, *, slot_positions, cur_pos,
                     combine_axis: Optional[str] = None, engine=None,
                     scale: Optional[float] = None):
    """q: (..., B, H, hd); caches: (..., B, Sc, KV, hd) (a local slice
    when combine_axis is set). slot_positions: (Sc,) or stacked (*mesh,
    Sc): the absolute position held by each cache slot (< 0 =
    unwritten); slots with position <= cur_pos attend.

    With combine_axis, partial (m, l, acc) merge across the TP group via
    engine allreduces — distributed flash-combine (the leading dims of q
    must then be the engine's mesh dims).
    """
    h, hd = q.shape[-2:]
    kv = k_cache.shape[-2]
    g = h // kv
    scale = scale or 1.0 / math.sqrt(hd)
    qr = q.reshape(tuple(q.shape[:-2]) + (kv, g, hd))
    mask = (slot_positions >= 0) & (slot_positions <= cur_pos)
    mask = mask[..., None, None, None, :]         # (..., 1, 1, 1, Sc)

    s = torch.einsum("...bkgh,...bskh->...bkgs", qr.float(),
                     k_cache.float()) * scale
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    acc = torch.einsum("...bkgs,...bskh->...bkgh",
                       p.to(v_cache.dtype).float(), v_cache.float())

    if combine_axis is not None and engine is not None \
            and engine.mesh_shape[combine_axis] > 1:
        m_g = engine.allreduce(m, combine_axis, op="max")
        w = torch.exp(m - m_g)
        l = engine.allreduce(l * w, combine_axis)
        acc = engine.allreduce(acc * w[..., None], combine_axis)

    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(q.shape).to(q.dtype)


# --------------------------------------------------------------------------
# Full attention layer (projections + cache plumbing)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class AttnConfig:
    causal: bool = True
    cross: bool = False       # cross-attention (kv from encoder output)


def head_mask(cfg: ArchConfig, ctx: ParCtx, local_heads: int, local: bool):
    """Mask padded Q heads: global head index >= n_heads contributes 0.
    Local: stacked (*mesh, local_heads), each rank's own heads."""
    hp = padded_heads(cfg, ctx.tp)
    if hp == cfg.n_heads:
        return None
    dev = ctx.engine.device
    if local:
        idx = ctx.tp_rank(1) * local_heads + torch.arange(local_heads,
                                                          device=dev)
    else:
        idx = torch.arange(hp, device=dev)
    return idx < cfg.n_heads


def kv_owner(cfg: ArchConfig, ctx: ParCtx, n_q: int, base):
    """The kv head each of `n_q` q heads reads when KV heads replicate:
    clip((base + j) // group, 0, n_kv - 1); `base` an int or a stacked
    per-rank offset."""
    group = max(cfg.n_heads // cfg.n_kv_heads, 1)
    j = torch.arange(n_q, device=ctx.engine.device)
    return torch.clamp((base + j) // group, 0, cfg.n_kv_heads - 1)


def attention_block(params, x, cfg: ArchConfig, ctx: ParCtx,
                    acfg: AttnConfig, positions, kv_source=None,
                    window: int = 0, q_block: int = 512,
                    kv_block: int = 1024, return_kv: bool = False):
    """Prefill attention over local Q heads.

    x: stacked (*mesh, B, S, D) (seq-sharded under SP); kv_source
    (*mesh, B, S_kv, D) overrides the kv input (cross-attention: no rope
    on either side). Returns the stacked (*mesh, B, S, D) output,
    finished via row_parallel_finish (and, with return_kv, the (k, v)
    cache this layer emits)."""
    L = ctx.lead
    hd = cfg.resolved_head_dim
    hp = padded_heads(cfg, ctx.tp)
    hl = hp // ctx.tp
    kv_l, kv_sharded = kv_layout(cfg, ctx.tp)

    if kv_source is None:
        # fused QKV projection: ONE sequence gather / collective matmul
        # feeds all three heads
        w_q = ctx.gather_fsdp(params["wq"])
        w_k = ctx.gather_fsdp(params["wk"])
        w_v = ctx.gather_fsdp(params["wv"])
        w_qkv = torch.cat([w_q, w_k, w_v], dim=-1)
        qkv = ctx.col_parallel_matmul(x, w_qkv, pregathered=True)
        d_q, d_k = w_q.shape[-1], w_k.shape[-1]
        q = qkv[..., :d_q]
        k = qkv[..., d_q:d_q + d_k]
        v = qkv[..., d_q + d_k:]
    else:
        q = ctx.col_parallel_matmul(x, params["wq"])
        k = ctx.dense(kv_source, params["wk"])
        v = ctx.dense(kv_source, params["wv"])
    lead = tuple(q.shape[:L])
    b, s = q.shape[L], q.shape[L + 1]
    skv = k.shape[L + 1]
    q = q.reshape(lead + (b, s, hl, hd))
    k = k.reshape(lead + (b, skv, kv_l, hd))
    v = v.reshape(lead + (b, skv, kv_l, hd))

    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    if not acfg.cross and cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    # the decode cache holds this layer's own kv heads (before any owner
    # gather), the layout decode writes and reads
    kc, vc = k, v
    # GQA group alignment: when KV heads replicate, every rank has all kv
    # heads and its local q heads belong to global groups: repeat kv to
    # the local q heads (each rank its own owners)
    if not kv_sharded:
        owner = kv_owner(cfg, ctx, hl, ctx.tp_rank(1) * hl)
        k = ctx.take(k, owner, dim=2)               # (B, S, hl, hd)
        v = ctx.take(v, owner, dim=2)

    out = flash_attention(q, k, v, causal=acfg.causal, window=window,
                          q_block=q_block, kv_block=kv_block,
                          scale=softmax_scale(cfg))
    hm = head_mask(cfg, ctx, hl, local=True)
    if hm is not None:
        out = out * hm[..., None, None, :, None].to(out.dtype)
    out = out.reshape(lead + (b, s, hl * hd))
    wo = ctx.gather_fsdp(params["wo"], dim=1)
    y = ctx.row_parallel_finish(local_matmul(out, wo.to(out.dtype), L))
    if not return_kv:
        return y
    # prefill cache emission, decode layout: seq-shard the cache over the
    # TP axis when KV heads replicate (the flash-combine decode path),
    # else keep the full sequence with local KV heads. A replicated-KV
    # cache holds the n_kv heads themselves, as decode's does; the
    # reference's holds each rank's owner-gathered heads, which decode
    # then misreads (ROADMAP Queue 3). The static cross cache stays whole:
    # decode reads it full-length (the reference seq-shards it too, Queue
    # 3).
    if (not kv_sharded) and kv_source is None \
            and ctx.pcfg.decode_seq_shard and ctx.tp > 1 \
            and skv % ctx.tp == 0:
        sl = skv // ctx.tp
        kc, vc = ctx.tp_slice(kc, sl, dim=1), ctx.tp_slice(vc, sl, dim=1)
    return y, (kc, vc)


# --------------------------------------------------------------------------
# Multi-head latent attention (MLA)
# --------------------------------------------------------------------------

def mla_heads(cfg: ArchConfig, tp: int) -> int:
    """Each rank's heads: MLA splits its heads evenly over TP."""
    if cfg.n_heads % tp:
        raise ValueError(f"{cfg.n_heads} MLA heads on {tp} ranks")
    return cfg.n_heads // tp


def mla_params(b: Builder, cfg: ArchConfig, tp: int):
    """Every matrix as x @ w: the latent projections (`wq_a`, `wkv_a`) and
    their norms replicated, the per-head up-projections (`wq_b`, `wkv_b`,
    each head's columns [nope | rope] and [k_nope | v]) column-parallel
    over heads, `wo` row-parallel."""
    mla_heads(cfg, tp)
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    return {
        "wq_a": b.param((d, cfg.q_lora_rank), ("data", None)),
        "q_a_norm": b.param((cfg.q_lora_rank,), (None,), init="ones"),
        "wq_b": b.param((cfg.q_lora_rank, h * qk), ("data", "model")),
        "wkv_a": b.param((d, r + cfg.qk_rope_head_dim), ("data", None)),
        "kv_a_norm": b.param((r,), (None,), init="ones"),
        "wkv_b": b.param((r, h * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
                         ("data", "model")),
        "wo": b.param((h * cfg.v_head_dim, d), ("model", "data")),
    }


def mla_scale(cfg: ArchConfig) -> float:
    """The softmax scale m^2 / sqrt(nope + rope), m the YaRN mscale of
    `mscale_all_dim` (1 without YaRN)."""
    m = yarn_mscale(cfg.yarn[0], cfg.yarn[5]) if cfg.yarn else 1.0
    return m * m / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def mla_rope(x, positions, cfg: ArchConfig):
    """MLA's rotation: YaRN's frequencies (`cfg.yarn`) on interleaved
    pairs, as the published MLA code rotates."""
    return rope(x, positions, cfg.rope_theta, cfg.yarn, interleave=True)


def mla_query(params, x, cfg: ArchConfig, ctx: ParCtx, positions):
    """Each rank's heads' queries of x stacked (*mesh, B, S, D): (q_nope
    (*mesh, B, S, hl, nope), q_pe (..., hl, rope) rotated)."""
    nope = cfg.qk_nope_head_dim
    q_a = ctx.col_parallel_matmul(x, params["wq_a"])
    q_a = rms_norm(q_a, params["q_a_norm"], cfg.norm_eps)
    q = local_matmul(q_a, ctx.gather_fsdp(params["wq_b"]).to(q_a.dtype),
                     ctx.lead)
    q = q.reshape(tuple(q.shape[:-1])
                  + (-1, nope + cfg.qk_rope_head_dim))
    return q[..., :nope], mla_rope(q[..., nope:], positions, cfg)


def mla_latent(params, x, cfg: ArchConfig, ctx: ParCtx, positions):
    """The latent pair of x stacked (*mesh, B, S, D), the same on every
    rank: (c_kv (*mesh, B, S, r) normed, k_pe (*mesh, B, S, rope)
    rotated)."""
    r = cfg.kv_lora_rank
    kv = ctx.col_parallel_matmul(x, params["wkv_a"])
    c_kv = rms_norm(kv[..., :r], params["kv_a_norm"], cfg.norm_eps)
    k_pe = mla_rope(kv[..., None, r:], positions, cfg)[..., 0, :]
    return c_kv, k_pe


def latent_bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def mla_block(params, x, cfg: ArchConfig, ctx: ParCtx, positions,
              q_block: int = 512, kv_block: int = 1024,
              return_kv: bool = False):
    """Prefill MLA over each rank's heads in the expanded form. x: stacked
    (*mesh, B, S, D). Returns the stacked (*mesh, B, S, D) output,
    finished via row_parallel_finish (and, with return_kv, the latent
    cache (c_kv, k_pe) this layer emits, (*mesh, B, S, r) and (*mesh,
    B, S, rope))."""
    L = ctx.lead
    nope, v_d = cfg.qk_nope_head_dim, cfg.v_head_dim
    tr = telemetry.wall()
    with tr.span("mla.mixer", track="lm"):
        with tr.span("mla.q", track="lm"):
            q_nope, q_pe = mla_query(params, x, cfg, ctx, positions)
            q = torch.cat([q_nope, q_pe], dim=-1)
            del q_nope, q_pe
        with tr.span("mla.kv", track="lm"):
            c_kv, k_pe = mla_latent(params, x, cfg, ctx, positions)
            wkv_b = ctx.gather_fsdp(params["wkv_b"]).to(c_kv.dtype)
            kv = local_matmul(c_kv, wkv_b, L)
            kv = kv.reshape(tuple(kv.shape[:-1]) + (-1, nope + v_d))
            hl = kv.shape[-2]
            k = torch.cat([kv[..., :nope], k_pe[..., None, :].expand(
                tuple(k_pe.shape[:-1]) + (hl, k_pe.shape[-1]))], dim=-1)
            v = kv[..., nope:]
            del kv
        with tr.span("mla.core", track="lm"):
            out = flash_attention(q, k, v, causal=True, q_block=q_block,
                                  kv_block=kv_block, scale=mla_scale(cfg))
            del q, k, v
        with tr.span("mla.out", track="lm"):
            out = out.reshape(tuple(out.shape[:-2]) + (hl * v_d,))
            wo = ctx.gather_fsdp(params["wo"], dim=1)
            y = ctx.row_parallel_finish(local_matmul(out, wo.to(out.dtype),
                                                     L))
        if return_kv and tr.enabled:
            tr.count("mla.cache_bytes", latent_bytes(c_kv, k_pe))
    return (y, (c_kv, k_pe)) if return_kv else y
