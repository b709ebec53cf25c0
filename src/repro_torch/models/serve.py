"""Serving: prefill + single-token decode over sharded caches.

Port of `repro/models/serve.py`, every family.

Decode cache layouts (per attention layer), as the reference's:
  seq-sharded   (B, len/tp, KV, hd) over 'model' — every rank computes all
                (padded) Q heads on its slice; partial softmax stats merge
                via engine flash-combine. Used when KV heads replicate
                (n_kv < tp) — the long-context path.
  head-sharded  (B, len, KV/tp, hd) when n_kv >= tp.
  SWA layers    rolling cache of length `window` (slot = pos % W), layout
                as above; slot->position recovered arithmetically for the
                mask, so RoPE is applied before caching and slot order
                never matters.
  cross (audio) the static encoder k/v `xk`/`xv` (B, S_enc, KV, hd),
                written by prefill, never sequence-sharded.

SSM layers carry (conv_state, ssm_state) — O(1) in the sequence; their
global layout is the reference's: `conv` the concatenation of the
per-rank channel blocks (each rank's x part, then the replicated bc
part) sharded over 'model', `state` (B, H, n, P) fp32 with H sharded.

Every tensor is mesh-stacked; a cache leaf is (*mesh, B_local, len_local,
KV_local, hd). Where the reference takes a per-rank offset
(`tp_rank()`) — the slot a sequence-sharded cache writes, its slots'
positions, the head slice — each stacked row gets its own offset from
`ParCtx.tp_rank`. `decode_step` writes the new token's k/v into the
caches IN PLACE and replaces the SSM carries in each layer's dict (the
reference returns new arrays and donates the old ones); it returns the
same cache dicts.

A config with `layer_types` holds both kinds in one cache list: each
layer's entry is its kind's (`blocks.layer_plan`), k/v for an attention
layer, conv and state for a Mamba layer, the latent pair for an MLA
layer, and prefill emits each name stacked over the layers that hold it
(`prefill_cache_names`). The latent cache (MLA, DeepSeek-V3) is `c_kv`
(B, len, kv_lora_rank) and `k_pe` (B, len, qk_rope_head_dim), the same
on every rank (every head reads it); decode writes a token's pair in
place and reads the cache in the absorbed form (`mla_decode`). Prefill
and decode can also return the head's logits (`return_logits`), each
rank's vocab slice, (*mesh, B, V / tp).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import telemetry
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (
    NEG_INF, decode_attention, kv_layout, kv_owner, latent_bytes,
    mla_latent, mla_query, mla_scale, padded_heads,
)
from repro_torch.models.blocks import (
    cache_names, ffn_block, has_attention, has_mla, has_ssm,
    layer_params_of, layer_plan, residual, stack_forward, window_per_layer,
)
from repro_torch.models.common import Builder, rms_norm, rope
from repro_torch.models.lm import (
    _input_stream, embed_tokens, head_logits, lm_head_sample, sp_slice,
)
from repro_torch.parallel.ops import ParCtx, local_matmul


def layer_cache_len(cfg: ArchConfig, layer: int, s_max: int) -> int:
    w = cfg.sliding_window
    if w and layer not in cfg.global_attn_layers:
        return min(w, s_max)
    return s_max


def attn_cache_params(b: Builder, cfg: ArchConfig, tp: int, b_local_axis,
                      length: int, decode_seq_shard: bool):
    """(global shape with a None batch dim, spec) of one attention layer's
    k (or v) cache."""
    hd = cfg.resolved_head_dim
    _kv_l, kv_sharded = kv_layout(cfg, tp)
    dp = b_local_axis
    if kv_sharded:
        spec = (dp, None, "model", None)
    elif decode_seq_shard and tp > 1 and length % tp == 0:
        spec = (dp, "model", None, None)
    else:
        spec = (dp, None, None, None)
    return (None, length, cfg.n_kv_heads, hd), spec


def make_cache(b: Builder, cfg: ArchConfig, tp: int, batch: int,
               s_max: int, pcfg, s_enc: int = 0, dp=("pod", "data")):
    """Full decode-cache tree (list per layer): stacked zero tensors
    (init mode) or their specs. Shapes are GLOBAL before the Builder
    shards them; dp=None replicates the batch dim."""
    caches = []
    for layer, spot in enumerate(layer_plan(cfg)):
        entry = {}
        if has_mla(spot.kind):
            if pcfg.kv_cache_dtype != "param":
                raise ValueError("the latent cache is held in the model's "
                                 "dtype")
            for name, width in (("c_kv", cfg.kv_lora_rank),
                                ("k_pe", cfg.qk_rope_head_dim)):
                entry[name] = b.param((batch, s_max, width), (dp, None, None),
                                      init="zeros")
        elif cfg.has_attention and has_attention(spot.kind):
            length = layer_cache_len(cfg, layer, s_max)
            shp, spec = attn_cache_params(b, cfg, tp, dp, length,
                                          pcfg.decode_seq_shard)
            shp = (batch,) + shp[1:]
            q8 = pcfg.kv_cache_dtype == "int8"
            kdt = torch.int8 if q8 else None
            entry["k"] = b.param(shp, spec, init="zeros", dtype=kdt)
            entry["v"] = b.param(shp, spec, init="zeros", dtype=kdt)
            if q8:
                # one symmetric scale per (slot, kv head) — the unary
                # compression plugin applied to cache storage
                sshp, sspec = shp[:3], spec[:3]
                entry["k_scale"] = b.param(sshp, sspec, init="zeros",
                                           dtype=torch.float32)
                entry["v_scale"] = b.param(sshp, sspec, init="zeros",
                                           dtype=torch.float32)
            if cfg.encoder_layers and s_enc:
                xshp, xspec = attn_cache_params(b, cfg, tp, dp, s_enc,
                                                False)
                xshp = (batch,) + xshp[1:]
                entry["xk"] = b.param(xshp, xspec, init="zeros")
                entry["xv"] = b.param(xshp, xspec, init="zeros")
        if has_ssm(spot.kind):
            nh_p = ssm_mod.padded_ssm_heads(cfg, tp)
            di_l = nh_p * cfg.ssm_head_dim // tp
            # conv channels are TP-local (x-part sharded, bc-part
            # replicated); globally the cache is the concat of the
            # per-rank local states, sharded back out on use.
            chan_global = tp * (di_l + 2 * cfg.ssm_state)
            m = "model" if tp > 1 else None
            entry["conv"] = b.param(
                (batch, cfg.ssm_conv - 1, chan_global), (dp, None, m),
                init="zeros")
            entry["state"] = b.param(
                (batch, nh_p, cfg.ssm_state, cfg.ssm_head_dim),
                (dp, m, None, None), init="zeros", dtype=torch.float32)
        caches.append(entry)
    return caches


def prefill_cache_names(cfg: ArchConfig) -> tuple:
    """The caches prefill emits, in order (each a layer-stacked leaf of
    its decode cache's name): every name of the layers' kinds, in the
    order they first appear."""
    names: dict = {}
    for spot in layer_plan(cfg):
        names.update(dict.fromkeys(cache_names(
            spot.kind, bool(cfg.encoder_layers))))
    return tuple(names)


def prefill_cache_rows(cfg: ArchConfig) -> list:
    """For each layer, {cache name: its row in prefill's stack of that
    name}."""
    seen: dict = {}
    out = []
    for spot in layer_plan(cfg):
        row = {}
        for name in cache_names(spot.kind, bool(cfg.encoder_layers)):
            row[name] = seen.get(name, 0)
            seen[name] = row[name] + 1
        out.append(row)
    return out


def prefill_cache_specs(cfg: ArchConfig, pcfg, tp: int, s: int,
                        dp=("pod", "data")):
    """Specs of the layer-stacked caches prefill emits (leading layer dim;
    uniform full-sequence layout across layers), in the order of
    `prefill_cache_names`."""
    _kv_l, kv_sharded = kv_layout(cfg, tp)
    m = "model" if tp > 1 else None
    if kv_sharded:
        kv = (None, dp, None, "model", None)
    elif pcfg.decode_seq_shard and tp > 1 and s % tp == 0:
        kv = (None, dp, "model", None, None)
    else:
        kv = (None, dp, None, None, None)
    xkv = (None, dp, None, "model" if kv_sharded else None, None)
    specs = {"k": kv, "v": kv, "conv": (None, dp, None, m),
             "state": (None, dp, m, None, None), "xk": xkv, "xv": xkv,
             "c_kv": (None, dp, None, None), "k_pe": (None, dp, None, None)}
    return tuple(specs[name] for name in prefill_cache_names(cfg))


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------

def _slot_and_positions(length_total: int, rolling: bool, pos: int,
                        local_len: int, rank, tp_sharded: bool):
    """Write slot + per-slot absolute positions for the mask.

    rolling caches hold the last `length_total` positions at slot
    p % length_total; slot i therefore holds position
    pos - ((pos - i) mod length_total) (negative = not yet written).
    `rank` is the stacked per-rank TP rank (`ParCtx.tp_rank(1)`); the
    positions are stacked (*mesh, local_len)."""
    slot = pos % length_total if rolling else pos
    idx = rank * (local_len if tp_sharded else 0) \
        + torch.arange(local_len, device=rank.device)
    if rolling:
        slot_pos = pos - torch.remainder(pos - idx, length_total)
    else:
        slot_pos = idx
    return slot, slot_pos


def quantize_kv(x):
    """int8 KV-cache quantizer: one symmetric scale per (slot, kv head)
    over the last dim: (codes int8, scales fp32). Round half to even,
    IEEE division, the clip before the cast — the reference's."""
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax(-1) / 127.0, 1e-8)
    qv = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return qv.to(torch.int8), s


def _write(buf, new, cl, ok, lead: int) -> None:
    """In place, each rank's `dynamic_update_slice_in_dim(buf, new, cl,
    1)` where `ok` (else unchanged): buf (*mesh, B, L, ...), new (*mesh,
    B, 1, ...) (its trailing dims may be smaller: they land at offset 0),
    cl / ok stacked per-rank scalars."""
    mesh = tuple(buf.shape[:lead])
    G = 1
    for n in mesh:
        G *= n
    bf = buf.view((G,) + tuple(buf.shape[lead:]))
    nw = new.reshape((G,) + tuple(new.shape[lead:]))[:, :, 0]
    g = torch.arange(G, device=buf.device)
    cl = cl.expand(mesh).reshape(G)
    ok = ok.expand(mesh).reshape(G)
    cur = bf[g, :, cl]                                   # (G, B, ...)
    upd = cur.clone()
    upd[(slice(None), slice(None))
        + tuple(slice(0, n) for n in nw.shape[2:])] = nw.to(buf.dtype)
    okv = ok.reshape((G,) + (1,) * (cur.ndim - 1))
    bf[g, :, cl] = torch.where(okv, upd, cur)


def attn_decode(lp, h, cache, cfg: ArchConfig, ctx: ParCtx, pos: int,
                window: int, s_max: int, cross: bool = False):
    """h: stacked (*mesh, B, 1, D) normed input. Returns (y (*mesh, B, 1,
    D), the cache dict with this token's k/v written in place). cross:
    attend over the static encoder cache `xk`/`xv` (no rope, no write,
    every slot visible)."""
    L = ctx.lead
    hd = cfg.resolved_head_dim
    tp = ctx.tp
    hp = padded_heads(cfg, tp)
    hl = hp // tp
    kv_l, kv_sharded = kv_layout(cfg, tp)
    lead = tuple(h.shape[:L])
    bsz = h.shape[L]
    params = lp["xattn"] if cross else lp["attn"]
    kname, vname = ("xk", "xv") if cross else ("k", "v")
    rank = ctx.tp_rank(1)                              # (*mesh, 1)
    positions = torch.tensor([pos], device=h.device)

    q = ctx.dense(h, params["wq"]).reshape(lead + (bsz, 1, hl, hd))
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
    if not cross and cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
    q = q[..., 0, :, :]                                # (B, hl, hd)

    k_cache, v_cache = cache[kname], cache[vname]
    local_len = k_cache.shape[L + 1]
    quant = (not cross) and k_cache.dtype == torch.int8
    if cross:
        # static cross-attention cache: its own length, never seq-sharded
        seq_sharded = False
        slot_pos = torch.arange(local_len, device=h.device)
        pos = 2 ** 30
    else:
        # mirror make_cache's layout decision exactly
        length_total = min(window, s_max) if (window and window < s_max) \
            else s_max
        seq_sharded = (not kv_sharded) and ctx.pcfg.decode_seq_shard \
            and tp > 1 and (length_total % tp == 0)
        if local_len != (length_total // tp if seq_sharded
                         else length_total):
            raise ValueError(f"cache of local length {local_len} does not "
                             f"fit {length_total} slots (seq-sharded: "
                             f"{seq_sharded})")
        k_new = ctx.dense(h, params["wk"]).reshape(lead + (bsz, 1, kv_l, hd))
        v_new = ctx.dense(h, params["wv"]).reshape(lead + (bsz, 1, kv_l, hd))
        if cfg.qk_norm:
            k_new = rms_norm(k_new, params["k_norm"], cfg.norm_eps)
        if cfg.use_rope:
            k_new = rope(k_new, positions, cfg.rope_theta)
        rolling = bool(window) and window < s_max   # cache len == window
        slot, slot_pos = _slot_and_positions(length_total, rolling, pos,
                                             local_len, rank, seq_sharded)
        local_slot = slot - rank[..., 0] * (local_len if seq_sharded else 0)
        ok = (local_slot >= 0) & (local_slot < local_len)
        cl = torch.clamp(local_slot, 0, local_len - 1)
        if quant:
            kq, ks = quantize_kv(k_new)
            vq, vs = quantize_kv(v_new)
            _write(k_cache, kq, cl, ok, L)
            _write(v_cache, vq, cl, ok, L)
            _write(cache["k_scale"], ks, cl, ok, L)
            _write(cache["v_scale"], vs, cl, ok, L)
        else:
            _write(k_cache, k_new, cl, ok, L)
            _write(v_cache, v_new, cl, ok, L)

    # flash-combine path needs all (padded) q heads on every rank
    if seq_sharded:
        qf = ctx.engine.allgather(q.transpose(-3, -2), ctx.tp_axis)
        qf = qf.reshape(lead + (hp, bsz, hd)).transpose(-3, -2)
        n_q = hp
    else:
        qf = q
        n_q = hl

    # GQA owner-gather (g=1 einsum)
    if kv_sharded:
        owner = torch.arange(n_q, device=h.device) \
            // (n_q // k_cache.shape[L + 2])
    else:
        owner = kv_owner(cfg, ctx, n_q, 0 if seq_sharded else rank * hl)
    k_sel = ctx.take(k_cache, owner, dim=2)
    v_sel = ctx.take(v_cache, owner, dim=2)
    if quant:
        # dequantize on read
        ks_sel = ctx.take(cache["k_scale"], owner, dim=2)
        vs_sel = ctx.take(cache["v_scale"], owner, dim=2)
        k_sel = (k_sel.float() * ks_sel[..., None]).to(h.dtype)
        v_sel = (v_sel.float() * vs_sel[..., None]).to(h.dtype)

    out = decode_attention(
        qf, k_sel, v_sel, slot_positions=slot_pos, cur_pos=pos,
        combine_axis=ctx.tp_axis if seq_sharded else None,
        engine=ctx.engine, scale=cfg.attention_multiplier or None)

    # mask padded heads, take local rows for the row-parallel o_proj
    if seq_sharded:
        head_idx = torch.arange(hp, device=h.device)
        out = out * (head_idx < cfg.n_heads)[:, None].to(out.dtype)
        out = ctx.tp_slice(out, hl, dim=1)
    else:
        head_idx = rank * hl + torch.arange(hl, device=h.device)
        out = out * (head_idx < cfg.n_heads)[..., None, :, None].to(
            out.dtype)
    out = out.reshape(lead + (bsz, 1, hl * hd))
    wo = ctx.gather_fsdp(params["wo"], dim=1)
    y = local_matmul(out, wo.to(out.dtype), L)
    if tp > 1:
        y = ctx.engine.allreduce(y, ctx.tp_axis)
    return y, cache


def mla_decode(lp, h, cache, cfg: ArchConfig, ctx: ParCtx, pos: int):
    """h: stacked (*mesh, B, 1, D) normed input. Writes this token's
    latent pair into the layer's cache in place (every rank alike) and
    attends over the cache in the absorbed form, each rank its own
    heads, in fp32: with W_kvb,i = [W_UK,i | W_UV,i],
    q_lat_i = q_nope_i W_UK,i^T (kv_lora_rank wide), s = scale (q_lat_i .
    c_kv + q_pe_i . k_pe) over the slots written, o_i = (softmax(s)
    c_kv) W_UV,i. Returns (y (*mesh, B, 1, D), the cache)."""
    L = ctx.lead
    params = lp["attn"]
    nope, v_d = cfg.qk_nope_head_dim, cfg.v_head_dim
    lead = tuple(h.shape[:L])
    bsz = h.shape[L]
    length = cache["c_kv"].shape[L + 1]
    if not 0 <= pos < length:
        raise ValueError(f"position {pos} outside a cache of {length}")
    positions = torch.tensor([pos], device=h.device)
    tr = telemetry.wall()
    with tr.span("mla.mixer", track="lm"):
        with tr.span("mla.q", track="lm"):
            q_nope, q_pe = mla_query(params, h, cfg, ctx, positions)
        with tr.span("mla.kv", track="lm"):
            c_new, pe_new = mla_latent(params, h, cfg, ctx, positions)
            cl = torch.tensor(pos, device=h.device)
            ok = torch.tensor(True, device=h.device)
            _write(cache["c_kv"], c_new, cl, ok, L)
            _write(cache["k_pe"], pe_new, cl, ok, L)
            if tr.enabled:
                tr.count("mla.cache_bytes", latent_bytes(c_new, pe_new))
        with tr.span("mla.core", track="lm"):
            w = ctx.gather_fsdp(params["wkv_b"]).float()
            w = w.reshape(tuple(w.shape[:-1]) + (-1, nope + v_d))
            q_lat = torch.einsum("...bhn,...rhn->...bhr",
                                 q_nope[..., 0, :, :].float(), w[..., :nope])
            c_kv = cache["c_kv"].float()
            s = torch.einsum("...bhr,...bsr->...bhs", q_lat, c_kv)
            s = s + torch.einsum("...bhe,...bse->...bhs",
                                 q_pe[..., 0, :, :].float(),
                                 cache["k_pe"].float())
            written = torch.arange(length, device=h.device) <= pos
            s = torch.where(written, s * mla_scale(cfg), NEG_INF)
            p = torch.softmax(s, dim=-1)
            o_lat = torch.einsum("...bhs,...bsr->...bhr", p, c_kv)
            out = torch.einsum("...bhr,...rhv->...bhv", o_lat,
                               w[..., nope:])
        with tr.span("mla.out", track="lm"):
            out = out.to(h.dtype).reshape(lead + (bsz, 1, -1))
            wo = ctx.gather_fsdp(params["wo"], dim=1)
            y = ctx.row_parallel_finish(local_matmul(out, wo.to(out.dtype),
                                                     L))
    return y, cache


def decode_step(params, caches, tokens, pos: int, cfg: ArchConfig,
                ctx: ParCtx, s_max: int, return_logits: bool = False):
    """One greedy decode step. tokens: stacked (*mesh, B, 1); pos: the
    position being written.

    Returns (next_tokens stacked (*mesh, B), caches updated in place),
    and the head's logits (*mesh, B, V / tp) with `return_logits`.
    """
    windows = window_per_layer(cfg, cfg.n_layers)
    tr = telemetry.wall()
    with tr.span("lm.decode", track="lm", pos=pos):
        x = embed_tokens(params, tokens, cfg, ctx)
        for i, spot in enumerate(layer_plan(cfg)):
            with tr.span("lm.layer", track="lm", layer=i,
                         kind=spot.group or spot.kind):
                x = _decode_layer(layer_params_of(params["layers"], spot),
                                  caches[i], x, spot.kind, windows[i], pos,
                                  cfg, ctx, s_max)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = head_logits(params, x[..., 0, :], cfg, ctx)
        nxt = lm_head_sample(params, x[..., 0, :], cfg, ctx, logits=logits)
    return (nxt, caches, logits) if return_logits else (nxt, caches)


def _decode_layer(lp, cache, x, kind: str, window: int, pos: int,
                  cfg: ArchConfig, ctx: ParCtx, s_max: int):
    """One layer of a decode step: x stacked (*mesh, B, 1, D); writes the
    layer's cache in place (the SSM carries replaced in its dict)."""
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    if kind in ("ssm", "ssm_moe"):
        y, (cache["conv"], cache["state"]) = ssm_mod.ssm_mixer(
            lp["ssm"], h, cfg, ctx, conv_state=cache["conv"],
            ssm_state=cache["state"], decode=True)
        if kind == "ssm":
            return x + y
    elif has_mla(kind):
        y, _ = mla_decode(lp, h, cache, cfg, ctx, pos)
    else:
        y, _ = attn_decode(lp, h, cache, cfg, ctx, pos, window, s_max)
        if kind == "hybrid":
            s_out, (cache["conv"], cache["state"]) = ssm_mod.ssm_mixer(
                lp["ssm"], h, cfg, ctx, conv_state=cache["conv"],
                ssm_state=cache["state"], decode=True)
            y = 0.5 * (rms_norm(y, lp["norm_attn_out"], cfg.norm_eps)
                       + rms_norm(s_out, lp["norm_ssm_out"], cfg.norm_eps))
    x = x + residual(cfg, y)
    if "xattn" in lp:
        hx = rms_norm(x, lp["norm_x"], cfg.norm_eps)
        y, _ = attn_decode(lp, hx, cache, cfg, ctx, pos, 0, s_max,
                           cross=True)
        x = x + y
    h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
    y, _ = ffn_block(lp, h2, cfg, ctx, decode=True)
    return x + residual(cfg, y)


# --------------------------------------------------------------------------
# Prefill
# --------------------------------------------------------------------------

def prefill(params, batch, cfg: ArchConfig, ctx: ParCtx,
            collect_cache: bool = True, return_logits: bool = False):
    """Forward over the prompt; emit next token + caches.

    Caches come back layer-stacked, (L, *mesh, ...), in uniform
    full-sequence layout (SWA layers included at full length);
    runtime/serve_session converts them to per-layer decode layouts on
    handoff. Under sequence parallelism the input stream is cut to each
    TP rank's slice of the sequence first, as `lm.forward` does (the
    reference's prefill does not, and raises there: ROADMAP Queue 3).
    With `return_logits`, the last position's logits come third.
    """
    with telemetry.wall().span("lm.prefill", track="lm"):
        x, enc_out = _input_stream(params, batch, cfg, ctx)
        positions = torch.arange(x.shape[ctx.lead + 1], device=x.device)
        x, _, caches = stack_forward(params["layers"], sp_slice(x, ctx), cfg,
                                     ctx, positions, causal=True,
                                     enc_out=enc_out,
                                     collect_cache=collect_cache)
        x = ctx.sp_allgather_seq(x)
        x = rms_norm(x[..., -1:, :], params["final_norm"], cfg.norm_eps)
        logits = head_logits(params, x[..., 0, :], cfg, ctx)
        nxt = lm_head_sample(params, x[..., 0, :], cfg, ctx, logits=logits)
    return (nxt, caches, logits) if return_logits else (nxt, caches)
