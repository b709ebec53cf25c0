"""LM assembly: embeddings, the vocab-parallel loss and greedy head, the
forward.

Port of `repro/models/lm.py`, the audio family's encoder stack included.

Sharding summary (mesh pod x data x model), as the reference's:
  embedding/head (V, D): V over 'model' (vocab-parallel), D over 'data'
  activations: batch over ('pod','data'); optionally seq over 'model' (SP)
  caches (decode): KV-sequence over 'model' + engine flash-combine, or KV
  heads over 'model' when n_kv >= tp

Every tensor is mesh-stacked (`parallel/ops.py`); a rank's vocab shard
offset is its `tp_rank()` times the shard size, one per stacked row.

Loss-scaling contract (the reference's, `core/autograd.py`): the
backward differentiates the SUM of the per-rank losses; the head input
is always full-sequence and model-axis replicated, so each rank's loss
is ce_local_sum / (total_tokens * tp_size), stacked (*mesh,). MoE aux
stats are token-sharded, scaled by 1 / n_ranks_total.

A config's `embedding_multiplier` scales the token embeddings and its
`logits_scaling` divides the head's logits (Granite-4.0-H's muP scalars;
both 1 elsewhere, where they cost nothing).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.blocks import (
    layer_params, stack_forward, stack_params, stacked,
)
from repro_torch.models.common import Builder, rms_norm, sinusoidal_positions
from repro_torch.parallel.ops import ParCtx, local_matmul

# the greedy head carries token ids through the engine's fp32 max
# allreduce (K1 computes in fp32): exact for ids below 2^24
_MAX_EXACT_ID = 1 << 24


def padded_vocab(cfg: ArchConfig, tp: int) -> int:
    return ((cfg.vocab_size + tp - 1) // tp) * tp


# --------------------------------------------------------------------------
# Params
# --------------------------------------------------------------------------

def model_params(b: Builder, cfg: ArchConfig, tp: int):
    vp = padded_vocab(cfg, tp)
    d = cfg.d_model
    p = {
        "embed": b.param((vp, d), ("model", "data"), scale=0.02),
        "final_norm": b.param((d,), (None,), init="ones"),
        "layers": stack_params(b, cfg, tp, cross=bool(cfg.encoder_layers)),
    }
    if not cfg.tie_embeddings:
        p["head"] = b.param((vp, d), ("model", "data"), scale=0.02)
    if cfg.encoder_layers:
        p["enc_layers"] = stacked(
            b, cfg.encoder_layers,
            lambda bb: layer_params(bb, cfg, tp, family="dense"))
        p["enc_norm"] = b.param((d,), (None,), init="ones")
    return p


def batch_specs(cfg: ArchConfig, kind: str, dp=("pod", "data")):
    """Spec entries for the input batch dict. dp=None replicates the
    batch dim (global batch smaller than the DP group, e.g. B=1 decode)."""
    if kind not in ("train", "prefill"):
        raise ValueError(kind)
    spec = {"tokens": (dp, None)}
    if kind == "train":
        spec["labels"] = (dp, None)
    if cfg.family == "vlm":
        spec["vis_embed"] = (dp, None, None)
    if cfg.encoder_layers:
        spec["frames"] = (dp, None, None)
    return spec


# --------------------------------------------------------------------------
# Embedding + head (vocab-parallel)
# --------------------------------------------------------------------------

def _rank_rows(table, idx, lead: int):
    """Each rank's rows `idx` of its own table: table (*mesh, V, D), idx
    (*mesh, ...) -> (*mesh, ..., D)."""
    G = 1
    for n in table.shape[:lead]:
        G *= n
    flat = table.reshape((G,) + tuple(table.shape[lead:]))
    fi = idx.reshape(G, -1)
    rows = flat[torch.arange(G, device=idx.device)[:, None], fi]
    return rows.reshape(tuple(idx.shape) + (table.shape[-1],))


def embed_tokens(params, tokens, cfg: ArchConfig, ctx: ParCtx):
    """tokens: stacked (*mesh, B, S) global ids -> (*mesh, B, S, D).
    Vocab-parallel gather + allreduce."""
    vp = padded_vocab(cfg, ctx.tp)
    v_l = vp // ctx.tp
    emb = ctx.gather_fsdp(params["embed"], dim=1)     # (V_l, D)
    lo = ctx.tp_rank(tokens.ndim - ctx.lead) * v_l
    local = tokens - lo
    hit = (local >= 0) & (local < v_l)
    rows = _rank_rows(emb, torch.clamp(local, 0, v_l - 1), ctx.lead)
    rows = torch.where(hit[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                         device=rows.device))
    if ctx.tp > 1:
        rows = ctx.engine.allreduce(rows, ctx.tp_axis)
    if cfg.embedding_multiplier != 1.0:
        rows = rows * cfg.embedding_multiplier
    return rows


def _scaled(logits, cfg: ArchConfig):
    """Logits divided by the config's `logits_scaling` (as is at 1)."""
    s = cfg.logits_scaling
    return logits if s == 1.0 else logits / s


def lm_head_ce(params, x, labels, cfg: ArchConfig, ctx: ParCtx,
               mask=None):
    """Vocab-parallel cross-entropy. x: stacked (*mesh, B, S, D); labels:
    (*mesh, B, S) int.

    Returns (ce_sum, token_count), each stacked (*mesh,): sums over each
    rank's local batch tokens (the model-replicated partial; the caller
    applies the 1/(T_total*tp) scale). Padded vocab rows are masked to
    -1e30; the logsumexp stabiliser is gradient-free (detached) and goes
    through the engine's max allreduce."""
    L = ctx.lead
    vp = padded_vocab(cfg, ctx.tp)
    v_l = vp // ctx.tp
    w = params["embed"] if cfg.tie_embeddings else params["head"]
    w = ctx.gather_fsdp(w, dim=1)                     # (V_l, D)
    logits = _scaled(local_matmul(x.float(), w.float().transpose(-1, -2), L),
                     cfg)
    lo = ctx.tp_rank(2) * v_l                         # (*mesh, 1, 1)
    vocab_ok = (lo[..., None] + torch.arange(v_l, device=lo.device)
                ) < cfg.vocab_size
    logits = torch.where(vocab_ok, logits, -1e30)

    m = logits.detach().amax(-1)
    if ctx.tp > 1:
        m = ctx.engine.allreduce(m, ctx.tp_axis, op="max",
                                 algorithm="recursive_doubling"
                                 if ctx.tp & (ctx.tp - 1) == 0 else "ring")
    e = torch.exp(logits - m[..., None])
    denom = e.sum(-1)
    if ctx.tp > 1:
        denom = ctx.engine.allreduce(denom, ctx.tp_axis)
    lse = torch.log(denom) + m

    local_label = labels.long() - lo
    hit = (local_label >= 0) & (local_label < v_l)
    picked = torch.gather(logits, -1, torch.clamp(local_label, 0, v_l - 1)
                          [..., None])[..., 0]
    picked = torch.where(hit, picked, 0.0)
    if ctx.tp > 1:
        picked = ctx.engine.allreduce(picked, ctx.tp_axis)

    ce = lse - picked                                 # (*mesh, B, S)
    if mask is None:
        mask = labels >= 0
    ce = torch.where(mask, ce, 0.0)
    return ce.sum((-2, -1)), mask.sum((-2, -1))


def head_logits(params, x, cfg: ArchConfig, ctx: ParCtx):
    """Each rank's slice of the vocab-parallel head's fp32 logits. x:
    stacked (*mesh, B, D) -> (*mesh, B, V / tp); padded vocab rows read
    -1e30."""
    v_l = padded_vocab(cfg, ctx.tp) // ctx.tp
    w = params["embed"] if cfg.tie_embeddings else params["head"]
    w = ctx.gather_fsdp(w, dim=1)
    logits = _scaled(torch.matmul(x.float(), w.float().transpose(-1, -2)),
                     cfg)
    lo = ctx.tp_rank(1) * v_l                           # (*mesh, 1)
    vocab_ok = (lo + torch.arange(v_l, device=lo.device)) < cfg.vocab_size
    return torch.where(vocab_ok.unsqueeze(-2), logits, -1e30)


def lm_head_sample(params, x, cfg: ArchConfig, ctx: ParCtx,
                   logits=None):
    """Greedy next-token over the vocab-parallel head. x: stacked
    (*mesh, B, D) -> (*mesh, B) int32, the same on every TP rank. Ties go
    to the lowest id: each rank's first maximum, then the lowest id among
    the ranks within 1e-6 of the global maximum. `logits`: `head_logits`
    already computed for x."""
    vp = padded_vocab(cfg, ctx.tp)
    if vp > _MAX_EXACT_ID:
        raise ValueError(f"vocab {vp} exceeds the head's exact id range")
    v_l = vp // ctx.tp
    if logits is None:
        logits = head_logits(params, x, cfg, ctx)
    lo = ctx.tp_rank(1) * v_l                           # (*mesh, 1)
    val = logits.amax(-1)
    idx = lo + logits.argmax(-1)
    if ctx.tp > 1:
        best = ctx.engine.allreduce(val, ctx.tp_axis, op="max")
        cand = torch.where(val >= best - 1e-6, idx.float(), float(2 ** 30))
        idx = -ctx.engine.allreduce(-cand, ctx.tp_axis, op="max")  # min
    return idx.to(torch.int32)


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _input_stream(params, batch, cfg: ArchConfig, ctx: ParCtx):
    """Token embeddings with family-specific prefixes; returns (x, enc_out).
    The audio family's stub frames (*mesh, B, S_enc, D) run the encoder
    stack (sinusoidal positions, non-causal dense layers) into enc_out,
    full-sequence on every rank."""
    enc_out = None
    if cfg.encoder_layers:
        frames = batch["frames"]
        s_enc = frames.shape[ctx.lead + 1]
        pe = sinusoidal_positions(s_enc, cfg.d_model, device=frames.device)
        h = frames + pe.to(frames.dtype)
        # the encoder stream is sequence-sharded under SP exactly like the
        # decoder stream (blocks re-gather at their boundaries)
        h, _, _ = stack_forward(params["enc_layers"], sp_slice(h, ctx), cfg,
                                ctx, torch.arange(s_enc, device=h.device),
                                causal=False, family="encoder")
        h = ctx.sp_allgather_seq(h)   # cross-attention needs full seq
        enc_out = rms_norm(h, params["enc_norm"], cfg.norm_eps)
    x = embed_tokens(params, batch["tokens"], cfg, ctx)
    if cfg.family == "vlm" and "vis_embed" in batch:
        L = ctx.lead
        vis = batch["vis_embed"]
        nv = vis.shape[L + 1]
        x = torch.cat([vis.to(x.dtype), x[..., nv:, :]], dim=L + 1)
    return x, enc_out


def sp_slice(x, ctx: ParCtx):
    """Under sequence parallelism, each TP rank's slice of the sequence
    (local dim 1) of the input stream."""
    s = x.shape[ctx.lead + 1]
    if ctx.pcfg.sequence_parallel and ctx.tp > 1 and s % ctx.tp == 0:
        return ctx.tp_slice(x, s // ctx.tp, dim=1)
    return x


def forward(params, batch, cfg: ArchConfig, ctx: ParCtx):
    """Stacked (*mesh, B, S) tokens -> (*mesh, B, S, D) final hidden +
    moe aux."""
    x, enc_out = _input_stream(params, batch, cfg, ctx)
    positions = torch.arange(x.shape[ctx.lead + 1], device=x.device)
    x, aux, _ = stack_forward(params["layers"], sp_slice(x, ctx), cfg, ctx,
                              positions, causal=True, enc_out=enc_out)
    x = ctx.sp_allgather_seq(x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux


def loss_fn(params, batch, cfg: ArchConfig, ctx: ParCtx,
            aux_coef: float = 0.01):
    """Each rank's local loss, stacked (*mesh,), honouring the
    sum-of-losses contract, and the metrics: `ce_mean` reduced over the
    dp axes (the same on every rank) and the MoE `aux` term per rank."""
    x, aux = forward(params, batch, cfg, ctx)
    ce_sum, _ = lm_head_ce(params, x, batch["labels"], cfg, ctx)
    sizes = ctx.mesh_shape
    dp = sizes.get("pod", 1) * sizes.get("data", 1)
    tp = sizes.get(ctx.pcfg.tp_axis, 1)
    b_l, s = batch["labels"].shape[-2:]
    t_total = b_l * s * dp
    loss = ce_sum / (t_total * tp)
    if cfg.family == "moe":
        loss = loss + aux_coef * aux / (dp * tp)
    # metrics are globally reduced (a local batch mean would be
    # rank-dependent); they take no gradient
    ce_global = ce_sum.detach()
    for ax in ("pod", "data"):
        if sizes.get(ax, 1) > 1:
            ce_global = ctx.engine.allreduce(ce_global, ax)
    metrics = {"ce_mean": ce_global / t_total,
               "aux": aux.detach().expand(loss.shape)}
    return loss, metrics
