"""Dense SwiGLU MLP and MoE layer with engine all-to-all dispatch.

Port of `repro/models/mlp.py`. MoE expert parallelism rides the TP axis.
When n_experts < ep ranks, each expert is split into f = ep/n_experts
*pseudo-experts* along d_ff — exact for SwiGLU because silu/mul act
elementwise per hidden unit and the w2 partial products sum linearly.

Dispatch is sort-based with a capacity limit (assignments beyond
capacity drop, Switch-style), then one engine all-to-all over the EP
axis each way. Routing and dispatch run batched over the stacked ranks:
each rank's router, sort and capacity slots are rows of one tensor, and
`ctx.engine.alltoall` takes the stacked dispatch buffer. The top-k keeps
`jax.lax.top_k`'s tie order explicitly (`top_k`).

A dropless config (`moe_dropless`, Granite-4.0-H) sizes the dispatch
buffer by the routing itself: the per-expert counts of every rank are
read once a layer (the one device-to-host read; on one rank per process
their maximum is agreed over the EP group through the engine), and an
expert's capacity is the largest count, so no assignment is ever
dropped; the dropped count is taken on the host from those counts. While
the wall-clock recorder records, the MoE's steps are spans (`moe.route`,
`moe.dispatch` with the alltoall out, `moe.experts`, `moe.combine` with
the alltoall back and the re-gather), a device-to-host read is a span of
its own (`moe.count_sync`, where the host waits for the device's queued
work), and its counters are `moe.assignments` (tokens x top-k routed),
`moe.slots` (dispatch rows sent, padding included) and `moe.dropped`; a
dropless dispatch also adds them to the engine's metrics
(`engine.metrics`), read with or without the recorder.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import telemetry
from repro_torch.models.common import Builder, silu
from repro_torch.parallel.ops import ParCtx, local_matmul


def mlp_params(b: Builder, cfg: ArchConfig, width: int = 0):
    """A SwiGLU of hidden `width` (default the dense MLP's, `d_ff`)."""
    d, f = cfg.d_model, width or cfg.d_ff
    return {
        "w1": b.param((d, f), ("data", "model")),
        "w3": b.param((d, f), ("data", "model")),
        "w2": b.param((f, d), ("model", "data")),
    }


def mlp_block(params, x, cfg: ArchConfig, ctx: ParCtx):
    """x: stacked (*mesh, B, S, D) -> the same, finished over TP."""
    # fused gate/up projection: one sequence gather / collective matmul
    w1 = ctx.gather_fsdp(params["w1"])
    w3 = ctx.gather_fsdp(params["w3"])
    w13 = torch.cat([w1, w3], dim=-1)
    h13 = ctx.col_parallel_matmul(x, w13, pregathered=True)
    f = w1.shape[-1]
    h = silu(h13[..., :f]) * h13[..., f:]
    w2 = ctx.gather_fsdp(params["w2"], dim=1)
    y = local_matmul(h, w2.to(h.dtype), ctx.lead)
    return ctx.row_parallel_finish(y)


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------

def moe_factor(cfg: ArchConfig, ep: int) -> int:
    """Pseudo-expert split factor f (Mixtral on 16 ranks: f=2)."""
    if cfg.n_experts >= ep:
        if cfg.n_experts % ep:
            raise ValueError(f"{cfg.n_experts} experts on {ep} ranks")
        return 1
    if ep % cfg.n_experts:
        raise ValueError(f"{cfg.n_experts} experts on {ep} ranks")
    return ep // cfg.n_experts


def moe_params(b: Builder, cfg: ArchConfig, ep: int):
    d, f_ff, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    fac = moe_factor(cfg, ep)
    e_eff, f_eff = e * fac, f_ff // fac
    # the reference's law scales an expert matrix by its first dim, the
    # expert count; `expert_init_fan_in` draws each by its fan-in, so that
    # activations stay of order one at many experts
    s_in, s_out = ((1.0 / math.sqrt(d), 1.0 / math.sqrt(f_ff))
                   if cfg.expert_init_fan_in else (None, None))
    return {
        "router": b.param((d, e), ("data", None)),
        "w1": b.param((e_eff, d, f_eff), ("model", "data", None),
                      scale=s_in),
        "w3": b.param((e_eff, d, f_eff), ("model", "data", None),
                      scale=s_in),
        "w2": b.param((e_eff, f_eff, d), ("model", None, "data"),
                      scale=s_out),
    }


def top_k(x, k: int):
    """`jax.lax.top_k` over the last dim: the k largest values and their
    indices, largest first, the LOWER index first among equal values
    (`torch.topk` promises no order among ties): a stable descending
    sort keeps the original order of equal values. jax also orders -0
    below +0, which this sort takes as equal: the router's softmax
    probabilities are never -0."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_indices(expert_ids, n_experts: int, capacity: int):
    """Sort-based capacity dispatch, batched over leading dims.

    expert_ids: (..., A) integer assignment slots. Returns
    slot_for_assignment (..., A) in [0, n_experts*capacity) or -1 if
    dropped: within each expert, assignments keep their order and the
    first `capacity` are kept.
    """
    a = expert_ids.shape[-1]
    order = torch.argsort(expert_ids, dim=-1, stable=True)
    sorted_e = torch.gather(expert_ids, -1, order)
    # position within each expert group = idx - (running max of
    # group-start idx)
    seg_start = torch.zeros_like(sorted_e, dtype=torch.bool)
    seg_start[..., 1:] = sorted_e[..., 1:] != sorted_e[..., :-1]
    idx = torch.arange(a, device=expert_ids.device).expand_as(sorted_e)
    start_idx = torch.where(seg_start, idx, 0)
    start_idx = torch.cummax(start_idx, dim=-1).values
    pos_in_group = idx - start_idx
    keep = pos_in_group < capacity
    slot_sorted = torch.where(keep, sorted_e * capacity + pos_in_group, -1)
    return torch.empty_like(slot_sorted).scatter_(-1, order, slot_sorted)


def count_capacity(top_pe, e_eff: int, ctx: ParCtx) -> tuple:
    """(the dropless capacity, the loads): each expert's assignments on
    each stacked rank, a list, and the most any expert gets on any rank of
    the EP group, brought to the host in one read."""
    lead = tuple(top_pe.shape[:ctx.lead])
    G = math.prod(lead)
    rows = (top_pe.reshape(G, -1) + e_eff * torch.arange(
        G, device=top_pe.device)[:, None]).reshape(-1)
    loads = torch.zeros(G * e_eff, dtype=torch.int64,
                        device=top_pe.device).scatter_add_(
        0, rows, torch.ones_like(rows))
    most = loads.max().reshape(1)
    if ctx.local and ctx.tp > 1:
        most = ctx.engine.allreduce(most.float(), ctx.tp_axis, op="max")
    with telemetry.wall().span("moe.count_sync", track="lm"):
        host = torch.cat([loads, most.reshape(-1).long()]).tolist()
    n = G * e_eff
    return max(1, max(host[n:])), host[:n]


def expert_ffn(recv, w1, w3, w2):
    """Each local expert's SwiGLU over its received rows: recv (*mesh,
    el, rows, d), w1 / w3 (*mesh, el, d, f), w2 (*mesh, el, f, d)."""
    h = silu(torch.matmul(recv, w1.to(recv.dtype)))
    h = h * torch.matmul(recv, w3.to(recv.dtype))
    return torch.matmul(h, w2.to(h.dtype))


def moe_block(params, x, cfg: ArchConfig, ctx: ParCtx,
              capacity_factor: float = 1.25, dropless: bool = False,
              by_count: bool = False):
    """x: stacked (*mesh, B, S, D) -> (the same, router probs (*mesh, T,
    E)). EP all-to-all over the TP axis. `dropless` (decode): 4x the
    expected load of headroom; `by_count`: the capacity of the largest
    count (`count_capacity`), so nothing drops.

    Tokens are sequence-sharded across the EP group before dispatch so
    each token is routed exactly once (no TP-redundant expert compute);
    outputs are re-gathered unless SP already keeps the stream sharded.
    Falls back to replicated dispatch when S doesn't divide (tiny decode
    steps): every rank then routes all of its tokens, as the reference's
    does.
    """
    L = ctx.lead
    ep = ctx.tp
    fac = moe_factor(cfg, ep)
    e, k = cfg.n_experts, cfg.experts_per_token
    e_eff = e * fac
    tr = telemetry.wall()
    with tr.span("moe.route", track="lm"):
        s_in = x.shape[L + 1]
        token_sharded = ctx.pcfg.sequence_parallel
        regather = False
        if not token_sharded and ep > 1 and s_in % ep == 0:
            x = ctx.tp_slice(x, s_in // ep, dim=1)
            token_sharded, regather = True, True
        lead = tuple(x.shape[:L])
        b, s, d = x.shape[L:]
        t = b * s
        xt = x.reshape(lead + (t, d))

        router = ctx.gather_fsdp(params["router"])
        logits = local_matmul(xt.float(), router.float(), L)
        probs = torch.softmax(logits, dim=-1)
        gate, top_e = top_k(probs, k)                   # (*mesh, t, k)
        gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
        if ctx.routes is not None:      # (the experts, token-sharded?)
            ctx.routes.append((top_e, regather))

        # pseudo-expert expansion: token -> f slots per routed expert
        top_pe = (top_e[..., None] * fac
                  + torch.arange(fac, device=x.device)
                  ).reshape(lead + (t, k * fac))
        gate_pe = torch.repeat_interleave(gate, fac, dim=-1)

        if by_count:
            capacity, loads = count_capacity(top_pe, e_eff, ctx)
        elif dropless:
            # serving: 4x-expected headroom, capped at the true-dropless
            # bound
            expected = -(-t * k * fac // e_eff)  # ceil
            capacity = min(t * k * fac, max(1, expected * 4))
        else:
            capacity = int(max(1, round(t * k * capacity_factor / e)))

    with tr.span("moe.dispatch", track="lm", capacity=capacity):
        # per-rank buffer (e_eff * capacity, d)
        slots = _dispatch_indices(top_pe.reshape(lead + (-1,)), e_eff,
                                  capacity)
        valid = slots >= 0
        G = math.prod(lead)
        ec = e_eff * capacity
        base = torch.arange(G, device=x.device).reshape(lead + (1,)) * ec
        rows = (base + torch.where(valid, slots, ec - 1)).reshape(-1)
        src = torch.repeat_interleave(xt, k * fac, dim=-2)
        src = torch.where(valid[..., None], src,
                          torch.zeros((), dtype=x.dtype, device=x.device))
        buf = x.new_zeros((G * ec, d)).index_add_(0, rows,
                                                  src.reshape(-1, d))
        buf = buf.reshape(lead + (ec, d))
        if by_count:    # each expert keeps its first `capacity` rows
            dropped = sum(max(0, n - capacity) for n in loads)
        elif tr.enabled:
            with tr.span("moe.count_sync", track="lm"):
                dropped = G * t * k * fac - int(valid.sum())
        if by_count or tr.enabled:
            _count(ctx, tr, by_count, G * t * k, G * ec, dropped)
        # EP all-to-all: (e_eff*cap, d) -> rows grouped by source rank
        recv = ctx.engine.alltoall(buf, ctx.tp_axis)   # (ep*el*cap, d)

    el = e_eff // ep
    with tr.span("moe.experts", track="lm"):
        recv = recv.reshape(lead + (ep, el, capacity, d)).transpose(L, L + 1)
        recv = recv.reshape(lead + (el, ep * capacity, d))
        w1 = ctx.gather_fsdp(params["w1"], 1)
        w3 = ctx.gather_fsdp(params["w3"], 1)
        w2 = ctx.gather_fsdp(params["w2"], 2)
        out = expert_ffn(recv, w1, w3, w2)

    with tr.span("moe.combine", track="lm"):
        # reverse all-to-all
        out = out.reshape(lead + (el, ep, capacity, d)).transpose(L, L + 1)
        back = ctx.engine.alltoall(out.reshape(lead + (ec, d)), ctx.tp_axis)

        # combine: gather each assignment's slot, weight, sum over k*fac
        safe = torch.where(valid, slots, 0)
        picked = ctx.take(back, safe, dim=0) * valid[..., None].to(
            back.dtype)
        picked = picked.reshape(lead + (t, k * fac, d))
        y = torch.einsum("...tkd,...tk->...td", picked.float(),
                         gate_pe.float())
        y = y.to(x.dtype).reshape(lead + (b, s, d))
        if regather:  # non-SP callers expect the full sequence back
            flat = ctx.engine.allgather(y.transpose(L, L + 1), ctx.tp_axis)
            y = flat.reshape(lead + (s_in, b, d)).transpose(L, L + 1)
    return y, probs


def _count(ctx: ParCtx, tr, engine_too: bool, assignments: int, slots: int,
           dropped: int) -> None:
    """The dispatch's counters: into the wall-clock recorder while it
    records, and into the engine's metrics for a dropless dispatch."""
    for name, n in (("moe.assignments", assignments), ("moe.slots", slots),
                    ("moe.dropped", dropped)):
        if tr.enabled:
            tr.count(name, n)
        if engine_too:
            ctx.engine.metrics.inc(name, n)
