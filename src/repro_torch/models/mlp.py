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

DeepSeek-V3's router (`router_scoring` "sigmoid", `noaux_tc`): s =
sigmoid(x W_r) in fp32; the selection reads s + b (the param
`router_bias`, the correction bias): each of `router_groups` groups
scores the sum of its two best, the `router_topk_groups` best groups
are kept and the top-k of s + b among their experts taken
(`group_top_k`); the gates are s at the chosen experts, normalised to
sum 1, times `routed_scaling`. An expert
layer may hold a share of the router's experts (`router_experts` wide,
this layer holding `n_experts` from `expert_offset`): the router scores
all of them, and an assignment to an expert held elsewhere is sent
nowhere and adds nothing here (the partial result of this share goes on
to the next layer); the dispatch stays dropless over the held experts.
Those assignments are counted (`moe.absent`, with the other counters).

A dropless dispatch whose buffer, padded to the largest count, would
pass `DISPATCH_BYTES` on the device is run over the tokens in equal
runs, each buffer sized by its own run's counts, halving the runs until
the largest fits: a skewed
routing (DeepSeek-V3 on random weights, a 16k prompt's neighbouring
tokens picking the same experts) would otherwise pad every expert to
~11x the mean.
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


def router_width(cfg: ArchConfig) -> int:
    """The experts the router scores: the published count, of which this
    layer holds `n_experts`."""
    return cfg.router_experts or cfg.n_experts


def moe_params(b: Builder, cfg: ArchConfig, ep: int):
    d, f_ff, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    fac = moe_factor(cfg, ep)
    e_eff, f_eff = e * fac, f_ff // fac
    # the reference's law scales an expert matrix by its first dim, the
    # expert count; `expert_init_fan_in` draws each by its fan-in, so that
    # activations stay of order one at many experts
    s_in, s_out = ((1.0 / math.sqrt(d), 1.0 / math.sqrt(f_ff))
                   if cfg.expert_init_fan_in else (None, None))
    p = {
        "router": b.param((d, router_width(cfg)), ("data", None)),
        "w1": b.param((e_eff, d, f_eff), ("model", "data", None),
                      scale=s_in),
        "w3": b.param((e_eff, d, f_eff), ("model", "data", None),
                      scale=s_in),
        "w2": b.param((e_eff, f_eff, d), ("model", None, "data"),
                      scale=s_out),
    }
    if cfg.router_scoring == "sigmoid":
        # the correction bias, fp32 as published, drawn N(0, 0.1^2)
        p["router_bias"] = b.param((router_width(cfg),), (None,), scale=0.1,
                                   dtype=torch.float32)
    return p


def top_k(x, k: int):
    """`jax.lax.top_k` over the last dim: the k largest values and their
    indices, largest first, the LOWER index first among equal values
    (`torch.topk` promises no order among ties): a stable descending
    sort keeps the original order of equal values. jax also orders -0
    below +0, which this sort takes as equal: the router's softmax
    probabilities are never -0."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def group_top_k(scores, bias, k: int, groups: int, keep: int):
    """`noaux_tc`'s selection: (the top-k experts of scores + bias among
    the `keep` groups (of `groups` equal ones) whose two best biased
    scores sum highest, largest first; the gates, the scores at them
    normalised to sum 1). scores (..., E) fp32."""
    biased = scores if bias is None else scores + bias.float()
    if groups > 1:
        g = biased.reshape(tuple(biased.shape[:-1]) + (groups, -1))
        best = top_k(g, 2)[0].sum(-1)                     # (..., groups)
        _, kept = top_k(best, keep)
        cut = torch.ones(best.shape, dtype=torch.bool,
                         device=best.device).scatter_(-1, kept, False)
        biased = g.masked_fill(cut[..., None], float("-inf")) \
            .reshape(biased.shape)
    _, top_e = top_k(biased, k)
    gate = torch.gather(scores, -1, top_e)
    return top_e, gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-20)


def route(logits, cfg: ArchConfig, bias=None):
    """(the router's scores (..., E), the top-k experts, their gates) of
    the fp32 logits: the softmax, its top-k renormalised; or sigmoid
    scores through `group_top_k`; each gate times `routed_scaling`."""
    k = cfg.experts_per_token
    if cfg.router_scoring == "sigmoid":
        probs = torch.sigmoid(logits)
        top_e, gate = group_top_k(probs, bias, k, cfg.router_groups,
                                  cfg.router_topk_groups)
    else:
        probs = torch.softmax(logits, dim=-1)
        gate, top_e = top_k(probs, k)
        gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    if cfg.routed_scaling != 1.0:
        gate = gate * cfg.routed_scaling
    return probs, top_e, gate


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


# the most a dropless dispatch buffer (every stacked rank's experts x
# capacity rows) may take on the device before the tokens go in runs
DISPATCH_BYTES = 3 << 30


def count_capacity(top_pe, e_eff: int, ctx: ParCtx) -> tuple:
    """(the dropless capacity, the loads): each expert's assignments on
    each stacked rank, a list, and the most any expert gets on any rank of
    the EP group, brought to the host in one read. An expert id of
    `e_eff` (an assignment to an expert held elsewhere) is counted in one
    bin after the loads, the list's last entry."""
    lead = tuple(top_pe.shape[:ctx.lead])
    G = math.prod(lead)
    n = G * e_eff
    ids = top_pe.reshape(G, -1)
    rows = torch.where(ids < e_eff, ids + e_eff * torch.arange(
        G, device=top_pe.device)[:, None], n).reshape(-1)
    loads = torch.zeros(n + 1, dtype=torch.int64,
                        device=top_pe.device).scatter_add_(
        0, rows, torch.ones_like(rows))
    most = loads[:n].max().reshape(1)
    if ctx.local and ctx.tp > 1:
        most = ctx.engine.allreduce(most.float(), ctx.tp_axis, op="max")
    with telemetry.wall().span("moe.count_sync", track="lm"):
        host = torch.cat([loads, most.reshape(-1).long()]).tolist()
    return max(1, max(host[n + 1:])), host[:n + 1]


def dispatch_runs(top_pe, e_eff: int, row_bytes: int, ctx: ParCtx) -> list:
    """[(the tokens, a slice; the dropless capacity; the loads; the
    assignments held elsewhere)] of each run of a dispatch by count, each
    counted on its own (`count_capacity`): one run of every token while
    the buffer of the stacked ranks (e_eff x the capacity rows of
    `row_bytes`) keeps within `DISPATCH_BYTES`, else twice as many equal
    runs, until the largest run's buffer does or a run is one token."""
    G = math.prod(tuple(top_pe.shape[:ctx.lead]))
    t = top_pe.shape[-2]
    runs = 1
    while True:
        at = [-(-r * t // runs) for r in range(runs + 1)]
        cuts = [slice(a, b) for a, b in zip(at, at[1:])]
        counts = [count_capacity(top_pe[..., c, :], e_eff, ctx)
                  for c in cuts]
        most = max(cap for cap, _loads in counts)
        if G * e_eff * most * row_bytes <= DISPATCH_BYTES or runs >= t:
            break
        runs = min(t, 2 * runs)
    return [(c, cap, loads[:-1], loads[-1])
            for c, (cap, loads) in zip(cuts, counts)]


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
    share = router_width(cfg) != e or cfg.expert_offset
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
        bias = params.get("router_bias")
        probs, top_e, gate = route(logits, cfg, None if bias is None
                                   else bias[..., None, :])
        if ctx.routes is not None:      # (the experts, token-sharded?)
            ctx.routes.append((top_e, regather))

        # pseudo-expert expansion: token -> f slots per routed expert
        held = None
        if share:       # the held experts' local ids; the rest e_eff
            local_e = top_e - cfg.expert_offset
            held = (local_e >= 0) & (local_e < e)
            top_e = torch.where(held, local_e, e)
            held = torch.repeat_interleave(held, fac, dim=-1)
        top_pe = (top_e[..., None] * fac
                  + torch.arange(fac, device=x.device)
                  ).reshape(lead + (t, k * fac))
        gate_pe = torch.repeat_interleave(gate, fac, dim=-1)
        if share:
            top_pe = torch.where(held, top_pe, e_eff)

        if by_count:
            runs = dispatch_runs(top_pe, e_eff, d * xt.element_size(), ctx)
        else:
            runs = [(slice(0, t),) + _capacity(t, dropless,
                                               capacity_factor, cfg, fac)]

    ys = [_exchange(params, xt[..., c, :], top_pe[..., c, :],
                    gate_pe[..., c, :],
                    None if held is None else held[..., c, :], capacity,
                    loads, absent, cfg, ctx, tr, by_count, fac)
          for c, capacity, loads, absent in runs]
    y = torch.cat(ys, dim=-2) if len(ys) > 1 else ys[0]
    y = y.reshape(lead + (b, s, d))
    if regather:  # non-SP callers expect the full sequence back
        flat = ctx.engine.allgather(y.transpose(L, L + 1), ctx.tp_axis)
        y = flat.reshape(lead + (s_in, b, d)).transpose(L, L + 1)
    return y, probs


def _capacity(t: int, dropless: bool, capacity_factor: float,
              cfg: ArchConfig, fac: int) -> tuple:
    """(each expert's capacity, no loads, 0 assignments counted held
    elsewhere) of a dispatch not sized by count, of t tokens."""
    e, k = cfg.n_experts, cfg.experts_per_token
    e_eff = e * fac
    if dropless:
        # serving: 4x-expected headroom, capped at the true-dropless bound
        expected = -(-t * k * fac // e_eff)  # ceil
        return min(t * k * fac, max(1, expected * 4)), None, 0
    return int(max(1, round(t * k * capacity_factor / e))), None, 0


def _exchange(params, xt, top_pe, gate_pe, held, capacity: int, loads,
              absent: int, cfg: ArchConfig, ctx: ParCtx, tr, by_count: bool,
              fac: int):
    """Dispatch the tokens xt (*mesh, t, d) to their slots `top_pe` through
    the EP all-to-all, each local expert's SwiGLU, the all-to-all back and
    the gated sum: (*mesh, t, d) in x's dtype."""
    L = ctx.lead
    ep = ctx.tp
    e_eff, k = cfg.n_experts * fac, cfg.experts_per_token
    lead = tuple(xt.shape[:L])
    t, d = xt.shape[L:]
    share = held is not None
    with tr.span("moe.dispatch", track="lm", capacity=capacity):
        # per-rank buffer (e_eff * capacity, d)
        slots = _dispatch_indices(top_pe.reshape(lead + (-1,)), e_eff,
                                  capacity)
        if share:
            slots = torch.where(held.reshape(slots.shape), slots, -1)
        valid = slots >= 0
        G = math.prod(lead)
        ec = e_eff * capacity
        base = torch.arange(G, device=xt.device).reshape(lead + (1,)) * ec
        rows = (base + torch.where(valid, slots, ec - 1)).reshape(-1)
        src = torch.repeat_interleave(xt, k * fac, dim=-2)
        src = torch.where(valid[..., None], src,
                          torch.zeros((), dtype=xt.dtype, device=xt.device))
        buf = xt.new_zeros((G * ec, d)).index_add_(0, rows,
                                                   src.reshape(-1, d))
        del src
        buf = buf.reshape(lead + (ec, d))
        if by_count:    # each expert keeps its first `capacity` rows
            dropped = sum(max(0, n - capacity) for n in loads)
        elif tr.enabled:
            with tr.span("moe.count_sync", track="lm"):
                sent = G * t * k * fac
                if share:
                    absent = int((~held).sum())
                dropped = sent - absent - int(valid.sum())
        if by_count or tr.enabled:
            _count(ctx, tr, by_count, G * t * k, G * ec, dropped,
                   absent if share else None)
        # EP all-to-all: (e_eff*cap, d) -> rows grouped by source rank
        recv = ctx.engine.alltoall(buf, ctx.tp_axis)   # (ep*el*cap, d)
        del buf

    el = e_eff // ep
    with tr.span("moe.experts", track="lm"):
        recv = recv.reshape(lead + (ep, el, capacity, d)).transpose(L, L + 1)
        recv = recv.reshape(lead + (el, ep * capacity, d))
        w1 = ctx.gather_fsdp(params["w1"], 1)
        w3 = ctx.gather_fsdp(params["w3"], 1)
        w2 = ctx.gather_fsdp(params["w2"], 2)
        out = expert_ffn(recv, w1, w3, w2)
        del recv

    with tr.span("moe.combine", track="lm"):
        # reverse all-to-all
        out = out.reshape(lead + (el, ep, capacity, d)).transpose(L, L + 1)
        back = ctx.engine.alltoall(out.reshape(lead + (ec, d)), ctx.tp_axis)
        del out

        # combine: gather each assignment's slot, weight, sum over k*fac
        safe = torch.where(valid, slots, 0)
        picked = ctx.take(back, safe, dim=0) * valid[..., None].to(
            back.dtype)
        del back
        picked = picked.reshape(lead + (t, k * fac, d))
        y = torch.einsum("...tkd,...tk->...td", picked.float(),
                         gate_pe.float())
        return y.to(xt.dtype)


def _count(ctx: ParCtx, tr, engine_too: bool, assignments: int, slots: int,
           dropped: int, absent=None) -> None:
    """The dispatch's counters: into the wall-clock recorder while it
    records, and into the engine's metrics for a dropless dispatch; of
    a layer holding a share of the experts, `moe.absent` too."""
    counts = [("moe.assignments", assignments), ("moe.slots", slots),
              ("moe.dropped", dropped)]
    if absent is not None:
        counts.append(("moe.absent", absent))
    for name, n in counts:
        if tr.enabled:
            tr.count(name, n)
        if engine_too:
            ctx.engine.metrics.inc(name, n)
