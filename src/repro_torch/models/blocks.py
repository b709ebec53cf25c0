"""Transformer blocks per family + the layer stack.

Port of `repro/models/blocks.py`. Where the layer dim sits: a
layer-stacked param leaf is (L, *mesh, *local) — the layer dim leads,
OUTSIDE the mesh dims (the reference's spec P(None, ...) replicates it
over the mesh). So `leaf[i]` is an ordinary mesh-stacked tensor and a
contiguous block of memory, and `layer_slice` hands one layer to the
layer code unchanged. `convert.py` moves the layer dim across when it
carries params to and from the reference's layout.

The reference scans the stack with `lax.scan`; PyTorch runs eagerly, so
the port loops over the layers in Python. With grad enabled each layer
runs under `ParallelConfig.remat` as the reference's scan body does:
'full' recomputes the layer in the backward (`torch.utils.checkpoint`,
non-reentrant), 'dots' saves only the products without batch dims (each
rank's x @ w, `parallel/ops.py::local_matmul`) and 'names' only the
outputs marked `mixer_out` and `mlp_out` (`checkpoint_name`), both by
selective checkpoint policies; remat changes memory, never values. A
recomputed layer re-issues its engine collectives (blocking calls, never
the queue). Per-layer windows are Python ints (`window_per_layer`):
hymba's global layers ignore the window.

Families: dense and vlm (attention + SwiGLU), moe (attention + the
routed experts, `mlp.moe_block`), ssm (the Mamba2 mixer alone,
`models/ssm.py`), hybrid (attention and the Mamba2 mixer in parallel on
the same normed input, mixed as 0.5 x (norm(attn) + norm(ssm)), then
the MLP), audio (a dense decoder whose layers add cross-attention to
the encoder output) and its encoder (dense, non-causal).

A config with `layer_types` (`configs/base.py::LayerTypedConfig`,
Granite-4.0-H) has layers of two kinds in one stack: "mamba" layers run
the Mamba2 mixer and then the MoE (kind "ssm_moe", a pair no family
has), "attention" layers attention and then the MoE (kind "moe"), each
MoE with its shared expert beside it; both residual branches are scaled
by `residual_multiplier`. `layer_plan` is the one place the kinds are
read. The stack's params are then one layer-stacked tree per kind,
`{"mamba": ..., "attention": ...}` (each (L_kind, *mesh, *local)), and
layer i takes row `index` of its kind's tree; its caches likewise
(`cache_names`). DeepSeek-V3's types are "mla_dense" (kind "mla": MLA,
`attention.mla_block`, then the dense SwiGLU of `d_ff`) and "mla_moe"
(kind "mla_moe": MLA, then the MoE and its shared expert); both emit
the latent cache (`c_kv`, `k_pe`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.core import telemetry
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import AttnConfig, attention_block
from repro_torch.models.common import Builder, rms_norm
from repro_torch.parallel import ops as par_ops
from repro_torch.parallel.ops import ParCtx


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stack_trees(trees):
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def stacked(b: Builder, n: int, fn: Callable):
    """Build n stacked copies of fn(builder): (L, *mesh, *local) tensors,
    or specs with a leading None (the replicated layer dim). Drawn layers
    are copied into the stack one at a time, so the draw never holds two
    copies of the stack."""
    if b.mode == "init":
        first = fn(b)
        out = _map_tree(lambda t: t.new_empty((n,) + tuple(t.shape)), first)
        for i in range(n):
            layer = first if i == 0 else fn(b)
            _map_tree(lambda pair: pair[0][i].copy_(pair[1]),
                      _zip_trees(out, layer))
            del layer
        return out
    if b.mode == "shape":
        return _stack_trees([fn(b) for _ in range(n)])
    if b.mode == "spec":
        return _map_tree(lambda s: (None,) + tuple(s), fn(b))
    raise ValueError(f"unknown Builder mode {b.mode!r}")


def _zip_trees(a, b):
    if isinstance(a, dict):
        return {k: _zip_trees(a[k], b[k]) for k in a}
    return (a, b)


def layer_slice(stack_params, i: int):
    """Layer i's params: mesh-stacked tensors."""
    return _map_tree(lambda a: a[i], stack_params)


# --------------------------------------------------------------------------
# Layer kinds
# --------------------------------------------------------------------------

# `layer_types` entry -> the kind of layer `layer_forward` runs
TYPED_KINDS = {"mamba": "ssm_moe", "attention": "moe", "mla_dense": "mla",
               "mla_moe": "mla_moe"}
# the kinds whose feed-forward half is the dense MLP
DENSE_KINDS = ("mla",)


@dataclasses.dataclass(frozen=True)
class LayerSpot:
    kind: str              # the layer's family-like kind (`layer_forward`)
    group: Optional[str]   # its params' tree in the stack (None: uniform)
    index: int             # its row in that tree


def layer_plan(cfg: ArchConfig, n_layers: Optional[int] = None,
               family: Optional[str] = None) -> tuple:
    """Each layer's `LayerSpot`: the family's own kind for a uniform stack
    (every layer a row of one tree), the kind `layer_types` gives
    otherwise, each a row of its type's tree."""
    n = cfg.n_layers if n_layers is None else n_layers
    kinds = cfg.kinds if cfg.layer_types and family is None else ()
    if not kinds:
        fam = family or cfg.family
        return tuple(LayerSpot(fam, None, i) for i in range(n))
    seen: dict = {}
    out = []
    for t in kinds:
        if t not in TYPED_KINDS:
            raise ValueError(f"unknown layer type {t!r}")
        if TYPED_KINDS[t] not in DENSE_KINDS and not cfg.n_experts:
            raise ValueError(f"layer type {t!r} needs an MoE after its "
                             "mixer")
        out.append(LayerSpot(TYPED_KINDS[t], t, seen.get(t, 0)))
        seen[t] = seen.get(t, 0) + 1
    return tuple(out)


def layer_params_of(stack_params, spot: LayerSpot):
    """Layer `spot`'s params: mesh-stacked tensors."""
    tree = stack_params if spot.group is None else stack_params[spot.group]
    return layer_slice(tree, spot.index)


def stack_params(b: Builder, cfg: ArchConfig, tp: int, cross: bool = False):
    """The decoder stack's params: one layer-stacked tree, or one per
    layer type (in the order the types first appear)."""
    plan = layer_plan(cfg)
    if plan[0].group is None:
        return stacked(b, cfg.n_layers,
                       lambda bb: layer_params(bb, cfg, tp, cross=cross))
    groups: dict = {}
    for spot in plan:
        groups.setdefault(spot.group, [spot.kind, 0])[1] += 1
    return {g: stacked(b, n, lambda bb, k=kind: layer_params(
        bb, cfg, tp, family=k)) for g, (kind, n) in groups.items()}


def cache_names(kind: str, cross: bool = False) -> tuple:
    """The caches a layer of `kind` emits in prefill, in order."""
    names = {"ssm": ("conv", "state"), "ssm_moe": ("conv", "state"),
             "hybrid": ("k", "v", "conv", "state"), "mla": ("c_kv", "k_pe"),
             "mla_moe": ("c_kv", "k_pe")}.get(kind, ("k", "v"))
    return names + (("xk", "xv") if cross else ())


def has_ssm(kind: str) -> bool:
    return kind in ("ssm", "ssm_moe", "hybrid")


def has_mla(kind: str) -> bool:
    return kind in ("mla", "mla_moe")


def has_attention(kind: str) -> bool:
    return kind not in ("ssm", "ssm_moe")


def residual(cfg: ArchConfig, y):
    """A residual branch scaled by `residual_multiplier` (as is at 1)."""
    m = cfg.residual_multiplier
    return y if m == 1.0 else y * m


# --------------------------------------------------------------------------
# Per-family layer params
# --------------------------------------------------------------------------

def layer_params(b: Builder, cfg: ArchConfig, tp: int, cross: bool = False,
                 family: Optional[str] = None):
    family = family or cfg.family
    d = cfg.d_model
    p = {"norm1": b.param((d,), (None,), init="ones")}
    if family in ("ssm", "ssm_moe"):
        p["ssm"] = ssm_mod.ssm_params(b, cfg, tp)
        if family == "ssm":
            return p
    elif has_mla(family):
        p["attn"] = attn_mod.mla_params(b, cfg, tp)
    else:
        p["attn"] = attn_mod.attn_params(b, cfg, tp)
    p["norm2"] = b.param((d,), (None,), init="ones")
    if family in ("moe", "ssm_moe", "mla_moe"):
        p["moe"] = mlp_mod.moe_params(b, cfg, tp)
        if cfg.shared_d_ff:
            p["shared"] = mlp_mod.mlp_params(b, cfg, cfg.shared_d_ff)
    else:
        p["mlp"] = mlp_mod.mlp_params(b, cfg)
    if family == "hybrid":
        p["ssm"] = ssm_mod.ssm_params(b, cfg, tp)
        p["norm_attn_out"] = b.param((d,), (None,), init="ones")
        p["norm_ssm_out"] = b.param((d,), (None,), init="ones")
    if cross:
        p["xattn"] = attn_mod.attn_params(b, cfg, tp)
        p["norm_x"] = b.param((d,), (None,), init="ones")
    return p


# --------------------------------------------------------------------------
# Remat
# --------------------------------------------------------------------------

# `enabled` while a remat='names' layer runs (its recompute included);
# `name`: the name `checkpoint_name` is marking while its clone runs
_NAMED = {"enabled": False, "name": None}
_MM = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
       torch.ops.aten.addmm.default)


def checkpoint_name(x, name: str):
    """Mark `x` as the named residual `name` (the reference's
    `checkpoint_name`): inside a remat='names' layer it is a copy of x
    that the selective policy saves; otherwise x itself."""
    if not (_NAMED["enabled"] and x.requires_grad):
        return x
    _NAMED["name"] = name
    try:
        return x.clone()
    finally:
        _NAMED["name"] = None


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _MM and par_ops.DOTS["active"]:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _names_policy(ctx, op, *args, **kwargs):
    if op == torch.ops.aten.clone.default and _NAMED["name"] in (
            "mixer_out", "mlp_out"):
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


_POLICIES = {"dots": _dots_policy, "names": _names_policy}


def _naming(fn: Callable) -> Callable:
    def run(*args, **kwargs):
        _NAMED["enabled"] = True
        try:
            return fn(*args, **kwargs)
        finally:
            _NAMED["enabled"] = False
    return run


def remat_layer(fn: Callable, remat: str) -> Callable:
    """`fn` (one layer) under the remat mode: 'none' as is, 'full'
    recomputed whole in the backward, 'dots' / 'names' recomputed but
    for what their policy saves. Only while grad is enabled."""
    if remat == "none" or not torch.is_grad_enabled():
        return fn
    if remat == "full":
        return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False)
    if remat not in _POLICIES:
        raise ValueError(f"unknown remat mode {remat!r}")
    ctx_fn = functools.partial(_ckpt.create_selective_checkpoint_contexts,
                               _POLICIES[remat])
    return functools.partial(_ckpt.checkpoint,
                             _naming(fn) if remat == "names" else fn,
                             use_reentrant=False, context_fn=ctx_fn)


# --------------------------------------------------------------------------
# Forward (prefill, no decode cache)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class LayerIO:
    window: int = 0                       # 0 = full attention
    positions: Optional[torch.Tensor] = None   # (S,)
    enc_out: Optional[torch.Tensor] = None     # encoder output (audio)


def ffn_block(lp, h, cfg: ArchConfig, ctx: ParCtx, decode: bool = False):
    """The layer's feed-forward half on its normed input: the MoE (and
    its shared expert beside it) or the dense MLP. Returns (y,
    router probs or None). Decode dispatches with headroom (`moe_block`'s
    `dropless`); a `moe_dropless` config sizes the dispatch by its
    counts in prefill and decode alike."""
    if "moe" not in lp:
        return mlp_mod.mlp_block(lp["mlp"], h, cfg, ctx), None
    y, aux = mlp_mod.moe_block(lp["moe"], h, cfg, ctx,
                               ctx.pcfg.moe_capacity_factor, dropless=decode,
                               by_count=cfg.moe_dropless)
    if "shared" in lp:
        with telemetry.wall().span("moe.shared", track="lm"):
            y = y + mlp_mod.mlp_block(lp["shared"], h, cfg, ctx)
    return y, aux


def layer_forward(lp, x, cfg: ArchConfig, ctx: ParCtx, io: LayerIO,
                  causal: bool = True, family: Optional[str] = None,
                  collect_cache: bool = False):
    """One block. Returns (x, moe_probs_or_None, cache_tuple)."""
    family = family or cfg.family
    pc = ctx.pcfg
    aux = None
    cache = ()
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    if family in ("ssm", "ssm_moe"):
        y, (conv, st) = ssm_mod.ssm_mixer(lp["ssm"], h, cfg, ctx)
        y = checkpoint_name(y, "mixer_out")
        if collect_cache:
            cache = (conv, st)
        if family == "ssm":
            return x + y, aux, cache
        x = x + residual(cfg, y)
    elif has_mla(family):
        y = attn_mod.mla_block(
            lp["attn"], h, cfg, ctx, io.positions, q_block=pc.attn_q_block,
            kv_block=pc.attn_kv_block, return_kv=collect_cache)
        if collect_cache:
            y, cache = y
        x = x + residual(cfg, checkpoint_name(y, "mixer_out"))
    else:
        acfg = AttnConfig(causal=causal)
        y = attention_block(
            lp["attn"], h, cfg, ctx, acfg, io.positions, window=io.window,
            q_block=pc.attn_q_block, kv_block=pc.attn_kv_block,
            return_kv=collect_cache)
        if collect_cache:
            y, cache = y
        if family == "hybrid":
            s_out, (conv, st) = ssm_mod.ssm_mixer(lp["ssm"], h, cfg, ctx)
            if collect_cache:
                cache = cache + (conv, st)
            y = 0.5 * (rms_norm(y, lp["norm_attn_out"], cfg.norm_eps)
                       + rms_norm(s_out, lp["norm_ssm_out"], cfg.norm_eps))
        x = x + residual(cfg, checkpoint_name(y, "mixer_out"))

    if "xattn" in lp:
        hx = rms_norm(x, lp["norm_x"], cfg.norm_eps)
        y = attention_block(
            lp["xattn"], hx, cfg, ctx, AttnConfig(causal=False, cross=True),
            io.positions, kv_source=io.enc_out,
            q_block=pc.attn_q_block, kv_block=pc.attn_kv_block,
            return_kv=collect_cache)
        if collect_cache:
            y, xkv = y
            cache = cache + xkv
        x = x + y

    h = rms_norm(x, lp["norm2"], cfg.norm_eps)
    y, aux = ffn_block(lp, h, cfg, ctx)
    return x + residual(cfg, checkpoint_name(y, "mlp_out")), aux, cache


def window_per_layer(cfg: ArchConfig, n_layers: int) -> list:
    """Per-layer attention window (python ints); 0 = full attention."""
    w = []
    for i in range(n_layers):
        if cfg.sliding_window and i not in cfg.global_attn_layers:
            w.append(cfg.sliding_window)
        else:
            w.append(0)
    return w


def stack_forward(stack_params, x, cfg: ArchConfig, ctx: ParCtx,
                  positions, *, causal=True, enc_out=None,
                  family: Optional[str] = None, collect_cache: bool = False):
    """Run the layer stack, one layer after another (family "encoder":
    the audio encoder's dense layers).

    Returns (x, moe_aux_loss, caches) — caches is a tuple of layer-stacked
    (L, *mesh, *local) tensors when collect_cache (prefill), else (): one
    per name of `cache_names`, in the order the names first appear, each
    stacked over the layers that emit it. The aux loss is stacked per rank
    (*mesh,): the switch-style balance term E * sum(mean router prob ** 2)
    of each rank's routed tokens, averaged over the layers (0 without
    experts).
    """
    family = family or cfg.family
    if family == "encoder":
        plan = layer_plan(cfg, cfg.encoder_layers, family="dense")
    else:
        plan = layer_plan(cfg, family=None if family == cfg.family
                          else family)
    windows = window_per_layer(cfg, len(plan))
    layer = remat_layer(layer_forward, ctx.pcfg.remat)
    cross = enc_out is not None
    by_name: dict = {}
    aux_terms = []
    tr = telemetry.wall()
    for i, spot in enumerate(plan):
        io = LayerIO(window=windows[i], positions=positions, enc_out=enc_out)
        with tr.span("lm.layer", track="lm", layer=i,
                     kind=spot.group or spot.kind):
            x, aux, cache = layer(layer_params_of(stack_params, spot), x,
                                  cfg, ctx, io, causal=causal,
                                  family=spot.kind,
                                  collect_cache=collect_cache)
        if collect_cache:
            for name, leaf in zip(cache_names(spot.kind, cross), cache):
                by_name.setdefault(name, []).append(leaf)
        if aux is not None:
            pe = aux.mean(-2)          # (*mesh, E) mean router prob
            aux_terms.append(cfg.n_experts * torch.sum(pe * pe, dim=-1))
    caches = tuple(torch.stack(leaves) for leaves in by_name.values())
    aux_loss = torch.stack(aux_terms).mean(0) if aux_terms else \
        torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux_loss, caches
