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
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import ArchConfig
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
    or specs with a leading None (the replicated layer dim)."""
    if b.mode in ("init", "shape"):
        return _stack_trees([fn(b) for _ in range(n)])
    if b.mode == "spec":
        return _map_tree(lambda s: (None,) + tuple(s), fn(b))
    raise ValueError(f"unknown Builder mode {b.mode!r}")


def layer_slice(stack_params, i: int):
    """Layer i's params: mesh-stacked tensors."""
    return _map_tree(lambda a: a[i], stack_params)


# --------------------------------------------------------------------------
# Per-family layer params
# --------------------------------------------------------------------------

def layer_params(b: Builder, cfg: ArchConfig, tp: int, cross: bool = False,
                 family: Optional[str] = None):
    family = family or cfg.family
    d = cfg.d_model
    p = {"norm1": b.param((d,), (None,), init="ones")}
    if family == "ssm":
        p["ssm"] = ssm_mod.ssm_params(b, cfg, tp)
        return p
    p["attn"] = attn_mod.attn_params(b, cfg, tp)
    p["norm2"] = b.param((d,), (None,), init="ones")
    if family == "moe":
        p["moe"] = mlp_mod.moe_params(b, cfg, tp)
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


def layer_forward(lp, x, cfg: ArchConfig, ctx: ParCtx, io: LayerIO,
                  causal: bool = True, family: Optional[str] = None,
                  collect_cache: bool = False):
    """One block. Returns (x, moe_probs_or_None, cache_tuple)."""
    family = family or cfg.family
    pc = ctx.pcfg
    aux = None
    cache = ()
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    if family == "ssm":
        y, (conv, st) = ssm_mod.ssm_mixer(lp["ssm"], h, cfg, ctx)
        y = checkpoint_name(y, "mixer_out")
        if collect_cache:
            cache = (conv, st)
        return x + y, aux, cache

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
    x = x + checkpoint_name(y, "mixer_out")

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
    if family == "moe":
        y, aux = mlp_mod.moe_block(lp["moe"], h, cfg, ctx,
                                   pc.moe_capacity_factor)
    else:
        y = mlp_mod.mlp_block(lp["mlp"], h, cfg, ctx)
    return x + checkpoint_name(y, "mlp_out"), aux, cache


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
    (L, *mesh, *local) tensors when collect_cache (prefill), else ().
    The aux loss is stacked per rank (*mesh,): the switch-style balance
    term E * sum(mean router prob ** 2) of each rank's routed tokens,
    averaged over the layers (0 without experts).
    """
    family = family or cfg.family
    n_layers = cfg.encoder_layers if family == "encoder" else cfg.n_layers
    fam = "dense" if family == "encoder" else family
    windows = window_per_layer(cfg, n_layers)
    layer = remat_layer(layer_forward, ctx.pcfg.remat)
    cache_list, aux_terms = [], []
    for i in range(n_layers):
        io = LayerIO(window=windows[i], positions=positions, enc_out=enc_out)
        x, aux, cache = layer(layer_slice(stack_params, i), x, cfg, ctx, io,
                              causal=causal, family=fam,
                              collect_cache=collect_cache)
        cache_list.append(cache)
        if aux is not None:
            pe = aux.mean(-2)          # (*mesh, E) mean router prob
            aux_terms.append(cfg.n_experts * torch.sum(pe * pe, dim=-1))
    caches = tuple(torch.stack(leaves) for leaves in zip(*cache_list)) \
        if collect_cache else ()
    aux_loss = torch.stack(aux_terms).mean(0) if aux_terms else \
        torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux_loss, caches
