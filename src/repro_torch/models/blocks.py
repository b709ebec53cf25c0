"""Transformer blocks for the dense and VLM families + the layer stack.

Port of `repro/models/blocks.py`. Where the layer dim sits: a
layer-stacked param leaf is (L, *mesh, *local) — the layer dim leads,
OUTSIDE the mesh dims (the reference's spec P(None, ...) replicates it
over the mesh). So `leaf[i]` is an ordinary mesh-stacked tensor and a
contiguous block of memory, and `layer_slice` hands one layer to the
layer code unchanged. `convert.py` moves the layer dim across when it
carries params to and from the reference's layout.

The reference scans the stack with `lax.scan` under remat and
`checkpoint_name` so its compiled body stays O(1) in depth; PyTorch runs
eagerly, so the port loops over the layers in Python (remat is a
training concern, ROADMAP Queue 1 item 6c). Per-layer windows are Python
ints (`window_per_layer`).

The `moe`, `ssm`, `hybrid` and `audio` families' layers wait for ROADMAP
Queue 1 item 6b: `layer_params` and `layer_forward` raise
`NotImplementedError` for them (`check_family`), so such an arch never
falls through to a dense layer.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.attention import AttnConfig, attention_block
from repro_torch.models.common import Builder, rms_norm
from repro_torch.parallel.ops import ParCtx

SERVED_FAMILIES = ("dense", "vlm")
_DEFERRED = {
    "moe": "the MoE layer and its engine all-to-all dispatch",
    "ssm": "the Mamba2 mixer (models/ssm.py)",
    "hybrid": "the Mamba2 mixer (models/ssm.py)",
    "audio": "the encoder stack and cross-attention",
    "encoder": "the encoder stack and cross-attention",
}


def check_family(family: str) -> None:
    """Raise unless the port runs this family's layers."""
    if family not in SERVED_FAMILIES:
        what = _DEFERRED.get(family, f"family {family!r}")
        raise NotImplementedError(
            f"family {family!r} is not ported yet: {what} waits for "
            f"ROADMAP Queue 1 item 6b")


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
    if b.mode == "init":
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
    check_family("audio" if cross else family)
    d = cfg.d_model
    return {
        "norm1": b.param((d,), (None,), init="ones"),
        "attn": attn_mod.attn_params(b, cfg, tp),
        "norm2": b.param((d,), (None,), init="ones"),
        "mlp": mlp_mod.mlp_params(b, cfg),
    }


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
    check_family(family)
    pc = ctx.pcfg
    cache = ()
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    y = attention_block(
        lp["attn"], h, cfg, ctx, AttnConfig(causal=causal), io.positions,
        window=io.window, q_block=pc.attn_q_block,
        kv_block=pc.attn_kv_block, return_kv=collect_cache)
    if collect_cache:
        y, cache = y
    x = x + y
    h = rms_norm(x, lp["norm2"], cfg.norm_eps)
    return x + mlp_mod.mlp_block(lp["mlp"], h, cfg, ctx), None, cache


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
    """Run the layer stack, one layer after another.

    Returns (x, moe_aux_loss, caches) — caches is a tuple of layer-stacked
    (L, *mesh, *local) tensors when collect_cache (prefill), else ().
    The aux loss is 0: no served family routes experts.
    """
    family = family or cfg.family
    check_family(family)
    windows = window_per_layer(cfg, cfg.n_layers)
    cache_list = []
    for i in range(cfg.n_layers):
        io = LayerIO(window=windows[i], positions=positions, enc_out=enc_out)
        x, _aux, cache = layer_forward(layer_slice(stack_params, i), x, cfg,
                                       ctx, io, causal=causal, family=family,
                                       collect_cache=collect_cache)
        cache_list.append(cache)
    caches = tuple(torch.stack(leaves) for leaves in zip(*cache_list)) \
        if collect_cache else ()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux, caches
