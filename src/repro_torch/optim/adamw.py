"""AdamW with fp32 master weights, built from scratch.

Port of `repro/optim/adamw.py`. Mixed precision: params may live in
bf16; the optimizer state holds fp32 master copies plus fp32 (m, v).
The state tree mirrors the param tree — `{"leaves": {path: {"master",
"m", "v"}}, "count"}` — so every leaf is mesh-stacked like its param
(and inherits its FSDP/TP spec, `opt_specs`): optimizer memory scales
1/(fsdp*tp) like the params. `count` is a 0-d int32 tensor.

The reference's update is functional and its step donates the old
state; here `adamw_update` computes the same values and, with
`inplace=True` (the train step's use), writes them into the state's own
buffers, and `apply_updates` can write the new params into the param
buffers (ROADMAP Queue 3). The master is always a copy, never an alias
of the param.

Gradient clipping uses a *global* norm: the local sum-of-squares must be
reduced over every mesh axis that shards params or batch; the caller
passes that reduction in (`psum_fn`, engine-aware).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def _is_state_leaf(x) -> bool:
    return isinstance(x, dict) and "master" in x


def adamw_init(params):
    def init_leaf(p):
        # a copy: the master never aliases the compute-dtype param buffer
        return {"master": p.detach().to(torch.float32, copy=True),
                "m": torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device),
                "v": torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)}
    dev = leaves(params)[0].device
    return {"leaves": tree_map(init_leaf, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree, psum_fn: Optional[Callable] = None):
    sq = sum(torch.sum(torch.square(l.float())) for l in leaves(tree))
    if psum_fn is not None:
        sq = psum_fn(sq)
    return torch.sqrt(sq)


def clip_by_global_norm(grads, max_norm: float,
                        psum_fn: Optional[Callable] = None):
    norm = global_norm(grads, psum_fn)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


def adamw_update(cfg: AdamWConfig, grads, state, lr_scale=1.0,
                 psum_fn: Optional[Callable] = None, inplace: bool = False):
    """Returns (new_state, metrics). `grads` mirrors the params (any float
    precision); `psum_fn` reduces scalars across shard groups for the
    global clip norm. With `inplace`, the new master/m/v are written into
    `state`'s own buffers and `state` itself is returned, its count
    advanced."""
    count = state["count"] + 1
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, psum_fn)
    cf = count.to(torch.float32)
    b1c = 1.0 - cfg.b1 ** cf
    b2c = 1.0 - cfg.b2 ** cf
    lr = cfg.lr * lr_scale
    if isinstance(lr, torch.Tensor):
        lr = lr.to(cf.device)

    def upd(leaf_state, g):
        m = cfg.b1 * leaf_state["m"] + (1 - cfg.b1) * g
        v = cfg.b2 * leaf_state["v"] + (1 - cfg.b2) * torch.square(g)
        mhat = m / b1c
        vhat = v / b2c
        step = mhat / (torch.sqrt(vhat) + cfg.eps)
        master = leaf_state["master"] * (1.0 - lr * cfg.weight_decay) \
            - lr * step
        if not inplace:
            return {"master": master, "m": m, "v": v}
        for k, val in (("master", master), ("m", m), ("v", v)):
            leaf_state[k].copy_(val)
        return leaf_state

    new_leaves = tree_map(upd, state["leaves"], grads, is_leaf=_is_state_leaf)
    if inplace:
        state["count"].copy_(count)
        return state, {"grad_norm": gnorm}
    return {"leaves": new_leaves, "count": count}, {"grad_norm": gnorm}


def apply_updates(state, param_dtype, params=None):
    """Materialize compute-precision params from fp32 masters; with
    `params`, write them into those buffers and return `params`."""
    if params is None:
        return tree_map(lambda l: l["master"].to(param_dtype),
                        state["leaves"], is_leaf=_is_state_leaf)
    tree_map(lambda p, l: p.copy_(l["master"]), params, state["leaves"])
    return params


def opt_specs(param_specs):
    """Optimizer-state spec tree mirroring the params' spec entries."""
    return {"leaves": tree_map(lambda s: {"master": s, "m": s, "v": s},
                               param_specs),
            "count": ()}
