"""Step builders for serving: prefill and decode_step over the mesh.

Port of the serving half of `repro/parallel/stages.py` (gradient sync
and the train step wait for ROADMAP Queue 1 item 6c). The reference runs
each step inside ONE shard_map over the mesh and jits it; the port has
no jit and no shard_map: every rank is a row of a mesh-stacked tensor
(`parallel/ops.py`), every collective — FSDP gathers, TP reductions —
is issued by the CollectiveEngine on the whole stack (backend
'microcode' = the paper's CCLO; 'native' = plain torch reductions), and
the builders return plain callables over stacked tensors. Params are
drawn in the layout the step that takes them expects (`serve=True`: the
serving layout, weights replicated over 'data'); the reference lets jax
reshard an FSDP-laid param tree at the call.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig, ParallelConfig
from repro_torch.core.engine import CollectiveEngine
from repro_torch.models import lm as lm_mod
from repro_torch.models import serve as serve_mod
from repro_torch.models.common import Builder, dt
from repro_torch.parallel.ops import ParCtx


def make_ctx(cfg: ArchConfig, pcfg: ParallelConfig, mesh_shape: dict,
             device="cuda") -> ParCtx:
    """The step's parallel context; its engine raises on device='cuda'
    without a card."""
    engine = CollectiveEngine(dict(mesh_shape), backend=pcfg.backend,
                              device=device)
    return ParCtx(engine=engine, pcfg=pcfg)


# --------------------------------------------------------------------------
# Params
# --------------------------------------------------------------------------

def _drop_data_axis(spec) -> tuple:
    return tuple(None if e == "data" else e for e in spec)


def param_specs(cfg: ArchConfig, tp: int, serve: bool = False):
    """The param tree's spec entries; serve=True: the serving layout,
    weights replicated over 'data' (pure TP) — no ZeRO-3 gathers on the
    token path."""
    b = Builder("spec", spec_map=_drop_data_axis if serve else None)
    return lm_mod.model_params(b, cfg, tp)


def init_params(cfg: ArchConfig, mesh_shape: dict, tp: int, seed: int = 0,
                device="cuda", serve: bool = False):
    """Random params drawn on `device` from `seed` (a torch.Generator),
    mesh-stacked in the FSDP layout or, with serve=True, the serving
    layout."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    b = Builder("init", generator=gen, mesh_shape=dict(mesh_shape),
                device=device, dtype=dt(cfg.param_dtype),
                spec_map=_drop_data_axis if serve else None)
    return lm_mod.model_params(b, cfg, tp)


# --------------------------------------------------------------------------
# Serve steps
# --------------------------------------------------------------------------

def dp_axes(mesh_shape: dict, global_batch: int):
    """DP sharding axes for a batch dim; None (replicate) when the batch
    is smaller than the DP group (B=1 long-context decode)."""
    axes = tuple(a for a in ("pod", "data")
                 if a in mesh_shape and mesh_shape[a] > 1)
    n = 1
    for a in axes:
        n *= mesh_shape[a]
    return axes if axes and global_batch % n == 0 else None


def build_prefill(cfg: ArchConfig, pcfg: ParallelConfig, mesh_shape: dict,
                  global_batch: int, seq_len: int, device="cuda"):
    """(prefill fn, ctx, param specs, batch specs). The fn takes the
    serving-layout params and a stacked batch of `seq_len` tokens and
    returns (next tokens stacked (*mesh, B_local), layer-stacked caches
    laid out by `serve.prefill_cache_specs`)."""
    pcfg = dataclasses.replace(pcfg, serving=True)
    ctx = make_ctx(cfg, pcfg, mesh_shape, device)
    specs = param_specs(cfg, ctx.tp, serve=True)
    dp = dp_axes(mesh_shape, global_batch)
    bspec = lm_mod.batch_specs(cfg, "prefill", dp=dp)

    @torch.inference_mode()
    def pf(params, batch):
        s = batch["tokens"].shape[-1]
        if s != seq_len:
            raise ValueError(f"prefill built for {seq_len} tokens, got {s}")
        return serve_mod.prefill(params, batch, cfg, ctx)

    return pf, ctx, specs, bspec


def cache_specs(cfg: ArchConfig, pcfg: ParallelConfig, tp: int,
                s_max: int, s_enc: int = 0, dp=("pod", "data")):
    return serve_mod.make_cache(Builder("spec"), cfg, tp, 0, s_max, pcfg,
                                s_enc=s_enc, dp=dp)


def init_cache(cfg: ArchConfig, pcfg: ParallelConfig, mesh_shape: dict,
               tp: int, batch: int, s_max: int, s_enc: int = 0,
               device="cuda"):
    """Zero decode caches, mesh-stacked on `device`."""
    b = Builder("init", mesh_shape=dict(mesh_shape), device=device,
                dtype=dt(cfg.param_dtype))
    return serve_mod.make_cache(b, cfg, tp, batch, s_max, pcfg, s_enc=s_enc,
                                dp=dp_axes(mesh_shape, batch))


def build_decode_step(cfg: ArchConfig, pcfg: ParallelConfig,
                      mesh_shape: dict, s_max: int, global_batch: int,
                      s_enc: int = 0, device="cuda"):
    """(decode fn, ctx, param specs, cache specs). The fn takes the
    serving-layout params, the caches, stacked tokens (*mesh, B_local,
    1) and the position `pos` (an int) and returns (next tokens stacked
    (*mesh, B_local), the caches, written in place)."""
    pcfg_d = dataclasses.replace(pcfg, sequence_parallel=False,
                                 serving=True)
    ctx = make_ctx(cfg, pcfg_d, mesh_shape, device)
    specs = param_specs(cfg, ctx.tp, serve=True)
    cspecs = cache_specs(cfg, pcfg_d, ctx.tp, s_max, s_enc=s_enc,
                         dp=dp_axes(mesh_shape, global_batch))

    @torch.inference_mode()
    def dstep(params, caches, tokens, pos: int):
        return serve_mod.decode_step(params, caches, tokens, int(pos), cfg,
                                     ctx, s_max)

    return dstep, ctx, specs, cspecs
