"""Dense SwiGLU MLP.

Port of `repro/models/mlp.py::mlp_params` and `mlp_block`. The MoE layer
and its engine all-to-all dispatch (`mlp.py:50-178` of the reference)
wait for ROADMAP Queue 1 item 6b.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import Builder, silu
from repro_torch.parallel.ops import ParCtx, local_matmul


def mlp_params(b: Builder, cfg: ArchConfig):
    d, f = cfg.d_model, cfg.d_ff
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
