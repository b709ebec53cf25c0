"""Sharded linear algebra through the CollectiveEngine.

Port of `repro/parallel/ops.py`. Every TP/FSDP communication pattern the
models use goes through the engine, the single chokepoint for model
communication:

  gather_fsdp          ZeRO-3 weight all-gather at use
  row_parallel_finish  allreduce (baseline) or seq reduce-scatter (SP)
  sp_allgather_seq     SP re-gather of sequence-sharded activations
  col_parallel_matmul  optionally the streaming collective matmul
  tp_slice, take       a per-rank slice / gather along a local dim (the
                       reference's `dynamic_slice_in_dim` and `take` at
                       an offset of `tp_rank()`)

Every tensor here is MESH-STACKED (`convert.py`): its leading dims are
the engine's mesh axes in mesh order and its trailing dims one rank's
local array. A `dim` argument names a LOCAL dim, as in the reference,
where each rank saw only its local array. The rank of a stacked row is
no longer `lax.axis_index` but its position along the mesh dim
(`tp_rank`). On an engine of one process (`core/procgroup.py`,
`stack_shape == ()`) the same code takes LOCAL shards: no mesh dim
leads, `tp_rank` is the process's own rank on the TP axis and
`tp_slice` a narrow at it — the reference's per-device form. Gradients follow the reference's shard_map autodiff
contract through the engine's adjoint Functions (`core/autograd.py`):
the backward differentiates the sum of the per-rank losses, and a
param's gradient is allreduced over every mesh axis absent from its
spec (`stages.grad_sync`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ParallelConfig
from repro_torch.core.engine import CollectiveEngine


# set while `local_matmul` runs: the products `remat="dots"` saves
# (`models/blocks.py`), each rank's x @ w without batch dims
DOTS = {"active": False}


def local_matmul(x, w, lead: int):
    """Each rank's `x @ w` (the reference's einsum "...d,df->...f"): x is
    stacked (*mesh, ..., d), w stacked (*mesh, d, f), `lead` mesh dims."""
    if DOTS["active"]:
        return _local_matmul(x, w, lead)
    DOTS["active"] = True
    try:
        return _local_matmul(x, w, lead)
    finally:
        DOTS["active"] = False


def _local_matmul(x, w, lead: int):
    if x.ndim - lead == 1:
        return _local_matmul(x.unsqueeze(-2), w, lead).squeeze(-2)
    if x.ndim - lead > 2:              # fold x's batch dims into its rows
        rows = x.reshape(tuple(x.shape[:lead]) + (-1, x.shape[-1]))
        return torch.matmul(rows, w).reshape(tuple(x.shape[:-1])
                                             + (w.shape[-1],))
    return torch.matmul(x, w)


@dataclasses.dataclass
class ParCtx:
    """Per-step parallel context threaded through all layers. `routes`:
    while a list, every MoE layer appends its routing to it
    (`mlp.moe_block`), the record a check holds the served path to."""

    engine: CollectiveEngine
    pcfg: ParallelConfig
    routes: Optional[list] = None

    @property
    def mesh_shape(self) -> dict:
        return self.engine.mesh_shape

    @property
    def lead(self) -> int:
        """Number of mesh dims leading every stacked tensor (0 on local
        shards)."""
        return len(self.engine.stack_shape)

    @property
    def local(self) -> bool:
        """Whether tensors are one process's local shards."""
        return self.engine.stack_shape == ()

    @property
    def tp(self) -> int:
        return self.mesh_shape.get(self.pcfg.tp_axis, 1)

    @property
    def fsdp(self) -> int:
        if self.pcfg.serving:
            return 1  # serving layout: weights replicated over 'data'
        return self.mesh_shape.get(self.pcfg.fsdp_axis, 1)

    @property
    def tp_axis(self) -> str:
        return self.pcfg.tp_axis

    @property
    def fsdp_axis(self) -> str:
        return self.pcfg.fsdp_axis

    def tp_rank(self, local_ndim: int = 0):
        """Each stacked row's rank along the TP axis: an int64 tensor of
        the mesh's rank (1 on every dim but the TP axis's), broadcastable
        against the leading dims of a stacked tensor — and, with
        `local_ndim` trailing 1s, against the whole of one with that many
        local dims. On local shards: this process's rank, 0-d (with
        `local_ndim` 1s)."""
        if self.local:
            return torch.tensor(self.own_tp_rank(),
                                device=self.engine.device).reshape(
                [1] * local_ndim)
        shape = [1] * self.lead
        if self.pcfg.tp_axis in self.mesh_shape:
            shape[list(self.mesh_shape).index(self.pcfg.tp_axis)] = self.tp
        return torch.arange(self.tp, device=self.engine.device).reshape(
            shape + [1] * local_ndim)

    def take(self, x, index, dim: int):
        """Each rank's `take(x, index, axis=dim)` along local `dim`.
        `index` is 1-D (the same on every rank) or stacked (broadcastable
        over the mesh dims, e.g. built from `tp_rank(1)`) with one local
        dim of indices."""
        d = self._dim(x, dim)
        if index.ndim == 1:
            return x.index_select(d, index)
        idx = index.reshape(tuple(index.shape[:self.lead])
                            + (1,) * (d - self.lead) + (index.shape[-1],)
                            + (1,) * (x.ndim - d - 1))
        shape = list(x.shape)
        shape[d] = index.shape[-1]
        return torch.gather(x, d, idx.expand(shape))

    def tp_slice(self, x, size: int, dim: int = -1):
        """Each rank's slice [rank * size, (rank + 1) * size) of local dim
        `dim` (the reference's `dynamic_slice_in_dim(x, tp_rank() * size,
        size, dim)`); a view of x."""
        if self.tp == 1:
            return x
        d = self._dim(x, dim)
        if self.local:
            return x.narrow(d, self.own_tp_rank() * size, size)
        m = list(self.mesh_shape).index(self.pcfg.tp_axis)
        parts = x.shape[d] // size
        xs = x.reshape(tuple(x.shape[:d]) + (parts, size)
                       + tuple(x.shape[d + 1:]))
        return torch.diagonal(xs, dim1=m, dim2=d).movedim(-1, m)

    def own_tp_rank(self) -> int:
        """This process's rank on the TP axis (local shards only)."""
        if self.pcfg.tp_axis not in self.mesh_shape:
            return 0
        return self.engine.comm_rank(self.pcfg.tp_axis)

    def _dim(self, x, dim: int) -> int:
        """Stacked position of local dim `dim`."""
        return self.lead + dim if dim >= 0 else x.ndim + dim

    def _lead_shape(self, x) -> tuple:
        return tuple(x.shape[:self.lead])

    # -- FSDP ---------------------------------------------------------------
    def gather_fsdp(self, w, dim: int = 0):
        """All-gather a ZeRO-3-sharded weight along local `dim` for use."""
        if self.fsdp == 1:
            return w
        d, D = self._dim(w, dim), self.lead
        w = w.movedim(d, D)
        shape = (w.shape[D] * self.fsdp,) + tuple(w.shape[D + 1:])
        out = self.engine.allgather(w, self.fsdp_axis).reshape(
            self._lead_shape(w) + shape)
        return out.movedim(D, d)

    # -- TP epilogues/prologues ----------------------------------------------
    def row_parallel_finish(self, y_partial, seq_dim: int = 1):
        """Finish a row-parallel matmul: allreduce over TP, or — under
        sequence parallelism — reduce-scatter the sequence dim (engine
        ring RS)."""
        if self.tp == 1:
            return y_partial
        d, D = self._dim(y_partial, seq_dim), self.lead
        if (self.pcfg.sequence_parallel
                and y_partial.shape[d] % self.tp == 0):
            y = y_partial.movedim(d, D)
            lead = self._lead_shape(y)
            shard = self.engine.reduce_scatter(y.reshape(lead + (-1,)),
                                               self.tp_axis)
            y = shard.reshape(lead + (y.shape[D] // self.tp,)
                              + tuple(y.shape[D + 1:]))
            return y.movedim(D, d)
        return self.engine.allreduce(y_partial, self.tp_axis)

    def sp_allgather_seq(self, x, seq_dim: int = 1):
        """SP prologue: re-gather sequence-sharded activations over TP."""
        if self.tp == 1 or not self.pcfg.sequence_parallel:
            return x
        d, D = self._dim(x, seq_dim), self.lead
        y = x.movedim(d, D)
        flat = self.engine.allgather(y, self.tp_axis)
        y = flat.reshape(self._lead_shape(y) + (self.tp * y.shape[D],)
                         + tuple(y.shape[D + 1:]))
        return y.movedim(D, d)

    def dense(self, x, w, fsdp_dim: int = 0):
        """x @ gather(w); the workhorse projection."""
        w = self.gather_fsdp(w, fsdp_dim)
        return local_matmul(x, w.to(x.dtype), self.lead)

    def col_parallel_matmul(self, x, w, fsdp_dim: int = 0, seq_dim: int = 1,
                            pregathered: bool = False):
        """Column-parallel projection. Under SP + collective_matmul, the
        sequence all-gather is fused with the matmul (streaming
        collective, paper Listing 2); otherwise gather-then-matmul.
        `pregathered` skips the FSDP gather (fused multi-projection
        weights)."""
        if not pregathered:
            w = self.gather_fsdp(w, fsdp_dim)
        D = self.lead
        if (self.pcfg.sequence_parallel and self.pcfg.collective_matmul
                and self.tp > 1):
            lead = self._lead_shape(x)
            d = self._dim(x, seq_dim)
            b = x.shape[D]
            xt = x.movedim(d, D + 1) if d != D + 1 else x
            s_l, width = xt.shape[D + 1], xt.shape[-1]
            x2 = xt.reshape(lead + (b * s_l, width))
            y2 = self.engine.allgather_matmul(x2, w.to(x.dtype),
                                              self.tp_axis)
            y = y2.reshape(lead + (self.tp, b, s_l, -1)).transpose(D, D + 1)
            y = y.reshape(lead + (b, self.tp * s_l, -1))
            return y.movedim(D + 1, d) if d != D + 1 else y
        x = self.sp_allgather_seq(x, seq_dim)
        return local_matmul(x, w.to(x.dtype), D)


def spec_axes(spec) -> set:
    """Mesh axes appearing anywhere in a spec's entries."""
    axes = set()
    for entry in spec:
        if entry is None:
            continue
        if isinstance(entry, (tuple, list)):
            axes.update(entry)
        else:
            axes.add(entry)
    return axes
