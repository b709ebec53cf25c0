"""Distributed DLRM inference — the paper's §6 use case, ranks stacked on
one device.

Port of `repro/models/dlrm.py`. Paper design (Fig. 15): embedding tables
distributed over nodes 1-4, FC1 checkerboard-decomposed over 8 nodes,
FC2/FC3 pipelined on nodes 9/10, all communication through ACCL+
streaming collectives. The mapping over the (pod, data, model) mesh is
the reference's:
  * tables shard over 'model' on rows — each rank holds a table slice and
    serves lookups for its rows (K5, one launch for every table of every
    rank), then one engine allreduce (K1 combines) assembles the concat
    vector;
  * FC1 is checkerboard (row + column) decomposed: each rank consumes its
    slice of the concat vector and the partial products reduce through
    the engine — `matmul_reduce_scatter` (K4 + a ring of adds) under
    `collective_matmul`, else a plain product + allreduce;
  * FC2/FC3 column-parallel (plain products, allgathered), the head
    replicated; requests batch along ('pod', 'data'). Each rank's plain
    product is its own 2-D product (`rank_matmul`), stacked or not.
The reference's argument for sharding — 50 GB of embeddings exceed one
chip's 16 GB HBM — does not hold on one 80 GB H100, which holds the
whole stacked table set; the port keeps the reference's decomposition,
which is what the paper measures.

Every tensor is MESH-STACKED (`convert.py`): leading dims the mesh axes
in mesh order, trailing dims one rank's local array. On an engine of one
process (`core/procgroup.py`, `ParCtx.local`) the same functions take
that process's LOCAL shards, the reference's per-device form: K5 looks
up its own table slice (G = 1, `lo` its own first row), FC1's
`matmul_reduce_scatter` launches K4 once on its own rows, and every
collective crosses processes. `local_batch` / `gather_batch` are
`stack_batch` / `unstack_batch` for one process. The reference's
`use_pallas` switches are gone: on the card K4 and K5 always run, on the
CPU their plain versions (`kernels/ops.py`).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.dlrm import DLRMConfig
from repro_torch.core import telemetry
from repro_torch.kernels import ops as kops
from repro_torch.models.common import Builder
from repro_torch.parallel.ops import ParCtx


def dlrm_params(b: Builder, cfg: DLRMConfig, tp: int):
    """Tables stacked (T, rows, dim) sharded over model on rows."""
    rows = ((cfg.rows_per_table + tp - 1) // tp) * tp
    concat = cfg.n_tables * cfg.emb_dim
    p = {
        "tables": b.param((cfg.n_tables, rows, cfg.emb_dim),
                          (None, "model", None), scale=0.01),
        "fc": [],
    }
    dims = (concat,) + tuple(cfg.fc_dims) + (cfg.out_dim,)
    fcs = []
    last = len(dims) - 2
    for i in range(len(dims) - 1):
        # FC1 checkerboard: in-dim over model (row partition of the concat
        # vector); middle FCs column-parallel; the tiny head replicates.
        if i == 0:
            spec = ("model", None)
        elif i < last:
            spec = (None, "model")
        else:
            spec = (None, None)
        fcs.append({
            "w": b.param((dims[i], dims[i + 1]), spec),
            "b": b.param((dims[i + 1],), (None,), init="zeros"),
        })
    p["fc"] = fcs
    return p


def dlrm_specs(cfg: DLRMConfig, tp: int):
    return dlrm_params(Builder("spec"), cfg, tp)


def lookup_operands(tables, ctx: ParCtx):
    """K5's view of the stacked tables: every rank's (T, rows_local, dim)
    slice as one (G, T, rows_local, dim) stack over the G = prod(mesh)
    stacked ranks, and `lo` (G,), each one's first global row (on local
    shards G = 1 and `lo` the process's own first row)."""
    lead = tuple(tables.shape[:ctx.lead])
    rows_l = tables.shape[-2]
    G = math.prod(lead)
    lo = (ctx.tp_rank() * rows_l).expand(lead).reshape(G)
    return tables.reshape((G,) + tuple(tables.shape[ctx.lead:])), lo


def embedding_lookup(tables, indices, ctx: ParCtx):
    """tables: stacked (T, rows_local, dim), each rank's slice over
    'model'; indices: stacked (B, T) global row ids. Returns the stacked
    (B, T*dim) concat vector, replicated over 'model'.

    Each rank serves the rows it owns (a partial vector, zero where
    another rank owns the row: one K5 launch for every table of every
    rank writes them straight into the concat layout), then one engine
    allreduce assembles the concat vector — the paper's
    partial-embedding transmission from memory nodes to compute nodes.
    """
    lead = tuple(tables.shape[:ctx.lead])
    stacked, lo = lookup_operands(tables, ctx)
    G, t, _rows_l, dim = stacked.shape
    B = indices.shape[-2]
    vec = kops.embedding_lookup_rows(
        stacked, indices.to(torch.int32).reshape((G, B, t)), lo)
    vec = vec.reshape(lead + (B, t * dim))
    if ctx.tp > 1:
        vec = ctx.engine.allreduce(vec, ctx.tp_axis)
    return vec


def rank_matmul(x, w, lead: int):
    """Each rank's `x @ w` as its own 2-D product of contiguous operands:
    x stacked (*mesh, B, K), w stacked (*mesh, K, N), `lead` mesh dims
    (0 on local shards). One product per rank, so that a rank's result
    is the same bits whether its rows are stacked with the others' or
    alone in its process: a batched product may sum in another order
    than the unbatched one (the CPU's gemv for N = 1; a BLAS heuristic
    that weighs the batch count)."""
    if lead == 0:
        return torch.mm(x.contiguous(), w.contiguous())
    xs = x.reshape((-1,) + tuple(x.shape[lead:]))
    ws = w.reshape((-1,) + tuple(w.shape[lead:]))
    out = torch.empty((xs.shape[0], xs.shape[1], ws.shape[2]),
                      dtype=x.dtype, device=x.device)
    for a, b, o in zip(xs, ws, out):
        torch.mm(a.contiguous(), b.contiguous(), out=o)
    return out.reshape(tuple(x.shape[:lead]) + tuple(out.shape[1:]))


def dlrm_forward(params, indices, ctx: ParCtx):
    """indices: stacked (B_local, T) -> stacked (B_local, out_dim)
    click-through logits, replicated over 'model'. While the wall-clock
    recorder records, the lookup is a `dlrm.lookup` span, the
    checkerboard FC1 a `dlrm.fc1` span and every other layer a `dlrm.fc`
    span; the engine's spans nest inside them."""
    tr = telemetry.wall()
    with tr.span("dlrm.lookup", track="dlrm"):
        vec = embedding_lookup(params["tables"], indices, ctx)
    tp, D = ctx.tp, ctx.lead
    x = vec
    n = len(params["fc"])
    for i, fc in enumerate(params["fc"]):
        w, bias = fc["w"], fc["b"]
        fc1 = i == 0 and tp > 1
        with tr.span("dlrm.fc1" if fc1 else "dlrm.fc", track="dlrm",
                     layer=i):
            if fc1:
                # checkerboard FC1: row-partitioned input slice x column
                # slice
                x_slice = ctx.tp_slice(x, w.shape[-2], dim=-1)
                if ctx.pcfg.collective_matmul:
                    y = ctx.engine.matmul_reduce_scatter(x_slice, w,
                                                         ctx.tp_axis)
                    y = ctx.engine.allgather(y, ctx.tp_axis).reshape(
                        tuple(x.shape[:-1]) + (-1,))
                else:
                    y = rank_matmul(x_slice, w, D)
                    y = ctx.engine.allreduce(y, ctx.tp_axis)
            else:
                y = rank_matmul(x, w, D)
                if tp > 1 and 0 < i < n - 1:
                    # column-parallel: out-dim sharded; gather for next
                    # layer
                    y = ctx.engine.allgather(y.transpose(-1, -2),
                                             ctx.tp_axis)
                    y = y.reshape(tuple(x.shape[:-2]) + (-1, x.shape[-2])
                                  ).transpose(-1, -2)
            y = y + bias.unsqueeze(-2)
            x = torch.relu(y) if i < n - 1 else y
    return x


class DLRM(torch.nn.Module):
    """The distributed DLRM: its buffers are the stacked params and
    `forward(indices)` is `dlrm_forward` on stacked (B_local, T) ids."""

    def __init__(self, params, ctx: ParCtx):
        super().__init__()
        self.ctx = ctx
        self.n_fc = len(params["fc"])
        self.register_buffer("tables", params["tables"])
        for i, fc in enumerate(params["fc"]):
            self.register_buffer(f"fc{i}_w", fc["w"])
            self.register_buffer(f"fc{i}_b", fc["b"])

    def params(self) -> dict:
        return {"tables": self.tables,
                "fc": [{"w": getattr(self, f"fc{i}_w"),
                        "b": getattr(self, f"fc{i}_b")}
                       for i in range(self.n_fc)]}

    def forward(self, indices):
        return dlrm_forward(self.params(), indices, self.ctx)


# --------------------------------------------------------------------------
# Single-copy oracle
# --------------------------------------------------------------------------

def lookup_global(tables, indices):
    """Global tables (T, rows, dim), ids (B, T) -> (B, T*dim) concat
    vector by direct indexing."""
    t = torch.arange(tables.shape[0], device=tables.device)
    rows = tables[t, indices.long()]                     # (B, T, dim)
    return rows.reshape(indices.shape[0], -1)


def lookup_shards(shards, indices):
    """The same from the 'model' shards of ONE copy of the tables,
    (M, T, rows_local, dim) — rank m holds global rows
    [m * rows_local, (m + 1) * rows_local) — without assembling them."""
    rows_l = shards.shape[2]
    ids = indices.long()
    t = torch.arange(shards.shape[1], device=shards.device)
    rows = shards[ids // rows_l, t, ids % rows_l]        # (B, T, dim)
    return rows.reshape(indices.shape[0], -1)


def mlp_reference(fcs, x):
    """The FC stack on one device: x @ w + b, ReLU between layers."""
    n = len(fcs)
    for i, fc in enumerate(fcs):
        x = x @ fc["w"] + fc["b"]
        if i < n - 1:
            x = torch.relu(x)
    return x


def dlrm_reference(params_full, indices):
    """Single-device oracle on gathered (global) params."""
    return mlp_reference(params_full["fc"],
                         lookup_global(params_full["tables"], indices))


def stack_batch(x, mesh_shape: dict, batch_axes=("pod", "data")):
    """A global batch (B, ...) -> its mesh-stacked shards (the
    reference's `P(batch_axes, None)`): B splits over `batch_axes`, the
    first the major one, and is replicated over the other axes (a view,
    no copy)."""
    names = list(mesh_shape)
    axes = [a for a in batch_axes if a in mesh_shape]
    sizes = tuple(mesh_shape[a] for a in axes)
    n = math.prod(sizes)
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} does not split over {axes}")
    rest = tuple(x.shape[1:])
    y = x.reshape(sizes + (x.shape[0] // n,) + rest)
    order = sorted(range(len(axes)), key=lambda i: names.index(axes[i]))
    y = y.permute(order + list(range(len(axes), y.ndim)))
    y = y.reshape(tuple(mesh_shape[a] if a in axes else 1 for a in names)
                  + tuple(y.shape[len(axes):]))
    return y.expand(tuple(mesh_shape.values()) + tuple(y.shape[len(names):]))


def unstack_batch(y, mesh_shape: dict, batch_axes=("pod", "data")):
    """Inverse of `stack_batch`: the global batch from the first copy
    over the axes the batch is replicated on."""
    names = list(mesh_shape)
    axes = [a for a in batch_axes if a in mesh_shape]
    y = y[tuple(slice(None) if a in axes else 0 for a in names)]
    order = [sorted(axes, key=names.index).index(a) for a in axes]
    y = y.permute(order + list(range(len(axes), y.ndim)))
    return y.reshape((-1,) + tuple(y.shape[len(axes) + 1:]))


# --------------------------------------------------------------------------
# One process's batch
# --------------------------------------------------------------------------

def local_batch(x, mesh_shape: dict, coords: dict,
                batch_axes=("pod", "data")):
    """`stack_batch` for one process: its own slice of a global batch (a
    view; the whole batch on a mesh whose batch axes are all 1) — its
    shard over `batch_axes` at mesh position `coords`, the first axis
    the major one."""
    axes = [a for a in batch_axes if a in mesh_shape]
    n = math.prod(mesh_shape[a] for a in axes)
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} does not split over {axes}")
    i = 0
    for a in axes:
        i = i * mesh_shape[a] + coords[a]
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


def gather_batch(y, engine, batch_axes=("pod", "data")):
    """`unstack_batch` for one process: the global batch from every
    process's slice, through the engine's allgather over each batch axis
    larger than 1, the minor one first (no collective where there is
    none)."""
    axes = [a for a in batch_axes if engine.mesh_shape.get(a, 1) > 1]
    for a in reversed(axes):
        y = engine.allgather(y, a).reshape((-1,) + tuple(y.shape[1:]))
    return y
