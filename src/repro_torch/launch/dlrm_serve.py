"""Paper use case 2 (Fig. 17): distributed DLRM inference serving.

Port of `examples/dlrm_serve.py`. Embedding tables shard over the model
axis, FC1 is checkerboard-decomposed, partial embedding vectors and FC1
partial products travel through the collective engine. `DLRMServer`
holds the model and answers batches of requests, either with every rank
stacked on one device or, on a `ProcessGroupEngine`, one rank per
process (each process holds its own table slice, as each node of the
paper's deployment does). The CLI serves seeded random requests and
reports latency and throughput against the single-copy reference:

    python -m repro_torch.launch.dlrm_serve [--batches 20] [--batch-size 32]
        [--tables 100] [--rows 4000000] [--device cuda] [--seed 0]
        [--procs N] [--backend microcode|native]

With `--procs N` it spawns N processes, one rank each, on a gloo group
over the (1, 1, N) mesh (under `torchrun` it joins the world torchrun
started instead); every process serves the same seeded request stream
and rank 0 prints. `--backend native` runs the collectives as
`torch.distributed`'s own (the software-MPI baseline the paper compares
against) instead of the engine's programs. It runs on the card unless
`--device cpu` is given, and raises on a machine without one. The full
configuration (100 tables x 4,000,000 rows x 32 fp32, 51.2 GB) needs an
80 GB card; pass fewer `--rows` on the CPU.
"""
from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch

from repro_torch.configs.base import ParallelConfig
from repro_torch.configs.dlrm import CONFIG, DLRMConfig
from repro_torch.convert import unstack
from repro_torch.core import CollectiveEngine, telemetry
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.models.common import Builder
from repro_torch.parallel.ops import ParCtx

DEFAULT_MESH = {"pod": 1, "data": 1, "model": 8}


class DLRMServer:
    """The distributed DLRM, params drawn on `device` from `seed`.

    `serve(indices)` takes a batch of requests, (B, T) int global row
    ids, and returns (B, out_dim) logits; B must split over the batch
    axes and then into `model`-many row chunks (FC1's reduce-scatter).
    An id outside [0, rows_per_table) hits no rank's shard and looks up
    a zero row, as in the reference.

    Given an `engine` of one process (`core/procgroup.py`), the server
    is that process's rank: its params are its local shards — drawn on
    its device from `seed` by the per-process `Builder`, or `params`
    when given (`convert.local_params` of a stacked server's) — and
    `serve` takes the same global batch on every process, serves the
    process's own slice (`dlrm_mod.local_batch`) and returns the global
    logits (`gather_batch`). `reference` then gathers the FC shards and
    each rank's own rows OUTSIDE the engine (`torch.distributed`'s
    default group), so it does not share the path it checks.
    """

    def __init__(self, cfg: DLRMConfig = CONFIG, mesh_shape=None,
                 device="cuda", pcfg: ParallelConfig = None, seed: int = 0,
                 engine=None, params=None):
        self.cfg = cfg
        self.pcfg = pcfg or ParallelConfig(collective_matmul=True)
        if engine is None:
            engine = CollectiveEngine(dict(mesh_shape or DEFAULT_MESH),
                                      backend=self.pcfg.backend,
                                      device=device)  # raises without a card
        self.mesh_shape = dict(engine.mesh_shape)
        self.device = engine.device
        self.ctx = ParCtx(engine=engine, pcfg=self.pcfg)
        self.local = self.ctx.local
        if params is None:
            if self.local:
                b = Builder("init", mesh_shape=self.mesh_shape,
                            device=self.device, coords=engine.coords,
                            seed=seed)
            else:
                gen = torch.Generator(device=self.device).manual_seed(seed)
                b = Builder("init", generator=gen,
                            mesh_shape=self.mesh_shape, device=self.device)
            params = dlrm_mod.dlrm_params(b, cfg, self.ctx.tp)
        self.model = dlrm_mod.DLRM(params, self.ctx)
        self.specs = dlrm_mod.dlrm_specs(cfg, self.ctx.tp)
        self._global_fc: dict = {}

    @property
    def engine(self):
        return self.ctx.engine

    def _stack(self, indices):
        idx = torch.as_tensor(indices, device=self.device)
        if (idx.ndim != 2 or idx.shape[1] != self.cfg.n_tables
                or idx.is_floating_point() or idx.is_complex()):
            raise ValueError(f"requests must be (B, {self.cfg.n_tables}) "
                             f"integer row ids, got {tuple(idx.shape)} "
                             f"{idx.dtype}")
        if self.local:
            return dlrm_mod.local_batch(idx.to(torch.int32), self.mesh_shape,
                                        self.engine.coords,
                                        self.pcfg.dp_axes)
        return dlrm_mod.stack_batch(idx.to(torch.int32), self.mesh_shape,
                                    self.pcfg.dp_axes)

    def _unstack(self, y):
        if self.local:
            return dlrm_mod.gather_batch(y, self.engine, self.pcfg.dp_axes)
        return dlrm_mod.unstack_batch(y, self.mesh_shape, self.pcfg.dp_axes)

    @torch.inference_mode()
    def serve(self, indices):
        """(B, T) global row ids -> (B, out_dim) logits. While the
        wall-clock recorder records, the batch is a root span
        `dlrm.serve` (its spans share one call id) over `dlrm.ids_in`,
        the model's spans (`dlrm_forward`) and `dlrm.unstack`."""
        tr = telemetry.wall()
        with tr.span("dlrm.serve", track="dlrm", batch=len(indices)):
            with tr.span("dlrm.ids_in", track="dlrm"):
                idx = self._stack(indices)
            y = self.model(idx)
            with tr.span("dlrm.unstack", track="dlrm"):
                return self._unstack(y)

    __call__ = serve

    @torch.inference_mode()
    def lookup(self, indices):
        """The distributed path's concat vector, (B, T * emb_dim)."""
        return self._unstack(dlrm_mod.embedding_lookup(
            self.model.tables, self._stack(indices), self.ctx))

    def tables_copy(self):
        """The 'model' shards of one copy of the tables,
        (M, T, rows_local, dim) — a view, the tables are not copied
        (ranks stacked only)."""
        names = list(self.mesh_shape)
        t = self.model.tables.movedim(names.index(self.pcfg.tp_axis), 0)
        return t[(slice(None),) + (0,) * (len(names) - 1)]

    @torch.inference_mode()
    def own_rows(self, indices):
        """One process's slots of the concat vector of a global batch, by
        direct indexing of its own table slice: (B, T * emb_dim), +0.0
        where another rank (or none) holds the row."""
        idx = torch.as_tensor(indices, device=self.device).long()
        tables = self.model.tables
        rows_l = tables.shape[-2]
        local = idx - self.ctx.own_tp_rank() * rows_l
        hit = (local >= 0) & (local < rows_l)
        t = torch.arange(tables.shape[0], device=self.device)
        rows = tables[t, local.clamp(0, rows_l - 1)]          # (B, T, dim)
        rows = torch.where(hit[..., None], rows, torch.zeros_like(rows))
        return rows.reshape(idx.shape[0], -1)

    def global_fc(self, dtype=None):
        """The FC stack's weights and biases as global tensors in `dtype`
        (default the params'), assembled once (one rank per process:
        every process's shards gathered outside the engine)."""
        dtype = dtype or self.model.fc0_w.dtype
        if dtype not in self._global_fc:
            fcs = self.model.params()["fc"]
            self._global_fc[dtype] = [
                {k: unstack(self._stacked(fc[k]), self.mesh_shape,
                            sp[k]).to(self.device, dtype)
                 for k in ("w", "b")}
                for fc, sp in zip(fcs, self.specs["fc"])]
        return self._global_fc[dtype]

    def _stacked(self, t):
        """A param as a mesh-stacked tensor: itself, or (one rank per
        process) every process's shard, gathered on the host."""
        if not self.local:
            return t
        got = _host_gather(t)
        return torch.stack(got).reshape(
            tuple(self.mesh_shape.values()) + tuple(t.shape))

    @torch.inference_mode()
    def reference(self, indices, dtype=None):
        """`dlrm_reference` on one copy of the params: lookups by direct
        indexing of the tables' shards, the FC stack whole on one device
        (in `dtype`, default the params')."""
        idx = torch.as_tensor(indices, device=self.device)
        if self.local:
            vec = self.assembled_rows(idx)
        else:
            vec = dlrm_mod.lookup_shards(self.tables_copy(), idx)
        if dtype is not None:
            vec = vec.to(dtype)
        return dlrm_mod.mlp_reference(self.global_fc(dtype), vec)

    @torch.inference_mode()
    def assembled_rows(self, indices):
        """One rank per process: the concat vector of a global batch from
        every rank's `own_rows`, gathered outside the engine, each slot
        taken from the rank that holds its row (+0.0 where none does)."""
        idx = torch.as_tensor(indices, device=self.device).long()
        own = torch.stack(_host_gather(self.own_rows(idx))).to(self.device)
        rows_l = self.model.tables.shape[-2]
        tp = self.ctx.tp
        owner = torch.div(idx, rows_l, rounding_mode="floor")
        held = (owner >= 0) & (owner < tp)
        owner = owner.clamp(0, tp - 1)
        dim = self.cfg.emb_dim
        # the global rank of each 'model' rank in this process's group
        ranks = torch.as_tensor(
            [self.engine._global(self.engine._position(self.pcfg.tp_axis,
                                                       r))
             for r in range(tp)], device=self.device)
        src = ranks[owner].repeat_interleave(dim, dim=1)      # (B, T*dim)
        vec = own.gather(0, src[None]).squeeze(0)
        return torch.where(held.repeat_interleave(dim, dim=1), vec,
                           torch.zeros_like(vec))


def _host_gather(t) -> list:
    """Every process's `t`, on the host, in global-rank order: one
    `all_gather_object` on the default group, outside the engine."""
    import torch.distributed as dist
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, t.detach().cpu())
    return got


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _config(args) -> DLRMConfig:
    return DLRMConfig(n_tables=args.tables, emb_dim=32,
                      rows_per_table=args.rows, fc_dims=(2048, 512, 256))


def _report(server, args, root: bool) -> None:
    """Serve the seeded batches: the first checked against the reference,
    then latency and throughput of the distributed path against the
    single-copy reference, printed where `root`."""
    emb_gb = args.tables * args.rows * server.cfg.emb_dim * 4 / 1e9
    where = (f"one rank per process, {args.backend} backend"
             if server.local else "ranks stacked")
    if root:
        print(f"tables: {args.tables} x {args.rows} rows ({emb_gb:.2f} GB "
              f"embeddings, sharded {server.ctx.tp}-way, {where} on "
              f"{server.device})", flush=True)
    rng = np.random.default_rng(args.seed)
    reqs = [torch.as_tensor(rng.integers(0, args.rows,
                                         (args.batch_size, args.tables)),
                            dtype=torch.int32, device=server.device)
            for _ in range(args.batches)]
    # warm-up + correctness
    out = server.serve(reqs[0])
    want = server.reference(reqs[0])
    err = float((out - want).abs().max())
    if not math.isfinite(err) or err > 1e-2 + 1e-2 * float(want.abs().max()):
        raise SystemExit(f"dlrm_serve: served logits differ from the "
                         f"reference by {err}")

    # one rank per process the reference gathers on the host: not timed
    runs = (("distributed", server.serve),) + (
        () if server.local else (("single_node", server.reference),))
    for name, fn in runs:
        fn(reqs[0])
        _sync(server.device)
        t0 = time.perf_counter()
        for r in reqs:
            out = fn(r)
        _sync(server.device)
        dt = time.perf_counter() - t0
        lat = dt / args.batches * 1e3
        tput = args.batches * args.batch_size / dt
        if root:
            print(f"{name:12s} latency {lat:7.2f} ms/batch   "
                  f"throughput {tput:9.0f} q/s", flush=True)


def run_process(rank: int, world: int, args) -> None:
    """One rank of use case 2 one rank per process: its own table slice
    and FC shards on the (1, 1, world) mesh; rank 0 prints."""
    from repro_torch.core.procgroup import ProcessGroupEngine
    pcfg = ParallelConfig(collective_matmul=True, backend=args.backend)
    engine = ProcessGroupEngine({"pod": 1, "data": 1, "model": world},
                                backend=args.backend,
                                device="cpu" if args.device == "cpu"
                                else None)
    server = DLRMServer(_config(args), pcfg=pcfg, seed=args.seed,
                        engine=engine)
    _report(server, args, root=rank == 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--tables", type=int, default=CONFIG.n_tables)
    ap.add_argument("--rows", type=int, default=CONFIG.rows_per_table)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--procs", type=int, default=None,
                    help="run one rank per process, N processes")
    ap.add_argument("--backend", default="microcode",
                    choices=("microcode", "native"))
    args = ap.parse_args(argv)

    from repro_torch.launch import procs
    if args.procs:
        procs.spawn(run_process, args.procs, backend="gloo",
                    device=args.device, args=(args,))
        return 0
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world, _local = procs.init_from_env("gloo", args.device)
        try:
            run_process(rank, world, args)
        finally:
            torch.distributed.destroy_process_group()
        return 0
    server = DLRMServer(_config(args), device=args.device, seed=args.seed,
                        pcfg=ParallelConfig(collective_matmul=True,
                                            backend=args.backend))
    _report(server, args, root=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
