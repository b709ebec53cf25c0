"""Paper use case 2 (Fig. 17): distributed DLRM inference serving.

Port of `examples/dlrm_serve.py`. Embedding tables shard over the model
axis, FC1 is checkerboard-decomposed, partial embedding vectors and FC1
partial products travel through the collective engine — every rank
stacked on one device. `DLRMServer` holds the model and answers batches
of requests; the CLI serves seeded random requests and reports latency
and throughput against the single-copy reference:

    python -m repro_torch.launch.dlrm_serve [--batches 20] [--batch-size 32]
        [--tables 100] [--rows 4000000] [--device cuda] [--seed 0]

It runs on the card unless `--device cpu` is given, and raises on a
machine without one. The full configuration (100 tables x 4,000,000
rows x 32 fp32, 51.2 GB) needs an 80 GB card; pass fewer `--rows` on
the CPU.
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from repro_torch.configs.base import ParallelConfig
from repro_torch.configs.dlrm import CONFIG, DLRMConfig
from repro_torch.convert import unstack
from repro_torch.core import CollectiveEngine
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
    """

    def __init__(self, cfg: DLRMConfig = CONFIG, mesh_shape=None,
                 device="cuda", pcfg: ParallelConfig = None, seed: int = 0):
        self.cfg = cfg
        self.mesh_shape = dict(mesh_shape or DEFAULT_MESH)
        self.pcfg = pcfg or ParallelConfig(collective_matmul=True)
        engine = CollectiveEngine(self.mesh_shape, backend=self.pcfg.backend,
                                  device=device)   # raises without a card
        self.device = engine.device
        self.ctx = ParCtx(engine=engine, pcfg=self.pcfg)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        b = Builder("init", generator=gen, mesh_shape=self.mesh_shape,
                    device=self.device)
        self.model = dlrm_mod.DLRM(dlrm_mod.dlrm_params(b, cfg, self.ctx.tp),
                                   self.ctx)
        self.specs = dlrm_mod.dlrm_specs(cfg, self.ctx.tp)
        self._global_fc: dict = {}

    def _stack(self, indices):
        idx = torch.as_tensor(indices, device=self.device)
        if (idx.ndim != 2 or idx.shape[1] != self.cfg.n_tables
                or idx.is_floating_point() or idx.is_complex()):
            raise ValueError(f"requests must be (B, {self.cfg.n_tables}) "
                             f"integer row ids, got {tuple(idx.shape)} "
                             f"{idx.dtype}")
        return dlrm_mod.stack_batch(idx.to(torch.int32), self.mesh_shape,
                                    self.pcfg.dp_axes)

    def _unstack(self, y):
        return dlrm_mod.unstack_batch(y, self.mesh_shape, self.pcfg.dp_axes)

    @torch.inference_mode()
    def serve(self, indices):
        """(B, T) global row ids -> (B, out_dim) logits."""
        return self._unstack(self.model(self._stack(indices)))

    __call__ = serve

    @torch.inference_mode()
    def lookup(self, indices):
        """The distributed path's concat vector, (B, T * emb_dim)."""
        return self._unstack(dlrm_mod.embedding_lookup(
            self.model.tables, self._stack(indices), self.ctx))

    def tables_copy(self):
        """The 'model' shards of one copy of the tables,
        (M, T, rows_local, dim) — a view, the tables are not copied."""
        names = list(self.mesh_shape)
        t = self.model.tables.movedim(names.index(self.pcfg.tp_axis), 0)
        return t[(slice(None),) + (0,) * (len(names) - 1)]

    def global_fc(self, dtype=None):
        """The FC stack's weights and biases as global tensors in `dtype`
        (default the params'), assembled once."""
        dtype = dtype or self.model.fc0_w.dtype
        if dtype not in self._global_fc:
            fcs = self.model.params()["fc"]
            self._global_fc[dtype] = [
                {k: unstack(fc[k], self.mesh_shape, sp[k]).to(dtype)
                 for k in ("w", "b")}
                for fc, sp in zip(fcs, self.specs["fc"])]
        return self._global_fc[dtype]

    @torch.inference_mode()
    def reference(self, indices, dtype=None):
        """`dlrm_reference` on one copy of the params: lookups by direct
        indexing of the tables' shards, the FC stack whole on one device
        (in `dtype`, default the params')."""
        idx = torch.as_tensor(indices, device=self.device)
        vec = dlrm_mod.lookup_shards(self.tables_copy(), idx)
        if dtype is not None:
            vec = vec.to(dtype)
        return dlrm_mod.mlp_reference(self.global_fc(dtype), vec)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--tables", type=int, default=CONFIG.n_tables)
    ap.add_argument("--rows", type=int, default=CONFIG.rows_per_table)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = DLRMConfig(n_tables=args.tables, emb_dim=32,
                     rows_per_table=args.rows, fc_dims=(2048, 512, 256))
    server = DLRMServer(cfg, device=args.device, seed=args.seed)
    emb_gb = args.tables * args.rows * cfg.emb_dim * 4 / 1e9
    print(f"tables: {args.tables} x {args.rows} rows ({emb_gb:.2f} GB "
          f"embeddings, sharded {server.ctx.tp}-way, ranks stacked on "
          f"{server.device})")

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

    for name, fn in (("distributed", server.serve),
                     ("single_node", server.reference)):
        fn(reqs[0])
        _sync(server.device)
        t0 = time.perf_counter()
        for r in reqs:
            out = fn(r)
        _sync(server.device)
        dt = time.perf_counter() - t0
        lat = dt / args.batches * 1e3
        tput = args.batches * args.batch_size / dt
        print(f"{name:12s} latency {lat:7.2f} ms/batch   "
              f"throughput {tput:9.0f} q/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
