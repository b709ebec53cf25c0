"""Paper use case 1 (Fig. 16) as the offload demo: distributed
vector-matrix multiply through the engine's request queue.

Port of `examples/distributed_vecmat.py`. The weight matrix is
row-partitioned over the ranks of axis "x" — stacked on one device, rank
r holding row block r of `w` and the matching slice of `x` — and the
caller tiles the output: each tile's partial products are ISSUED as a
non-blocking binomial-tree `reduce` (every RECV_COMBINE runs K1), and the
tiles are materialized at the end in FIFO order. `Sequencer.makespan`
prices the queue of tile reductions on the paper's cluster
(`ACCL_CLUSTER`) against the serial sum of blocking `Program.cost`s.

    python -m repro_torch.launch.distributed_vecmat
        [--sizes 512,1024,2048,4096] [--tiles 4] [--reps 20]
        [--device cuda] [--seed 0] [--procs N]

It runs on the card unless `--device cpu` is given, and raises on a
machine without one. Ranks stacked (the default), all ranks' partial
products run as one batched `torch.matmul`, so `measured_x` compares one
device against itself: it is not an 8-rank cluster's speedup. With
`--procs N` (or under `torchrun`, which sets RANK and WORLD_SIZE) each
of N processes holds one rank (`core/procgroup.py`), computes its own
partial product and reduces it to rank 0 over a gloo process group,
as the example does; rank 0 prints the same CSV. The model
columns are the cluster prediction, as in the example.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from repro_torch.core import CollectiveEngine, Communicator
from repro_torch.core.hw_spec import ACCL_CLUSTER
from repro_torch.core.sequencer import Sequencer
from repro_torch.launch import median_ms

TILES = 4          # output tiles in flight
SIZES = (512, 1024, 2048, 4096)
NRANKS = 8
#: the example's single-copy compute model: 2 * size^2 flops at 50 GFLOP/s
MODEL_FLOPS_PER_S = 50e9


def distributed_vecmat(engine, xs, ws, tiles: int = TILES):
    """y = x @ w with w's rows split over axis "x" of `engine`.

    xs: (n, size/n), rank r's slice of x; ws: (n, size/n, size), rank r's
    row block of w. Each output tile's partial products — every rank's
    at once, one batched `torch.matmul` — are issued as a non-blocking
    `ireduce` to root 0; then the tiles are waited in FIFO order and
    root 0's rows concatenated. Returns y, (size,).

    On a per-process engine (`core/procgroup.py`) xs and ws are this
    process's own slice and row block, (size/n,) and (size/n, size), and
    y is meaningful on rank 0 only."""
    size = ws.shape[-1]
    if size % tiles:
        raise ValueError(f"size {size} does not split into {tiles} tiles")
    tile = size // tiles
    reqs = []
    for t in range(tiles):
        partial = torch.matmul(xs.unsqueeze(-2),
                               ws[..., t * tile:(t + 1) * tile]).squeeze(-2)
        reqs.append(engine.ireduce(partial, "x", algorithm="binomial_tree"))
    # root 0's rows of a stacked result; a per-process result as it is
    root = (0,) * len(engine.stack_shape)
    return torch.cat([r.wait()[root] for r in reqs])


def queue_model(engine, size: int, tiles: int = TILES) -> dict:
    """The queue-level model on the paper's cluster: the SAME request
    pattern (one binomial-tree reduce per tile) priced by a fresh
    `Sequencer` of `engine`, without executing anything, against the
    example's single-copy compute model."""
    n = engine.mesh_shape["x"]
    comm = Communicator(axis="x", size=n, hw=ACCL_CLUSTER)
    seq = Sequencer(engine)
    shape = engine.stack_shape + (size // tiles,)
    for _ in range(tiles):
        seq.issue("reduce", torch.zeros(shape, device="meta"),
                  "x", algorithm="binomial_tree")
    t_queue = seq.makespan("x", comm=comm)
    t_serial = seq.serial_cost("x", comm=comm)
    t_single = 2 * size * size / MODEL_FLOPS_PER_S
    return {"t_queue_s": t_queue, "t_serial_s": t_serial,
            "model_blocking_x": t_single / (t_single / n + t_serial),
            "model_offload_x": t_single / (t_single / n + t_queue),
            "overlap_x": t_serial / t_queue}


def _report(engine, args, operands, root: bool) -> None:
    """Run and time `distributed_vecmat` at every size; `operands(x, w)`
    gives this engine's (xs, ws); the root prints the CSV rows."""
    dev = engine.device
    rng = np.random.default_rng(args.seed)
    if root:
        print("size,single_us,dist_us,measured_x,model_blocking_x,"
              "model_offload_x,overlap_x", flush=True)
    for size in map(int, args.sizes.split(",")):
        w = torch.as_tensor(rng.normal(size=(size, size)),
                            dtype=torch.float32, device=dev)
        x = torch.as_tensor(rng.normal(size=(size,)), dtype=torch.float32,
                            device=dev)
        xs, ws = operands(x, w)
        y = distributed_vecmat(engine, xs, ws, args.tiles)
        us_dist = 1e3 * median_ms(
            lambda: distributed_vecmat(engine, xs, ws, args.tiles),
            args.reps, dev)
        if not root:
            continue
        err = float((y.double() - x.double() @ w.double()).abs().max())
        if not err < 1e-2:
            raise SystemExit(f"distributed_vecmat: size {size} differs "
                             f"from x @ w by {err}")
        us_single = 1e3 * median_ms(lambda: x @ w, args.reps, dev)
        m = queue_model(engine, size, args.tiles)
        if not m["t_queue_s"] < m["t_serial_s"]:
            raise SystemExit("independent tile reductions must overlap in "
                             "the makespan")
        print(f"{size},{us_single:.1f},{us_dist:.1f},"
              f"{us_single / us_dist:.2f},{m['model_blocking_x']:.2f},"
              f"{m['model_offload_x']:.2f},{m['overlap_x']:.2f}",
              flush=True)


def run_process(rank: int, world: int, args) -> None:
    """One rank of use case 1 one rank per process: this process's slice
    of x and row block of w, its partials reduced to rank 0, which
    prints the CSV."""
    from repro_torch.core.procgroup import ProcessGroupEngine
    engine = ProcessGroupEngine({"x": world},
                                device="cpu" if args.device == "cpu"
                                else None)
    _report(engine, args, lambda x, w: (
        x.reshape(world, -1)[rank], w.reshape(world, -1, w.shape[1])[rank]),
        root=rank == 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    ap.add_argument("--tiles", type=int, default=TILES)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--procs", type=int, default=None,
                    help="run one rank per process, N processes")
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
    engine = CollectiveEngine({"x": NRANKS}, device=args.device)
    _report(engine, args, lambda x, w: (
        x.reshape(NRANKS, -1), w.reshape(NRANKS, -1, w.shape[1])), root=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
