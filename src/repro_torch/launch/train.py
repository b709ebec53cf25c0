"""Training launcher.

Port of `repro/launch/train.py`: the `Trainer` over the (pod, data,
model) = (1, devices / tp, tp) mesh, every rank stacked on one device:

    python -m repro_torch.launch.train --arch qwen3-0.6b [--full]
        [--steps 100] [--batch 8] [--seq 64] [--devices 8] [--tp 2]
        [--sp] [--compress int8] [--remat none] [--lr 3e-4]
        [--ckpt DIR] [--ckpt-every 50] [--seed 0] [--device cuda]
        [--procs N] [--log-json PATH]

or one rank per process — the counterpart of the reference's
`jax.distributed.initialize()` under `JAX_COORDINATOR`: `--procs N`
spawns N processes on a gloo group over the (1, N / tp, tp) mesh, and
under `torchrun` (RANK and WORLD_SIZE set) the process joins the world
torchrun started instead:

    torchrun --nproc_per_node 4 -m repro_torch.launch.train \\
        --arch qwen3-0.6b --device cpu

Each process then holds its own shards (the `Trainer` on its
`stages.process_engine`),
loads only its data-parallel rows, and takes the stacked run's
trajectory: its params are drawn as the stacked init's rows. Rank 0
prints the log and writes the checkpoints.

It runs on the card unless `--device cpu` is given, and raises on a
machine without one. The reference's flags, with `--reduced` a
BooleanOptionalAction (on by default; `--no-reduced` or `--full` trains
the architecture at full width), as in the port's `launch/serve.py`.
The checkpoint directory defaults to `train_ckpt` under the working
directory; `--log-json` writes the per-step log as JSON there.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--backend", default="microcode")
    ap.add_argument("--sp", action="store_true")
    ap.add_argument("--compress", default="")
    ap.add_argument("--remat", default="none")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--procs", type=int, default=None,
                    help="run one rank per process, N processes")
    ap.add_argument("--log-json", default=None)
    return ap


def build(argv=None, per_process: bool = False):
    """(trainer, args) of the launcher's flags: the code path `main`
    runs, for callers that drive the trainer themselves. `per_process`:
    this process's rank of an initialized world, whose size is the
    mesh's device count."""
    args = _parser().parse_args(argv)

    from repro_torch.configs import ParallelConfig, get_config, \
        reduced_config
    from repro_torch.data import DataConfig
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.optim import adamw
    from repro_torch.optim.schedules import cosine_warmup
    from repro_torch.parallel import stages
    from repro_torch.runtime import Trainer, TrainerConfig

    # products that the reference accumulates in fp32 do so here too
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    devices = torch.distributed.get_world_size() if per_process \
        else args.devices
    mesh = make_mesh_for(devices, tp=args.tp)
    pcfg = ParallelConfig(backend=args.backend, sequence_parallel=args.sp,
                          remat=args.remat,
                          grad_compression=args.compress or None)
    engine = stages.process_engine(mesh, pcfg.backend, args.device) \
        if per_process else None
    steps = args.steps
    trainer = Trainer(
        cfg, pcfg, mesh, adamw.AdamWConfig(lr=args.lr),
        DataConfig(global_batch=args.batch, seq_len=args.seq,
                   seed=args.seed),
        TrainerConfig(total_steps=steps, ckpt_dir=args.ckpt,
                      ckpt_every=args.ckpt_every),
        lr_schedule=lambda s: cosine_warmup(s, 20, steps),
        device=args.device, engine=engine)
    return trainer, args


def _train(argv, per_process: bool) -> None:
    trainer, args = build(argv, per_process)
    log = trainer.run()
    if not trainer.root:
        return
    for rec in log:
        if "step" in rec and rec["step"] % 10 == 0:
            print(f"step {rec['step']:5d}  ce {rec['ce_mean']:.4f}  "
                  f"{rec['dt'] * 1e3:.0f} ms", flush=True)
    if trainer.watchdog.events:
        print("straggler events:", trainer.watchdog.events)
    if args.log_json:
        with open(args.log_json, "w") as f:
            json.dump(log, f)


def run_process(rank: int, world: int, argv) -> None:
    """One rank of the launcher one rank per process."""
    _train(argv, per_process=True)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    from repro_torch.launch import procs
    if args.procs:
        procs.spawn(run_process, args.procs, backend="gloo",
                    device=args.device, args=(argv,))
        return
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world, _local = procs.init_from_env("gloo", args.device)
        try:
            run_process(rank, world, argv)
        finally:
            torch.distributed.destroy_process_group()
        return
    _train(argv, per_process=False)


if __name__ == "__main__":
    main()
