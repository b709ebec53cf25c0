"""Training launcher.

Port of `repro/launch/train.py`: the `Trainer` over the (pod, data,
model) = (1, devices / tp, tp) mesh, every rank stacked on one device:

    python -m repro_torch.launch.train --arch qwen3-0.6b [--full]
        [--steps 100] [--batch 8] [--seq 64] [--devices 8] [--tp 2]
        [--sp] [--compress int8] [--remat none] [--lr 3e-4]
        [--ckpt DIR] [--ckpt-every 50] [--seed 0] [--device cuda]

It runs on the card unless `--device cpu` is given, and raises on a
machine without one. The reference's flags, with `--reduced` a
BooleanOptionalAction (on by default; `--no-reduced` or `--full` trains
the architecture at full width), as in the port's `launch/serve.py`.
The checkpoint directory defaults to `train_ckpt` under the working
directory.
"""
from __future__ import annotations

import argparse

import torch


def build(argv=None):
    """(trainer, args) of the launcher's flags: the code path `main`
    runs, for callers that drive the trainer themselves."""
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
    args = ap.parse_args(argv)

    from repro_torch.configs import ParallelConfig, get_config, \
        reduced_config
    from repro_torch.data import DataConfig
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.optim import adamw
    from repro_torch.optim.schedules import cosine_warmup
    from repro_torch.runtime import Trainer, TrainerConfig

    # products that the reference accumulates in fp32 do so here too
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    mesh = make_mesh_for(args.devices, tp=args.tp)
    pcfg = ParallelConfig(backend=args.backend, sequence_parallel=args.sp,
                          remat=args.remat,
                          grad_compression=args.compress or None)
    steps = args.steps
    trainer = Trainer(
        cfg, pcfg, mesh, adamw.AdamWConfig(lr=args.lr),
        DataConfig(global_batch=args.batch, seq_len=args.seq,
                   seed=args.seed),
        TrainerConfig(total_steps=steps, ckpt_dir=args.ckpt,
                      ckpt_every=args.ckpt_every),
        lr_schedule=lambda s: cosine_warmup(s, 20, steps),
        device=args.device)
    return trainer, args


def main(argv=None):
    trainer, _args = build(argv)
    log = trainer.run()
    for rec in log:
        if "step" in rec and rec["step"] % 10 == 0:
            print(f"step {rec['step']:5d}  ce {rec['ce_mean']:.4f}  "
                  f"{rec['dt'] * 1e3:.0f} ms")
    if trainer.watchdog.events:
        print("straggler events:", trainer.watchdog.events)


if __name__ == "__main__":
    main()
