"""Serving launcher: greedy decode over the sharded caches.

Port of `repro/launch/serve.py`: the prompt is consumed teacher-forced,
one decode step per token, then generation runs free — the decode-only
path, the same program serving runs per token. All ranks of the mesh
are stacked on one device:

    python -m repro_torch.launch.serve --arch qwen3-0.6b [--no-reduced]
        [--batch 4] [--prompt-len 16] [--gen 8] [--devices 8] [--tp 2]
        [--device cuda] [--seed 0] [--procs N] [--out PATH]

With `--procs N` it serves one rank per process: N processes on a gloo
group over the (1, N / tp, tp) mesh, each holding its own shards of the
params (drawn as the stacked init's rows, so the tokens are the stacked
run's) and of the caches; under `torchrun` (RANK and WORLD_SIZE set)
the process joins the world torchrun started instead. Every process
generates the same sequence; rank 0 prints it (and `--out` writes it as
JSON).

It runs on the card unless `--device cpu` is given, and raises on a
machine without one. The reference's `--reduced` is `store_true` with
`default=True`, so it can never be turned off; here it stays on by
default and `--no-reduced` serves the architecture at full width (a
deliberate divergence, ROADMAP Queue 3).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.configs import ParallelConfig, get_config, reduced_config
from repro_torch.convert import gather_global, shard_of, stack_global, \
    unstack
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.parallel import stages


def decode_loop(dstep, params, cache, prompt, gen: int, mesh_shape: dict,
                dp, engine=None):
    """The launcher's loop: teacher-forced over `prompt` (a (B, P) int
    tensor on the step's device), then `gen` free-running steps. Returns
    the (B, P + gen) sequence (prompt, then the generated tokens) on the
    device; the caches are written in place. With a per-process `engine`
    the step takes this process's rows of each token and the generated
    tokens are gathered once, at the end."""
    spec = (dp, None)
    local = engine is not None and engine.stack_shape == ()

    def put(t):
        if local:
            return shard_of(t, mesh_shape, spec, engine.coords)
        return stack_global(t, mesh_shape, spec)

    p = prompt.shape[1]
    seqs, made = [prompt], []
    tok = put(prompt[:, :1])
    for t in range(p + gen - 1):
        nxt, cache = dstep(params, cache, tok, t)
        if t + 1 < p:
            tok = put(prompt[:, t + 1:t + 2])
        else:
            made.append(nxt[..., None])
            tok = nxt[..., None]
    if made:
        out = torch.cat(made, dim=-1)
        seqs.append(gather_global(out, spec, engine) if local
                    else unstack(out, mesh_shape, spec))
    return torch.cat(seqs, dim=1)


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--backend", default="microcode")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--procs", type=int, default=None,
                    help="run one rank per process, N processes")
    ap.add_argument("--out", default=None)
    return ap


def _serve(args, per_process: bool) -> None:
    # products that the reference accumulates in fp32 do so here too
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    devices = torch.distributed.get_world_size() if per_process \
        else args.devices
    mesh = make_mesh_for(devices, tp=args.tp)
    pcfg = ParallelConfig(backend=args.backend, moe_capacity_factor=8.0)
    s_max = args.prompt_len + args.gen
    engine = stages.process_engine(mesh, pcfg.backend, args.device) \
        if per_process else None
    coords = engine.coords if per_process else None
    device = engine.device if per_process else args.device
    params = stages.init_params(cfg, mesh, args.tp, seed=args.seed,
                                device=device, serve=True, coords=coords)
    dstep, ctx, _, _ = stages.build_decode_step(
        cfg, pcfg, mesh, s_max=s_max, global_batch=args.batch,
        device=device, engine=engine)
    cache = stages.init_cache(cfg, pcfg, mesh, args.tp, args.batch, s_max,
                              device=device, coords=coords)
    rng = np.random.default_rng(args.seed)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32))
    t0 = time.perf_counter()
    out = decode_loop(dstep, params, cache, prompt.to(ctx.engine.device),
                      args.gen, mesh, stages.dp_axes(mesh, args.batch),
                      engine=engine)
    out = out.cpu()
    seconds = time.perf_counter() - t0
    if per_process and engine.global_rank != 0:
        return
    where = f"one rank per process, {devices} processes" if per_process \
        else "ranks stacked"
    print(f"{cfg.name} ({'reduced' if args.reduced else 'full width'}, "
          f"{cfg.n_layers} layers) on mesh {mesh}, {where}, "
          f"{ctx.engine.device}: {s_max - 1} decode steps in "
          f"{seconds:.3f} s")
    print("generated (batch x tokens):")
    print(out.numpy())
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out.tolist(), f)


def run_process(rank: int, world: int, args) -> None:
    """One rank of the launcher one rank per process."""
    _serve(args, per_process=True)


def main(argv=None):
    args = _parser().parse_args(argv)
    from repro_torch.launch import procs
    if args.procs:
        procs.spawn(run_process, args.procs, backend="gloo",
                    device=args.device, args=(args,))
        return
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world, _local = procs.init_from_env("gloo", args.device)
        try:
            run_process(rank, world, args)
        finally:
            torch.distributed.destroy_process_group()
        return
    _serve(args, per_process=False)


if __name__ == "__main__":
    main()
