"""Serving launcher: greedy decode over the sharded caches.

Port of `repro/launch/serve.py`: the prompt is consumed teacher-forced,
one decode step per token, then generation runs free — the decode-only
path, the same program serving runs per token. All ranks of the mesh
are stacked on one device:

    python -m repro_torch.launch.serve --arch qwen3-0.6b [--no-reduced]
        [--batch 4] [--prompt-len 16] [--gen 8] [--devices 8] [--tp 2]
        [--device cuda] [--seed 0]

It runs on the card unless `--device cpu` is given, and raises on a
machine without one. The reference's `--reduced` is `store_true` with
`default=True`, so it can never be turned off; here it stays on by
default and `--no-reduced` serves the architecture at full width (a
deliberate divergence, ROADMAP Queue 3).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ParallelConfig, get_config, reduced_config
from repro_torch.convert import stack_global, unstack
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.parallel import stages


def decode_loop(dstep, params, cache, prompt, gen: int, mesh_shape: dict,
                dp):
    """The launcher's loop: teacher-forced over `prompt` (a (B, P) int
    tensor on the step's device), then `gen` free-running steps. Returns
    the (B, P + gen) sequence (prompt, then the generated tokens) on the
    device; the caches are written in place."""
    spec = (dp, None)
    p = prompt.shape[1]
    seqs = [prompt]
    tok = stack_global(prompt[:, :1], mesh_shape, spec)
    for t in range(p + gen - 1):
        nxt, cache = dstep(params, cache, tok, t)
        if t + 1 < p:
            tok = stack_global(prompt[:, t + 1:t + 2], mesh_shape, spec)
        else:
            seqs.append(unstack(nxt[..., None], mesh_shape, spec))
            tok = nxt[..., None]
    return torch.cat(seqs, dim=1)


def main(argv=None):
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
    args = ap.parse_args(argv)
    # products that the reference accumulates in fp32 do so here too
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    mesh = make_mesh_for(args.devices, tp=args.tp)
    pcfg = ParallelConfig(backend=args.backend, moe_capacity_factor=8.0)
    s_max = args.prompt_len + args.gen
    params = stages.init_params(cfg, mesh, args.tp, seed=args.seed,
                                device=args.device, serve=True)
    dstep, ctx, _, _ = stages.build_decode_step(
        cfg, pcfg, mesh, s_max=s_max, global_batch=args.batch,
        device=args.device)
    cache = stages.init_cache(cfg, pcfg, mesh, args.tp, args.batch, s_max,
                              device=args.device)
    rng = np.random.default_rng(args.seed)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32))
    t0 = time.perf_counter()
    out = decode_loop(dstep, params, cache, prompt.to(ctx.engine.device),
                      args.gen, mesh, stages.dp_axes(mesh, args.batch))
    out = out.cpu()
    seconds = time.perf_counter() - t0
    print(f"{cfg.name} ({'reduced' if args.reduced else 'full width'}, "
          f"{cfg.n_layers} layers) on mesh {mesh}, {ctx.engine.device}: "
          f"{s_max - 1} decode steps in {seconds:.3f} s")
    print("generated (batch x tokens):")
    print(out.numpy())


if __name__ == "__main__":
    main()
