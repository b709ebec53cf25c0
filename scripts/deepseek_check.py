"""DeepSeek-V3 served through `ServeSession` at the benchmark
configuration's widths (the 7-layer cut, one node's 64 experts, 8 ranks
stacked), held against the plain reference: prefill over a prompt, then
decode steps through the latent cache (the absorbed form), each step's
logits against the reference's full forward over the prompt and the
tokens generated.

    python3 scripts/deepseek_check.py --seed 1 --prompt 16384 --steps 32

The weights are the port's init from the seed (as the benchmark cell
draws them), the prompt ids uniform over the vocabulary (the cell's
traffic). The reference (`perfbench/reference/deepseek_v3.py`, float32)
runs once, layer by layer, after the session's caches are freed, on the
experts the session served. Prints one JSON line: each step's
`logit_gap`, their maximum beside the cell's limit, the near-tie stats
(the widest routing gap among the swapped tokens, `swap_gap`, beside
the cell's limit), the engines' `moe.dropped` and `moe.absent`, the
times, the peak memory and the card; exits 1 where a gap passes its
limit or an assignment dropped.
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "perfbench"), str(ROOT / "src")]

CELL = "deepseek-v3-prefill-16k"


def _routes(prefill: list, decode: list, n_moe: int, tp: int) -> list:
    """Each MoE layer's experts over the whole sequence: prefill's rows
    (token-sharded over the TP ranks), then one row a decode step."""
    import torch

    def rows(top, sharded):
        r = top.reshape((-1,) + tuple(top.shape[-2:]))
        return r[:tp].reshape(-1, r.shape[-1]) if sharded else r[0]
    out = []
    for i in range(n_moe):
        parts = [rows(*prefill[i])]
        parts += [rows(*decode[j]) for j in range(i, len(decode), n_moe)]
        out.append(torch.cat(parts))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--prompt", type=int, default=16384)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    import bench_harness as H
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.parallel import stages
    from repro_torch.runtime.serve_session import ServeSession
    drv = H.load_module("drivers/deepseek_prefill.py")
    ref = drv.ref
    cell = H.load_cell(CELL)
    cfg, p = cell.config, dict(cell.params, prompt_tokens=args.prompt)
    dev = torch.device(args.device)
    t0 = time.time()
    arch = drv.arch_config(cfg)
    mesh = dict(cfg["mesh"])
    tp = mesh["model"]
    n = args.steps + 1
    sess = ServeSession(arch, ParallelConfig(), mesh, tp, 1, args.prompt,
                        args.prompt + n, device=dev)
    params = stages.init_params(
        arch, mesh, tp, seed=drv.I.sub_seed(args.seed, "deepseek", "weights"),
        device=dev, serve=True)
    weights = drv.Weights(arch, params, mesh)
    tokens = drv.prompts(cfg, p, args.seed)[:1]
    sess.prefill_ctx.routes, sess.decode_ctx.routes = [], []
    t1 = time.time()
    gen, logits = sess.generate(params, tokens, n, return_logits=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t2 = time.time()
    n_moe = arch.n_layers - cfg["first_k_dense_replace"]
    routes = _routes(sess.prefill_ctx.routes, sess.decode_ctx.routes,
                     n_moe, tp)
    metrics = {k: sum(int(c.engine.metrics.get(k, 0))
                      for c in (sess.prefill_ctx, sess.decode_ctx))
               for k in ("moe.dropped", "moe.absent", "moe.assignments")}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del sess
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    seq = torch.cat([tokens[0], gen[0, :-1].to(tokens.dtype)])
    stats: dict = {}
    want, _caches = ref.forward(weights.layer_of, weights.embed(),
                                weights.head(), weights.final_norm(),
                                seq.to(dev), cfg, last=n, routes=routes,
                                stats=stats)
    gaps = [ref.gap(logits[0, i].to(dev), want[i]) for i in range(n)]
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({
        "prompt": args.prompt, "decode_steps": args.steps,
        "logit_gap": gaps, "logit_gap_max": max(gaps),
        "limit": cell.limits["logit_gap"], "near_ties": stats,
        "swap_gap_limit": cell.limits["swap_gap"],
        "moe": metrics, "serve_s": t2 - t1, "setup_s": t1 - t0,
        "reference_s": time.time() - t2, "memory_peak_bytes": peak,
        "device": kind}), flush=True)
    return 0 if max(gaps) <= cell.limits["logit_gap"] \
        and stats.get("swap_gap", 0.0) <= cell.limits["swap_gap"] \
        and not metrics["moe.dropped"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
