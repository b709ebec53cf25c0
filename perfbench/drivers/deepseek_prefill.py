"""Driver `deepseek_prefill`: long prompts through the port's serving
prefill (`stages.build_prefill`'s function) of DeepSeek-V3, the eight
ranks of one node stacked on one card, holding that node's share of the
experts.

The configuration is read into the port's `LayerTypedConfig` before
anything is drawn (a tree without DeepSeek-V3's knobs fails here, at
once). The weights are the port's own init (`stages.init_params`, the
serving layout) drawn on the card from the seed, the router's correction
bias among them. The traffic (`params`): one prompt in flight, `batch`
1, each of `prompt_tokens` ids uniform over the vocabulary, from a pool
of `pool` prompts drawn from the seed (Granite's driver's pool) and held
in pinned host memory;
the first token only, no decode. A closed loop: the next prompt is
issued when the last one's first token and last-position logits are on
the host. A prompt's latency runs from its issue to those on the host,
timed by CUDA events on the card (`drivers/granite_prefill.py`'s
stamps).
A traced run also keeps each device operation's launch time on the host
(`launches.LaunchRecorder`), from which `mla_ms` reads MLA's device time.

The answers of the first call and of `checked_calls` calls drawn from
the seed are kept: the last-position logits, every layer's latent cache
(`c_kv`, `k_pe`) and the experts each MoE layer chose. Once the window
has closed, the plain reference (`reference/deepseek_v3.py`, float32,
layer by layer on the same weights and the same expert share) computes
each kept call again on the program's experts, so that no single swapped
token decides the gaps; the routing is checked on its own. The checks:
`logit_gap` and `cache_gap`, the widest errors as shares of the
reference's root mean square; `cache_rms_gap`, the largest of each
layer's latent caches' error root mean square as a share of the
reference's (an error spread over the tokens: a gate off in every
routed token, which moves no single value far); `near_tie_share`, the
share of (token, MoE layer) routings whose experts differ from the
reference's own;
`swap_gap`, the widest of the reference's own routing gaps (the group
cut or the k-th expert) among those routings, which a bf16 rounding
keeps within a few hundredths; `moe_dropped`, the assignments the
dispatch dropped over the whole run (the engine's `moe.dropped`), which
must read 0. Each limit is set in `PERF.md` §2 from the program on 8
seeds or more and the control (`deepseek_faults.control`) on 3.
"""
from __future__ import annotations

import math
import sys
import time
import torch

import bench_harness as H
import bench_inputs as I
from bench_trace import span_of
from launches import LaunchRecorder

ref = H.load_module("reference/deepseek_v3.py")
granite = H.load_module("drivers/granite_prefill.py")


def control(cell) -> tuple:
    """(the cell, the program) of the control: the reference with every
    product's operands rounded through float8_e4m3fn, in the program's
    place."""
    return cell, "deepseek_faults:control"


def arch_config(cfg: dict):
    """The port's config of the configuration file (the published
    config's keys, the expert share beside them)."""
    from repro_torch.configs.base import LayerTypedConfig
    rs = cfg["rope_scaling"]
    if (cfg["topk_method"], cfg["scoring_func"], rs["type"],
            cfg["moe_layer_freq"], cfg["norm_topk_prob"], cfg["hidden_act"],
            cfg["attention_bias"]) != (
            "noaux_tc", "sigmoid", "yarn", 1, True, "silu", False):
        raise ValueError("a router or rotary scaling the port does not run")
    n, dense = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    heads = cfg["num_attention_heads"]
    return LayerTypedConfig(
        name=cfg["name"], family="moe", n_layers=n,
        d_model=cfg["hidden_size"], n_heads=heads, n_kv_heads=heads,
        head_dim=cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        tie_embeddings=cfg["tie_word_embeddings"],
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
        n_experts=cfg["n_routed_experts"],
        experts_per_token=cfg["num_experts_per_tok"],
        moe_d_ff=cfg["moe_intermediate_size"],
        layer_types=("mla_dense",) * dense + ("mla_moe",) * (n - dense),
        shared_d_ff=cfg["n_shared_experts"] * cfg["moe_intermediate_size"],
        moe_dropless=True, expert_init_fan_in=True,   # `assumed`'s init
        q_lora_rank=cfg["q_lora_rank"], kv_lora_rank=cfg["kv_lora_rank"],
        qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"],
        yarn=(float(rs["factor"]), rs["original_max_position_embeddings"],
              float(rs["beta_fast"]), float(rs["beta_slow"]),
              float(rs["mscale"]), float(rs["mscale_all_dim"])),
        router_scoring="sigmoid",
        router_groups=cfg["n_group"], router_topk_groups=cfg["topk_group"],
        routed_scaling=float(cfg["routed_scaling_factor"]),
        router_experts=cfg["router_experts"],
        expert_offset=cfg["held_experts_from"],
        param_dtype=cfg["dtype"], compute_dtype=cfg["dtype"],
        source=cfg["source"])


class Weights(granite.Weights):
    """Global views of the served weights, the untied head too."""

    def head(self):
        return self._global("head")


class Program(granite.Program):
    """The port's prefill at the configuration's mesh, on weights drawn
    from the seed: Granite's program (`__call__`, `host`, `record`,
    `dropped`, the weights' views) on DeepSeek-V3's config, its untied
    head beside them; `answers(out)` gives the logits (V,) and every
    layer's latent cache in the reference's layout."""

    def __init__(self, cfg: dict, params: dict, seed: int, device):
        from repro_torch.configs.base import ParallelConfig
        from repro_torch.models.serve import prefill_cache_names, \
            prefill_cache_specs
        from repro_torch.parallel import stages
        self.arch = arch_config(cfg)
        self.mesh = dict(cfg["mesh"])
        self.tp = self.mesh["model"]
        self.device = torch.device(device)
        s = params["prompt_tokens"]
        self.fn, self.ctx, self.specs, self.bspec = stages.build_prefill(
            self.arch, ParallelConfig(), self.mesh, params["batch"], s,
            device=self.device)
        self.params = stages.init_params(
            self.arch, self.mesh, self.tp,
            seed=I.sub_seed(seed, "deepseek", "weights"), device=self.device,
            serve=True)
        self.weights = Weights(self.arch, self.params, self.mesh)
        self.cache_names = prefill_cache_names(self.arch)
        self.cache_specs = dict(zip(self.cache_names, prefill_cache_specs(
            self.arch, self.ctx.pcfg, self.tp, s,
            dp=stages.dp_axes(self.mesh, params["batch"]))))

    def answers(self, out) -> tuple:
        """(logits (V,) fp32, [per layer: (c_kv (S, r), k_pe (S, rope))])
        of batch row 0."""
        _nxt, caches, logits = out
        lg = self._global(logits, (None, "model"))[0, :self.arch.vocab_size]
        stacks = {n: (caches[self.cache_names.index(n)],
                      self.cache_specs[n][1:]) for n in ("c_kv", "k_pe")}
        per_layer = [tuple(self._global(stack[i], spec)[0]
                           for stack, spec in stacks.values())
                     for i in range(self.arch.n_layers)]
        return lg.float(), per_layer

    def head(self):
        return self.weights.head()


prompts = granite.prompts


def reference(program, cfg: dict, tokens, **kw):
    """The reference's forward of `tokens` on the program's weights."""
    return ref.forward(program.layer_of, program.embed(), program.head(),
                       program.final_norm(), tokens, cfg, **kw)


def compare(program, cfg: dict, pool, kept: dict, device) -> tuple:
    """(logit_gap, cache_gap, cache_rms_gap, the near-tie stats) over the
    kept answers, {call: (prompt, (logits, caches), routes)}."""
    lgap = cgap = crms = 0.0
    stats: dict = {}
    for _i, (j, (lg, caches), routes) in sorted(kept.items()):
        want_lg, want_caches = reference(program, cfg, pool[j].to(device),
                                         routes=routes, stats=stats)
        lgap = max(lgap, ref.gap(lg.to(device), want_lg[0]))
        for got, want in zip(caches, want_caches):
            for g, w in zip(got, want):
                cgap = max(cgap, ref.gap(g.to(device), w))
                crms = max(crms, ref.rms_gap(g.to(device), w))
        del want_lg, want_caches
    return lgap, cgap, crms, stats


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        program=None) -> H.Run:
    cfg, p = cell.config, cell.params
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    arch_config(cfg)                 # fails at once on a tree without it
    marks = H.Marks(t0)
    H.card_ready(dev, marks)
    pool = prompts(cfg, p, seed)
    if cuda:
        pool = pool.pin_memory()
    marks.mark("inputs")
    prog = (H.resolve(program) or Program)(cfg, p, seed, dev)
    marks.mark("program")
    P = p["pool"]
    for j in range(p["warmup_prompts"]):
        tw = time.perf_counter()
        prog.host(prog(pool[j % P][None]))
    per_call = time.perf_counter() - tw
    keep = H.sample(seed, max(1, int(seconds / per_call)),
                    p["checked_calls"])
    kept: dict = {}
    stamps: list = []
    rec = LaunchRecorder(dev) if trace else None
    span = span_of(rec)

    def step(i):
        checked = i in keep
        if checked:
            prog.record(True)
        e0 = granite._stamp(cuda)
        with span("prefill"):
            out = prog(pool[i % P][None])
        with span("first token to host"):
            prog.host(out)
        stamps.append((e0, granite._stamp(cuda)))
        if checked:
            kept[i] = (i % P, out, prog.record(False))

    marks.mark("warm-up")
    setup_s = time.time() - t0
    window_s, calls = H.closed_loop(step, seconds, rec,
                                    p["trace_calls"] if trace else 0)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    done = [(granite._elapsed_s(e0, e1), p["batch"]) for e0, e1 in stamps]
    if cuda:
        torch.cuda.empty_cache()
    dropped = prog.dropped()
    kept = {i: (j, prog.answers(out), r) for i, (j, out, r) in kept.items()}
    lgap = cgap = crms = math.inf
    stats = {"near_ties": math.inf, "routed": 1, "swap_gap": math.inf}
    if kept:
        lgap, cgap, crms, stats = compare(prog, cfg, pool, kept, dev)
        print(f"routing: {stats}", file=sys.stderr)
    return H.Run(setup_s=setup_s, window_s=window_s, done=done,
                 attempted=calls * p["batch"], failed=0,
                 checks={"logit_gap": (lgap, cell.limits["logit_gap"]),
                         "cache_gap": (cgap, cell.limits["cache_gap"]),
                         "cache_rms_gap": (crms,
                                           cell.limits["cache_rms_gap"]),
                         "near_tie_share": (
                             stats.get("near_ties", 0)
                             / max(1, stats.get("routed", 1)),
                             cell.limits["near_tie_share"]),
                         "swap_gap": (stats.get("swap_gap", 0.0),
                                      cell.limits["swap_gap"]),
                         "moe_dropped": (float(dropped), 0.0)},
                 memory_peak_bytes=peak, device_kind=kind, device_count=1,
                 trace=rec.trace if rec else None, setup_split=marks.split)
