"""Driver `granite_prefill`: long prompts through the port's serving
prefill (`stages.build_prefill`'s function) of Granite-4.0-H, every
rank of one pipeline stage stacked on one card.

The configuration is read into the port's `LayerTypedConfig` before
anything is drawn (a tree without it fails here, at once). The weights
are the port's own init (`stages.init_params`, the serving layout)
drawn on the card from the seed. The traffic (`params`): one prompt in
flight, `batch` 1, each of `prompt_tokens` ids uniform over the
vocabulary, from a pool of `pool` prompts drawn from the seed and held
in pinned host memory, where requests arrive; the first token only, no
decode. A closed loop: the next prompt is issued when the last one's
first token and last-position logits are on the host. A prompt's
latency runs from its issue to those on the host, timed by CUDA events
on the card.

The answers of the first call and of `checked_calls` calls drawn from
the seed are kept: the last-position logits, the emitted caches (each
attention layer's k / v, each Mamba layer's conv and SSM state) and the
experts each MoE layer chose (`Program.record`). Once the window has
closed and its buffers are freed, the plain reference
(`reference/granite.py`, float32, layer by layer on the same weights)
computes each kept call again, taking the program's experts for the
tokens whose rank-10 and rank-11 router logits lie within
`route_margin` of each other (routing near-ties, where bfloat16 may
swap the 10th expert). The checks: `logit_gap` and `cache_gap`, the
widest errors as shares of the reference's root mean square;
`near_tie_share`, the share of (token, layer) routings so taken whose
experts differ from the reference's own; `moe_dropped`, the assignments
the dispatch dropped over the whole run (the engine's `moe.dropped`),
which must read 0. Each limit is set in `PERF.md` §2 from the program
on 14 seeds and the control (`granite_faults.control`) on 3.
"""
from __future__ import annotations

import math
import sys
import time
from typing import Optional

import torch

import bench_harness as H
import bench_inputs as I
from bench_trace import Recorder, span_of

ref = H.load_module("reference/granite.py")


def control(cell) -> tuple:
    """(the cell, the program) of the control: the reference with every
    product's operands rounded through float8_e4m3fn, in the program's
    place."""
    return cell, "granite_faults:control"


def arch_config(cfg: dict):
    """The port's config of the configuration file (the published
    config's keys)."""
    from repro_torch.configs.base import LayerTypedConfig
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    if cfg["mamba_n_heads"] * cfg["mamba_d_head"] != \
            cfg["mamba_expand"] * d or cfg["mamba_n_groups"] != 1:
        raise ValueError("Mamba2 widths the port does not lay out")
    return LayerTypedConfig(
        name=cfg["name"], family="moe", n_layers=cfg["num_hidden_layers"],
        d_model=d, n_heads=heads, n_kv_heads=cfg["num_key_value_heads"],
        head_dim=d // heads, d_ff=0, vocab_size=cfg["vocab_size"],
        tie_embeddings=cfg["tie_word_embeddings"],
        norm_eps=cfg["rms_norm_eps"], n_experts=cfg["num_local_experts"],
        experts_per_token=cfg["num_experts_per_tok"],
        moe_d_ff=cfg["intermediate_size"], ssm_state=cfg["mamba_d_state"],
        ssm_expand=cfg["mamba_expand"], ssm_conv=cfg["mamba_d_conv"],
        ssm_head_dim=cfg["mamba_d_head"], ssm_chunk=cfg["mamba_chunk_size"],
        layer_types=tuple(cfg["layer_types"]),
        shared_d_ff=cfg["shared_intermediate_size"],
        embedding_multiplier=float(cfg["embedding_multiplier"]),
        residual_multiplier=float(cfg["residual_multiplier"]),
        logits_scaling=float(cfg["logits_scaling"]),
        attention_multiplier=float(cfg["attention_multiplier"]),
        use_rope=cfg["position_embedding_type"] != "nope",
        ssm_conv_bias=cfg["mamba_conv_bias"], moe_dropless=True,
        expert_init_fan_in=True,            # `assumed`'s init
        param_dtype=cfg["dtype"], compute_dtype=cfg["dtype"],
        source=cfg["source"])


class Program:
    """The port's prefill at the configuration's mesh, on weights drawn
    from the seed. `__call__(tokens)` serves one prompt ((1, S) ids on
    the host) and returns the raw answer; `host(out)` brings the first
    token and the last-position logits to the host; `answers(out)` gives
    the logits (V,) and every layer's caches in the reference's layout."""

    def __init__(self, cfg: dict, params: dict, seed: int, device):
        from repro_torch.configs.base import ParallelConfig
        from repro_torch.models.blocks import layer_plan
        from repro_torch.models.serve import prefill_cache_names, \
            prefill_cache_specs
        from repro_torch.parallel import stages
        self.arch = arch_config(cfg)
        self.mesh = dict(cfg["mesh"])
        self.tp = self.mesh["model"]
        self.device = torch.device(device)
        s = params["prompt_tokens"]
        pcfg = ParallelConfig()
        self.fn, self.ctx, self.specs, self.bspec = stages.build_prefill(
            self.arch, pcfg, self.mesh, params["batch"], s,
            device=self.device)
        self.params = stages.init_params(
            self.arch, self.mesh, self.tp,
            seed=I.sub_seed(seed, "granite", "weights"), device=self.device,
            serve=True)
        self.weights = Weights(self.arch, self.params, self.mesh)
        self.plan = layer_plan(self.arch)
        self.cache_names = prefill_cache_names(self.arch)
        self.cache_specs = dict(zip(self.cache_names, prefill_cache_specs(
            self.arch, self.ctx.pcfg, self.tp, s,
            dp=stages.dp_axes(self.mesh, params["batch"]))))

    def __call__(self, tokens):
        from repro_torch.convert import stack_global
        t = tokens.to(self.device, non_blocking=True)
        batch = {"tokens": stack_global(t, self.mesh, self.bspec["tokens"])}
        return self.fn(self.params, batch, return_logits=True)

    def _global(self, t, spec):
        from repro_torch.convert import unstack
        return unstack(t, self.mesh, spec)

    def host(self, out) -> tuple:
        nxt, _caches, logits = out
        return (nxt.reshape(-1)[0].cpu(),
                self._global(logits, (None, "model")).cpu())

    def answers(self, out) -> tuple:
        """(logits (V,) fp32, [per layer: (k, v) (S, KV, hd) or (conv
        (cw - 1, di + 2n), state (H, n, P))]) of batch row 0."""
        _nxt, caches, logits = out
        lg = self._global(logits, (None, "model"))[0, :self.arch.vocab_size]
        stacks = dict(zip(self.cache_names, caches))
        rows: dict = {}
        per_layer = []
        for spot in self.plan:
            names = ("conv", "state") if spot.group == "mamba" else \
                ("k", "v")
            got = []
            for name in names:
                r = rows.get(name, 0)
                rows[name] = r + 1
                got.append(self._global(stacks[name][r],
                                        self.cache_specs[name][1:])[0])
            if spot.group == "mamba":
                got[0] = self._conv_channels(got[0])
            per_layer.append(tuple(got))
        return lg.float(), per_layer

    def _conv_channels(self, conv):
        """The conv state's channels in the reference's order, x | B | C:
        the port keeps each rank's block (its x channels, then the
        replicated B | C)."""
        blocks = conv.reshape(conv.shape[0], self.tp, -1)
        n2 = 2 * self.arch.ssm_state
        di_l = blocks.shape[-1] - n2
        return torch.cat([blocks[..., :di_l].reshape(conv.shape[0], -1),
                          blocks[:, 0, di_l:]], dim=-1)

    def layer_of(self, i: int) -> dict:
        return self.weights.layer_of(i)

    def embed(self):
        return self.weights.embed()

    def final_norm(self):
        return self.weights.final_norm()

    def record(self, on: bool) -> Optional[list]:
        """Start recording the routing of what is served (`on`), or stop
        and return it: one (S, k) tensor of experts an MoE layer, batch
        row 0, in the sequence's order."""
        if on:
            self.ctx.routes = []
            return None
        got, self.ctx.routes = self.ctx.routes, None
        tp = self.tp
        out = []
        for top, sharded in got:
            rows = top.reshape((-1,) + tuple(top.shape[-2:]))
            out.append(rows[:tp].reshape(-1, rows.shape[-1]) if sharded
                       else rows[0])
        return out

    def dropped(self) -> int:
        return int(self.ctx.engine.metrics.get("moe.dropped", 0))


class Weights:
    """Global views of served weights (the serving layout's stacked
    params), one layer at a time, in the port's names: what the reference
    is given."""

    def __init__(self, arch, params, mesh: dict):
        from repro_torch.models.blocks import layer_plan
        from repro_torch.parallel import stages
        self.params, self.mesh = params, mesh
        self.specs = stages.param_specs(arch, mesh["model"], serve=True)
        self.plan = layer_plan(arch)

    def layer_of(self, i: int) -> dict:
        spot = self.plan[i]
        return _tree_global(self.params["layers"][spot.group],
                            self.specs["layers"][spot.group], spot.index,
                            self.mesh)

    def _global(self, name: str):
        from repro_torch.convert import unstack
        return unstack(self.params[name], self.mesh, self.specs[name])

    def embed(self):
        return self._global("embed")

    def final_norm(self):
        return self._global("final_norm")


def _tree_global(tree, specs, row: int, mesh: dict):
    from repro_torch.convert import unstack
    if isinstance(tree, dict):
        return {k: _tree_global(tree[k], specs[k], row, mesh) for k in tree}
    return unstack(tree[row], mesh, tuple(specs)[1:])


def prompts(cfg: dict, params: dict, seed: int):
    """The pool: (pool, prompt_tokens) int32 ids, uniform over the
    vocabulary, on the host."""
    g = torch.Generator().manual_seed(I.sub_seed(seed, "granite", "prompts"))
    return torch.randint(cfg["vocab_size"],
                         (params["pool"], params["prompt_tokens"]),
                         generator=g, dtype=torch.int64).to(torch.int32)


def compare(program, cfg: dict, pool, kept: dict, margin: float,
            device) -> tuple:
    """(logit_gap, cache_gap, the near-tie stats) over the kept answers,
    {call: (prompt, (logits, caches), routes)}: the reference computed
    for each call on the routes it served (`reference/granite.py`)."""
    lgap = cgap = 0.0
    stats: dict = {}
    for _i, (j, (lg, caches), routes) in sorted(kept.items()):
        want_lg, want_caches = ref.forward(
            program.layer_of, program.embed(), program.final_norm(),
            pool[j].to(device), cfg, routes=routes, margin=margin,
            stats=stats)
        lgap = max(lgap, ref.gap(lg.to(device), want_lg[0]))
        for got, want in zip(caches, want_caches):
            for g, w in zip(got, want):
                cgap = max(cgap, ref.gap(g.to(device), w))
        del want_lg, want_caches
    return lgap, cgap, stats


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
    rec = Recorder(dev) if trace else None
    span = span_of(rec)

    def step(i):
        checked = i in keep
        if checked:
            prog.record(True)
        e0 = _stamp(cuda)
        with span("prefill"):
            out = prog(pool[i % P][None])
        with span("first token to host"):
            prog.host(out)
        stamps.append((e0, _stamp(cuda)))
        if checked:
            kept[i] = (i % P, out, prog.record(False))

    marks.mark("warm-up")
    setup_s = time.time() - t0
    window_s, calls = H.closed_loop(step, seconds, rec,
                                    p["trace_calls"] if trace else 0)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    done = [(_elapsed_s(e0, e1), p["batch"]) for e0, e1 in stamps]
    if cuda:
        torch.cuda.empty_cache()
    dropped = prog.dropped()
    kept = {i: (j, prog.answers(out), r) for i, (j, out, r) in kept.items()}
    lgap = cgap = math.inf
    stats = {"near_ties": math.inf, "routed": 1}
    if kept:
        lgap, cgap, stats = compare(prog, cfg, pool, kept,
                                    p["route_margin"], dev)
        print(f"routing: {stats}", file=sys.stderr)
    return H.Run(setup_s=setup_s, window_s=window_s, done=done,
                 attempted=calls * p["batch"], failed=0,
                 checks={"logit_gap": (lgap, cell.limits["logit_gap"]),
                         "cache_gap": (cgap, cell.limits["cache_gap"]),
                         "near_tie_share": (
                             stats.get("near_ties", 0)
                             / max(1, stats.get("routed", 1)),
                             cell.limits["near_tie_share"]),
                         "moe_dropped": (float(dropped), 0.0)},
                 memory_peak_bytes=peak, device_kind=kind, device_count=1,
                 trace=rec.trace if rec else None, setup_split=marks.split)


def _stamp(cuda: bool):
    if cuda:
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e
    return time.perf_counter()


def _elapsed_s(e0, e1) -> float:
    if isinstance(e0, float):
        return e1 - e0
    return e0.elapsed_time(e1) / 1e3
