"""Shared cases of `test_torch_procgroup_families.py`: what each process
of one spawned 4-process world runs — the MoE, SSM, hybrid, audio and
VLM families served and trained one rank per process, and the
`Trainer`'s elastic shrink per process — and the inputs the parent
holds its results against.

This module imports no jax: the spawned children import it to find
`run`. The parent hands the children, as numpy in `state.pt`, each
case's params and AdamW state (the JAX package's own init) and its
inputs; each child takes its shards with `convert.lm_params_from_jax(...,
coords=)` / `opt_state_from_jax(..., coords=)` and saves its local
results with `torch.save`. The MoE's and the SSM's decode step and train
step record every engine collective (`_torch_lm_procs_cases.
record_collectives`), so the parent can replay them on the stacked
engine.
"""
import numpy as np
import torch

from _torch_lm_procs_cases import record_collectives, unrecord
from repro_torch import convert
from repro_torch.configs import ParallelConfig, get_config, reduced_config
from repro_torch.optim import adamw
from repro_torch.parallel import stages
from repro_torch.runtime.serve_session import ServeSession, \
    convert_prefill_caches

N = 4
MESH = {"pod": 1, "data": 2, "model": 2}
PE_MESH = {"pod": 1, "data": 1, "model": 4}
B, S = 4, 16           # the batch and the prompt
DECODE = 4             # teacher-forced decode steps (of S slots)
GEN = 4                # the session's and the audio pieces' new tokens
S_ENC = 12             # whisper's stub frames in serving
LR = 1e-3
#: case -> (arch, reduced_config overrides, ParallelConfig fields, mesh):
#: the MoE at the serving tests' capacity (no drops, so decode equals the
#: forward); whisper's attention blocks tile its 12 frames and 16 tokens
CASES = {
    "qwen3moe": ("qwen3-moe-30b-a3b", {}, {"moe_capacity_factor": 16.0},
                 MESH),
    # one expert on 4 ranks: pseudo-experts, d_ff cut in four
    "mixtral_pe": ("mixtral-8x7b", {"n_experts": 1, "experts_per_token": 1},
                   {"moe_capacity_factor": 16.0}, PE_MESH),
    "mamba": ("mamba2-1.3b", {}, {}, MESH),
    # layer 0 global, layer 1 windowed; 5 SSM heads padded to 6 at tp 2
    "hymba": ("hymba-1.5b", {"d_model": 40}, {}, MESH),
    "whisper": ("whisper-medium", {},
                {"attn_q_block": 4, "attn_kv_block": 4}, MESH),
    "internvl": ("internvl2-26b", {}, {}, MESH),
}
#: the cases whose decode and train step collectives are replayed
RECORDED_CASES = ("qwen3moe", "mixtral_pe", "mamba")
DP_MESH = {"pod": 1, "data": 4, "model": 1}
#: the shrink runs: key -> (mesh, the (step, rank) failures of the data
#: axis, steps); "data1" starts from the JAX package's checkpoint after
#: step SHRINK_FROM, which the parent puts in its directory
SHRINK_ARCH = "qwen3-0.6b"
SHRINK_RUNS = {"data1": (MESH, ((4, 1),), 8),
               "data0": (MESH, ((4, 0),), 8),
               "none": (PE_MESH, ((2, 0),), 6),
               # two failures in a row, 4 -> 3 -> 2 data ranks
               "twice": (DP_MESH, ((2, 1), (4, 0)), 6)}
SHRINK_FROM = 1
SHRINK_SEQ = 16


def cfg(case: str):
    arch, over, _, _ = CASES[case]
    return reduced_config(get_config(arch), **over)


def pcfg(case: str, **kw):
    return ParallelConfig(remat="none", **{**CASES[case][2], **kw})


def mesh(case: str) -> dict:
    return CASES[case][3]


def tp(case: str) -> int:
    return mesh(case)["model"]


def inputs(case: str) -> dict:
    """The numpy inputs of a case: the prompt, the prefill batch (a VLM's
    visual prefix, the audio family's stub frames) and the train batch."""
    c = cfg(case)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, c.vocab_size, (B, S)).astype(np.int32)
    prefill = {"tokens": toks}
    if c.family == "vlm":
        prefill["vis_embed"] = rng.standard_normal(
            (B, c.n_vis_tokens, c.d_model)).astype(np.float32)
    if c.encoder_layers:
        prefill["frames"] = rng.standard_normal(
            (B, S_ENC, c.d_model)).astype(np.float32)
    t = rng.integers(0, c.vocab_size, (B, S + 1)).astype(np.int32)
    train = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    if c.family == "vlm":
        train["vis_embed"] = rng.standard_normal(
            (B, c.n_vis_tokens, c.d_model)).astype(np.float32)
    if c.encoder_layers:
        train["frames"] = 0.1 * rng.standard_normal(
            (B, S, c.d_model)).astype(np.float32)
    return {"tokens": toks, "prefill": prefill, "train": train}


def shrink_parts(key: str):
    """(ArchConfig, ParallelConfig, AdamWConfig, DataConfig) of a shrink
    run: reduced qwen3-0.6b, 4 x 16 tokens a step; "twice" at d_model 48,
    d_ff 96 and 12 rows, which 3 data ranks divide."""
    from repro_torch.data import DataConfig
    over, batch = ({"d_model": 48, "d_ff": 96}, 12) if key == "twice" \
        else ({}, 4)
    return (reduced_config(get_config(SHRINK_ARCH), **over),
            ParallelConfig(remat="none"), adamw.AdamWConfig(lr=LR),
            DataConfig(global_batch=batch, seq_len=SHRINK_SEQ, seed=1))


def shrink_trainer(key: str, ckpt_dir: str, engine=None):
    """The `Trainer` of shrink run `key`, stacked on the CPU or on
    `engine`."""
    from repro_torch.runtime import FailureInjector, Trainer, TrainerConfig
    m, fails, steps = SHRINK_RUNS[key]
    arch, p, opt, data = shrink_parts(key)
    return Trainer(arch, p, m, opt, data,
                   TrainerConfig(total_steps=steps, ckpt_dir=ckpt_dir,
                                 ckpt_every=100),
                   injector=FailureInjector(rank_fail_at=fails),
                   device="cpu", engine=engine)


def perturb_replicated(trainer, seen: dict):
    """Wrap `trainer._shrink_to_survivors` so that, before the shrink, the
    data-axis position 1 adds 1 to its copy of `final_norm` (a leaf
    replicated along 'data'): the survivor of a non-prefix shrink must
    carry on from that copy. `seen` gets the copy before and the leaf
    after."""
    real = trainer._shrink_to_survivors

    def shrink(failure):
        params = failure.state[0]
        if trainer.coords is None:
            params["final_norm"][:, 1] += 1.0
            seen["before"] = params["final_norm"][:, 1].clone()
        elif trainer.coords["data"] == 1:
            params["final_norm"] += 1.0
            seen["before"] = params["final_norm"].clone()
        out = real(failure)
        if out is not None:
            seen["after"] = out[0]["final_norm"].clone()
        return out
    trainer._shrink_to_survivors = shrink


# --------------------------------------------------------------------------
# What each process runs
# --------------------------------------------------------------------------

def _serve(case, eng, st, out):
    c, p, m, coords = cfg(case), pcfg(case), mesh(case), eng.coords
    s_enc = S_ENC if c.encoder_layers else 0
    params = convert.lm_params_from_jax(st["params"], c, m, serve=True,
                                        coords=coords)
    toks = torch.from_numpy(st["inputs"]["tokens"])
    # teacher-forced decode from zero caches
    dstep, _, _, _ = stages.build_decode_step(c, p, m, s_max=S,
                                              global_batch=B, s_enc=s_enc,
                                              device="cpu", engine=eng)
    cache = stages.init_cache(c, p, m, tp(case), B, S, s_enc=s_enc,
                              device="cpu", coords=coords)
    spec = (stages.dp_axes(m, B), None)
    preds, log = [], []
    rec = record_collectives(eng, log)
    for t in range(DECODE):
        rec["active"] = t == DECODE - 1 and case in RECORDED_CASES
        nxt, cache = dstep(params, cache, convert.shard_of(
            toks[:, t:t + 1], m, spec, coords), t)
        preds.append(nxt)
    unrecord(eng)
    out["decode"] = {"preds": torch.stack(preds, 1), "caches": cache,
                     "collectives": log}
    # prefill of the whole prompt (with the family's prefix or frames)
    pf, _, _, bspec = stages.build_prefill(c, p, m, B, S, device="cpu",
                                           engine=eng)
    batch = {k: convert.shard_of(torch.from_numpy(v), m, bspec[k], coords)
             for k, v in st["inputs"]["prefill"].items()}
    nxt, caches = pf(params, batch)
    out["prefill"] = {"next": nxt, "caches": caches}
    if c.encoder_layers:
        # the audio family's pieces: the handoff carries the cross cache
        caches = convert_prefill_caches(caches, c, p, m, tp(case), B, S,
                                        S + GEN, s_enc=s_enc, engine=eng)
        dstep, _, _, _ = stages.build_decode_step(
            c, p, m, s_max=S + GEN, global_batch=B, s_enc=s_enc,
            device="cpu", engine=eng)
        made = [nxt]
        for i in range(GEN - 1):
            nxt, caches = dstep(params, caches, nxt[..., None], S + i)
            made.append(nxt)
        out["pieces"] = convert.gather_global(
            torch.stack(made, -1), (spec[0], None), eng)
    else:
        sess = ServeSession(c, p, m, tp(case), B, S, S + GEN, device="cpu",
                            engine=eng)
        out["session"] = sess.generate(params, toks, GEN)


def _train(case, eng, st, out):
    c, m, coords = cfg(case), mesh(case), eng.coords
    ts = stages.build_train_step(c, pcfg(case), m, adamw.AdamWConfig(lr=LR),
                                 device="cpu", engine=eng)
    params = convert.lm_params_from_jax(st["params"], c, m, coords=coords)
    state = convert.opt_state_from_jax(st["opt"], c, m, coords=coords)
    log = []
    rec = record_collectives(eng, log)
    rec["active"] = case in RECORDED_CASES
    _p, _s, metrics = ts.fn(params, state, ts.put_batch(st["inputs"]
                                                        ["train"]), 0)
    unrecord(eng)
    out["train"] = {"metrics": {k: float(v) for k, v in metrics.items()},
                    "params": params, "opt": state, "collectives": log}


def _shrink(key, outdir, out):
    """One shrink run of the per-process `Trainer`: its log, the mesh it
    ends on, its engine's members and, in the non-prefix run, the
    survivor's copy of the perturbed replicated leaf."""
    from repro_torch.runtime.health import RankFailure
    eng = stages.process_engine(SHRINK_RUNS[key][0], device="cpu")
    t = shrink_trainer(key, f"{outdir}/ckpt_{key}", engine=eng)
    seen: dict = {}
    if key == "data0":
        perturb_replicated(t, seen)
    try:
        log = t.run()
    except RankFailure as e:
        out["shrink", key] = {"raised": str(e)}
        return
    now = t.ts.ctx.engine
    out["shrink", key] = {"log": log, "mesh": dict(t.mesh), "seen": seen,
                          "members": list(now.members),
                          "coords": dict(now.coords)}


def run(rank: int, n: int, outdir: str) -> None:
    from repro_torch.core.procgroup import ProcessGroupEngine
    torch.set_num_threads(1)
    state = torch.load(f"{outdir}/state.pt", weights_only=False)
    engines = {tuple(m.items()): ProcessGroupEngine(m, device="cpu")
               for m in (MESH, PE_MESH)}
    out = {}
    for case in CASES:
        eng = engines[tuple(mesh(case).items())]
        res = out[case] = {"coords": dict(eng.coords)}
        _serve(case, eng, state[case], res)
        _train(case, eng, state[case], res)
    for key in SHRINK_RUNS:
        _shrink(key, outdir, out)
    torch.save(out, f"{outdir}/rank{rank}.pt")
