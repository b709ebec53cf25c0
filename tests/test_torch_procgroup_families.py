"""The MoE, SSM, hybrid, audio and VLM families and the `Trainer`'s
elastic shrink one rank per process, against the JAX package and the
stacked port.

One spawned world of 4 processes (`launch/procs.spawn`, gloo, the CPU)
runs `_torch_fam_procs_cases.py::run`: reduced qwen3-moe-30b-a3b,
mamba2-1.3b, hymba-1.5b (5 SSM heads padded to 6), whisper-medium and
internvl2-26b on the (pod, data, model) = (1, 2, 2) mesh, and mixtral
with one expert on (1, 1, 4), where it splits into four pseudo-experts;
params and AdamW state are the JAX package's own init (`state.pt`). The
parent stacks each rank's local results and holds them, per family:
  * 4 teacher-forced decode steps from zero caches (the MoE's
    replicated dispatch at every step: one token does not split over EP;
    the SSM's carries) and the prefill (the VLM's visual prefix, the
    audio encoder over its stub frames, the SSM's final carries): tokens
    EQUAL the JAX package's, caches within rtol = atol = 1e-5;
  * the serve session (every family it serves) and the audio family's
    pieces (prefill, `convert_prefill_caches(s_enc=, engine=)`, decode
    reading the cross cache): tokens EQUAL the JAX package's;
  * one train step (the MoE's aux term 0-d per process): metrics, params
    and AdamW state within `test_torch_train.py`'s tolerances of the JAX
    package's step;
  * the MoE's and the SSM's decode and train step collectives, replayed
    on the stacked engine on the ranks' own operands: BITWISE.
And the shrink, against the stacked `Trainer` from the same seed:
  * data rank 1 dies at step 4 of 8, from the JAX package's checkpoint
    after step 1: the survivors' metrics within rtol 1e-5 of the stacked
    run's and of the JAX package's `Trainer` through the same failure,
    the same event row, survivors and shrunk mesh; the processes at the
    dead position leave `run()`, the world joins; the final checkpoint,
    written by the survivors' rank 0, loads into the stacked port within
    the train step's tolerances;
  * data rank 0 dies (not a prefix): the survivor carries on from its
    own copy of a replicated leaf;
  * two failures in a row on (1, 4, 1), 4 -> 3 -> 2 data ranks: the
    processes that left at the first join the second's groups;
  * a failure with no survivors re-raises on every process.
"""
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_fam_procs_cases as C
from _torch_train_cases import METRIC_TOL, METRICS, MOMENT_RTOL, PARAM_ATOL
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.configs.base import ParallelConfig as JaxParallelConfig
from repro.core.topology import make_mesh
from repro.optim import adamw as jax_adamw
from repro.parallel import stages as jax_stages
from repro.runtime.serve_session import ServeSession as JaxSession
from repro.runtime.serve_session import \
    convert_prefill_caches as jax_convert_prefill_caches
from repro_torch import convert
from repro_torch.checkpoint import latest_step, load_checkpoint
from repro_torch.core import CollectiveEngine
from repro_torch.launch import procs
from repro_torch.models import attention
from repro_torch.optim import adamw
from repro_torch.parallel import stages
from repro_torch.tree import flatten, tree_map

TOL = dict(rtol=1e-5, atol=1e-5)
SERVED = [c for c in C.CASES if not C.cfg(c).encoder_layers]
_WORLD: dict = {}


def lead(case) -> tuple:
    return tuple(C.mesh(case).values())


def dp(case):
    return stages.dp_axes(C.mesh(case), C.B)


@functools.lru_cache(maxsize=None)
def jax_mesh(case):
    m = C.mesh(case)
    return make_mesh(tuple(m.values()), tuple(m))


@functools.lru_cache(maxsize=None)
def jcfg(case):
    arch, over, _, _ = C.CASES[case]
    return jax_reduced_config(jax_get_config(arch), **over)


def jpcfg(case, **kw):
    return JaxParallelConfig(remat="none", **{**C.CASES[case][2], **kw})


@functools.lru_cache(maxsize=None)
def jax_state(case):
    params = jax_stages.init_params(jcfg(case), jax_mesh(case), C.tp(case),
                                    seed=0)
    return params, jax_adamw.adamw_init(params)


def state_np(case) -> dict:
    params, opt = jax_state(case)
    return {"params": jax.tree.map(np.asarray, params),
            "opt": jax.tree.map(np.asarray, opt), "inputs": C.inputs(case)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The per-rank results of one spawned 4-process world."""
    if not _WORLD:
        d = tmp_path_factory.mktemp("fam_procs")
        torch.save({case: state_np(case) for case in C.CASES},
                   d / "state.pt")
        _WORLD["jax_ckpt"] = str(tmp_path_factory.mktemp("jax_shrink"))
        _WORLD["jax_shrink"] = jax_shrink(_WORLD["jax_ckpt"])
        jax_ckpt_into(str(d / "ckpt_data1"))
        procs.spawn(C.run, C.N, backend="gloo", device="cpu", args=(str(d),))
        _WORLD["dir"] = d
        _WORLD["ranks"] = [torch.load(d / f"rank{r}.pt", weights_only=False)
                           for r in range(C.N)]
    return _WORLD


def _part(world, *key):
    res = list(world["ranks"])
    for k in key:
        res = [x[k] for x in res]
    return res


def _stack(tensors, shape):
    """Per-rank local tensors (global rank order) -> mesh-stacked."""
    return torch.stack(tensors).reshape(shape + tuple(tensors[0].shape))


def _stack_tree(trees, shape, path=()):
    """Per-rank local trees (dicts and lists) -> the stacked tree, layer
    dims in front; 0-d leaves as they are."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_tree([t[k] for t in trees], shape, path + (k,))
                for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack_tree(list(ts), shape, path + (i,))
                           for i, ts in enumerate(zip(*trees)))
    if first.ndim == 0:
        return first
    st = _stack(list(trees), shape)
    if any(k in ("layers", "enc_layers") for k in path):
        st = st.movedim(len(shape), 0)
    return st


# --------------------------------------------------------------------------
# Serving
# --------------------------------------------------------------------------

def _s_enc(case) -> int:
    return C.S_ENC if C.cfg(case).encoder_layers else 0


@functools.lru_cache(maxsize=None)
def jax_decode(case):
    dstep, _, _, _ = jax_stages.build_decode_step(
        jcfg(case), jpcfg(case), jax_mesh(case), s_max=C.S,
        global_batch=C.B, s_enc=_s_enc(case))
    cache = jax_stages.init_cache(jcfg(case), jpcfg(case), jax_mesh(case),
                                  C.tp(case), C.B, C.S, s_enc=_s_enc(case))
    toks, preds = C.inputs(case)["tokens"], []
    for t in range(C.DECODE):
        nxt, cache = dstep(jax_state(case)[0], cache,
                           jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        preds.append(np.asarray(nxt))
    return np.stack(preds, 1), jax.tree.map(np.asarray, cache)


@pytest.mark.parametrize("case", list(C.CASES))
def test_decode_tokens_and_caches(world, case):
    """4 teacher-forced decode steps one rank per process: tokens EQUAL
    the JAX package's, the caches (SSM `conv` / `state`, the cross cache)
    within 1e-5."""
    m, shape = C.mesh(case), lead(case)
    preds = convert.unstack(_stack(_part(world, case, "decode", "preds"),
                                   shape), m, (dp(case), None))
    want, jcache = jax_decode(case)
    np.testing.assert_array_equal(preds.numpy(), want)
    caches = _stack_tree(_part(world, case, "decode", "caches"), shape)
    got = convert.decode_caches_to_jax(caches, C.cfg(case), C.pcfg(case), m,
                                       C.B, C.S, s_enc=_s_enc(case))
    for layer, (g, w) in enumerate(zip(got, jcache)):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], err_msg=f"{layer} {k}",
                                       **TOL)


@functools.lru_cache(maxsize=None)
def jax_prefill(case):
    pf, _, _, _ = jax_stages.build_prefill(jcfg(case), jpcfg(case),
                                           jax_mesh(case), C.B, C.S)
    batch = {k: jnp.asarray(v) for k, v in C.inputs(case)["prefill"].items()}
    nxt, caches = pf(jax_state(case)[0], batch)
    return np.asarray(nxt), jax.tree.map(np.asarray, caches)


def _owner_gathered(cache, case):
    """A replicated-KV prefill cache as the reference emits it: each TP
    rank's slice of the sequence holds its local q heads' owner kv heads
    (the port's holds the kv heads themselves, the layout decode reads:
    ROADMAP Queue 3)."""
    cfg, t = C.cfg(case), C.tp(case)
    hl = -(-cfg.n_heads // t)
    group = max(cfg.n_heads // cfg.n_kv_heads, 1)
    sl = cache.shape[-3] // t
    parts = []
    for r in range(t):
        owner = np.clip((r * hl + np.arange(hl)) // group, 0,
                        cfg.n_kv_heads - 1)
        parts.append(cache[..., r * sl:(r + 1) * sl, :, :][..., owner, :])
    return np.concatenate(parts, axis=-3)


@pytest.mark.parametrize("case", list(C.CASES))
def test_prefill_tokens_and_caches(world, case):
    """The prefill one rank per process (the VLM's prefix and the audio
    frames cut to each process's rows): the next token EQUALS the JAX
    package's, every cache within 1e-5 (a replicated-KV cache once
    gathered through its owners)."""
    m, shape, cfg = C.mesh(case), lead(case), C.cfg(case)
    nxt = convert.unstack(_stack(_part(world, case, "prefill", "next"),
                                 shape), m, (dp(case),))
    want, jcaches = jax_prefill(case)
    np.testing.assert_array_equal(nxt.numpy(), want)
    caches = tuple(_stack(list(c), shape).movedim(len(shape), 0) for c in
                   zip(*_part(world, case, "prefill", "caches")))
    got = convert.prefill_caches_to_jax(caches, cfg, C.pcfg(case), m, C.B,
                                        C.S)
    for i, (g, w) in enumerate(zip(got, jcaches)):
        if i < 2 and cfg.has_attention and \
                not attention.kv_layout(cfg, C.tp(case))[1]:
            g = _owner_gathered(g, case)
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g, w, err_msg=str(i), **TOL)


@functools.lru_cache(maxsize=None)
def jax_generate(case):
    """The JAX package's greedy continuation of the prompt: its session,
    or where its session cannot serve the case (the KV heads replicated,
    whose prefill cache its decode misreads; the VLM, whose prefill wants
    a prefix the session does not pass: ROADMAP Queue 3) its decode-only
    loop, teacher-forced over the prompt and then free-running."""
    toks = C.inputs(case)["tokens"]
    if attention.kv_layout(C.cfg(case), C.tp(case))[1] and \
            C.cfg(case).family != "vlm":
        jsess = JaxSession(jcfg(case), jpcfg(case), jax_mesh(case),
                           C.tp(case), C.B, C.S, C.S + C.GEN)
        return np.asarray(jsess.generate(jax_state(case)[0],
                                         jnp.asarray(toks), C.GEN))
    dstep, _, _, _ = jax_stages.build_decode_step(
        jcfg(case), jpcfg(case), jax_mesh(case), s_max=C.S + C.GEN,
        global_batch=C.B)
    cache = jax_stages.init_cache(jcfg(case), jpcfg(case), jax_mesh(case),
                                  C.tp(case), C.B, C.S + C.GEN)
    tok, made = jnp.asarray(toks[:, :1]), []
    for t in range(C.S + C.GEN - 1):
        nxt, cache = dstep(jax_state(case)[0], cache, tok, jnp.int32(t))
        if t + 1 < C.S:
            tok = jnp.asarray(toks[:, t + 1:t + 2])
        else:
            made.append(np.asarray(nxt))
            tok = nxt[:, None].astype(jnp.int32)
    return np.stack(made, 1)


@pytest.mark.parametrize("case", SERVED)
def test_serve_session(world, case):
    """The session one rank per process (prefill, the handoff of the k/v
    and the SSM carries through the engine, decode) generates the JAX
    package's tokens on every process: its session's, or its decode
    loop's where its session cannot serve the case (mixtral's KV heads
    replicated on TP 4; the VLM, served a text prompt)."""
    want = jax_generate(case)
    for got in _part(world, case, "session"):
        np.testing.assert_array_equal(got.numpy(), want)


def test_audio_pieces(world):
    """whisper one rank per process through `build_prefill` (frames cut to
    each process's rows), `convert_prefill_caches(s_enc=, engine=)` and
    `build_decode_step(s_enc=)`: every process's tokens EQUAL the JAX
    package's pieces'."""
    case = "whisper"
    _, jcaches = jax_prefill(case)
    want = [jax_prefill(case)[0]]
    s_max = C.S + C.GEN
    caches = jax_convert_prefill_caches(
        jcaches, jcfg(case), jpcfg(case), jax_mesh(case), C.tp(case), C.B,
        C.S, s_max, s_enc=C.S_ENC)
    jstep, _, _, _ = jax_stages.build_decode_step(
        jcfg(case), jpcfg(case), jax_mesh(case), s_max=s_max,
        global_batch=C.B, s_enc=C.S_ENC)
    for i in range(C.GEN - 1):
        nxt, caches = jstep(jax_state(case)[0], caches,
                            jnp.asarray(want[-1])[:, None].astype(jnp.int32),
                            jnp.int32(C.S + i))
        want.append(np.asarray(nxt))
    for got in _part(world, case, "pieces"):
        np.testing.assert_array_equal(got.numpy(), np.stack(want, 1))


@pytest.mark.parametrize("case", list(C.CASES))
def test_local_shards_every_family(case):
    """`convert.lm_params_from_jax(..., coords=)` and `opt_state_from_jax(...,
    coords=)` give each process the rows of the stacked trees, and
    `convert.local_params` cuts the same rows from them: every family's
    leaves (the untied head, the encoder stack and its norm, the experts'
    and the router's, the SSM's fp32 leaves), in both layouts, bitwise."""
    m, cfg, st = C.mesh(case), C.cfg(case), state_np(case)
    trees = [(convert.lm_params_from_jax(st["params"], cfg, m, serve=sv),
              lambda c, sv=sv: convert.lm_params_from_jax(
                  st["params"], cfg, m, serve=sv, coords=c))
             for sv in (False, True)]
    trees.append((convert.opt_state_from_jax(st["opt"], cfg, m),
                  lambda c: convert.opt_state_from_jax(st["opt"], cfg, m,
                                                       coords=c)))
    for stacked, local in trees:
        for idx in np.ndindex(*lead(case)):
            coords = dict(zip(m, idx))
            want = convert.local_params(stacked, m, coords)
            got = local(coords)
            pairs = list(zip(flatten(got), flatten(want)))
            assert len(pairs) == len(flatten(want))
            for (path, a), (_, b) in pairs:
                assert a.dtype == b.dtype and torch.equal(a, b), (path,
                                                                  coords)


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_step(case):
    ts = jax_stages.build_train_step(jcfg(case), jpcfg(case), jax_mesh(case),
                                     jax_adamw.AdamWConfig(lr=C.LR))
    params = jax.tree.map(jnp.copy, jax_state(case)[0])
    state = jax_adamw.adamw_init(params)
    batch = {k: jnp.asarray(v) for k, v in C.inputs(case)["train"].items()}
    new_p, new_s, m = ts.fn(params, state, batch, jnp.int32(0))
    return ({k: float(v) for k, v in m.items()},
            jax.tree.map(np.asarray, new_p), jax.tree.map(np.asarray, new_s))


def _close_state(got_p, got_s, want_p, want_s):
    """`_torch_train_cases.check_step`'s tolerances: params and masters
    within PARAM_ATOL, moments within MOMENT_RTOL of the leaf's largest
    entry, the count exactly."""
    for (path, a), b in zip(jax.tree.flatten_with_path(want_p)[0],
                            jax.tree.leaves(got_p)):
        np.testing.assert_allclose(b, a, atol=PARAM_ATOL, rtol=0,
                                   err_msg=str(path))
    for (path, a), b in zip(jax.tree.flatten_with_path(want_s)[0],
                            jax.tree.leaves(got_s)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if "count" in str(path[0]):
            assert int(a) == int(b) == 1
        elif "master" in str(path[-1]):
            np.testing.assert_allclose(b, a, atol=PARAM_ATOL, rtol=0,
                                       err_msg=str(path))
        else:
            np.testing.assert_allclose(
                b, a, rtol=0, atol=MOMENT_RTOL * np.abs(a).max() + 1e-30,
                err_msg=str(path))


@pytest.mark.parametrize("case", list(C.CASES))
def test_train_step(world, case):
    """One FSDP x TP train step one rank per process: rank 0's metrics
    (the MoE's aux term included), the params and the AdamW state within
    the stacked port's tolerances of the JAX package's step."""
    res = _part(world, case, "train")
    jm, jp, js = jax_step(case)
    for k in METRICS:
        np.testing.assert_allclose(res[0]["metrics"][k], jm[k], err_msg=k,
                                   **METRIC_TOL)
    m, shape, cfg = C.mesh(case), lead(case), C.cfg(case)
    params = _stack_tree([r["params"] for r in res], shape)
    opt = _stack_tree([r["opt"] for r in res], shape)
    _close_state(convert.lm_params_to_jax(params, cfg, m),
                 convert.opt_state_to_jax(opt, cfg, m), jp, js)


# --------------------------------------------------------------------------
# Every collective bitwise the stacked engine's
# --------------------------------------------------------------------------

def _stack_arg(vals, shape):
    if isinstance(vals[0], torch.Tensor):
        return _stack(vals, shape) if vals[0].ndim else \
            torch.stack(vals).reshape(shape)
    if isinstance(vals[0], (list, tuple)):
        return type(vals[0])(_stack_arg(list(v), shape) for v in zip(*vals))
    assert all(v == vals[0] for v in vals[1:]), vals
    return vals[0]


@pytest.mark.parametrize("part", ["decode", "train"])
@pytest.mark.parametrize("case", C.RECORDED_CASES)
def test_collectives_bitwise_stacked(world, case, part):
    """Each engine collective of a decode step and of a train step
    (forward, backward, grad sync) of the MoE (its EP all-to-alls, the
    pseudo-experts' too) and of the SSM (the gated norm's allreduce),
    replayed on the stacked engine with every rank's own operands: each
    rank's result BITWISE the stacked row."""
    shape = lead(case)
    logs = [r["collectives"] for r in _part(world, case, part)]
    assert len(logs[0]) > 0 and all(len(g) == len(logs[0]) for g in logs)
    eng = CollectiveEngine(C.mesh(case), device="cpu")
    names = set()
    for calls in zip(*logs):
        name = calls[0]["name"]
        names.add(name)
        assert all(c["name"] == name for c in calls)
        args = _stack_arg([c["args"] for c in calls], shape)
        kwargs = {k: _stack_arg([c["kwargs"][k] for c in calls], shape)
                  for k in calls[0]["kwargs"]}
        if name == "itree_allreduce":
            name = "tree_allreduce"    # the queue is bitwise the blocking
        want = getattr(eng, name)(*args, **kwargs)
        if isinstance(want, torch.Tensor):
            want, outs = [want], [[c["out"]] for c in calls]
        else:
            outs = [c["out"] for c in calls]
        for j, w in enumerate(want):
            rows = list(w.reshape((-1,) + tuple(w.shape[len(shape):])))
            for r, row in enumerate(rows):
                assert torch.equal(outs[r][j], row), (name, j, r)
    assert "allreduce" in names
    if C.cfg(case).family == "moe":
        assert "alltoall" in names


# --------------------------------------------------------------------------
# The elastic shrink one rank per process
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stacked_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("stacked_shrink")


def jax_shrink(directory: str) -> list:
    """The JAX package's `Trainer` through shrink run "data1" (the same
    config, data and failure), keeping its checkpoints under
    `directory`: its log."""
    from repro.data import DataConfig as JaxDataConfig
    from repro.runtime import FailureInjector as JaxInjector
    from repro.runtime import Trainer as JaxTrainer
    from repro.runtime import TrainerConfig as JaxTrainerConfig
    m, fails, steps = C.SHRINK_RUNS["data1"]
    _arch, _p, _opt, data = C.shrink_parts("data1")
    t = JaxTrainer(jax_reduced_config(jax_get_config(C.SHRINK_ARCH)),
                   JaxParallelConfig(remat="none"),
                   make_mesh(tuple(m.values()), tuple(m)),
                   jax_adamw.AdamWConfig(lr=C.LR),
                   JaxDataConfig(global_batch=data.global_batch,
                                 seq_len=data.seq_len, seed=data.seed),
                   JaxTrainerConfig(total_steps=steps, ckpt_dir=directory,
                                    ckpt_every=C.SHRINK_FROM + 1,
                                    keep=steps),
                   injector=JaxInjector(rank_fail_at=fails))
    return t.run()


def jax_ckpt_into(directory: str) -> None:
    """Put the JAX package's checkpoint after step SHRINK_FROM into
    `directory`: a "data1" run there resumes from it."""
    name = f"step_{C.SHRINK_FROM:09d}"
    shutil.copytree(f"{_WORLD['jax_ckpt']}/{name}", f"{directory}/{name}")


@functools.lru_cache(maxsize=None)
def stacked_shrink(key, directory):
    """The stacked `Trainer`'s run of a shrink case, its checkpoints
    under `directory`: (log, mesh, the replicated leaf's copies seen)."""
    if key == "data1":
        jax_ckpt_into(f"{directory}/{key}")
    t = C.shrink_trainer(key, f"{directory}/{key}")
    seen: dict = {}
    if key == "data0":
        C.perturb_replicated(t, seen)
    return t.run(), dict(t.mesh), seen


def _steps(log) -> list:
    return [r for r in log if "step" in r and "event" not in r]


def _events(log) -> list:
    return [{k: v for k, v in r.items() if k != "error"} for r in log
            if "event" in r]


@pytest.mark.parametrize("key", ["data1", "data0"])
def test_shrink_matches_stacked(world, stacked_dir, key):
    """Data rank 1 (from the JAX package's checkpoint after step 1; or 0:
    not a prefix) dies at step 4 of 8: every process logs the steps
    before it; the survivors carry on over an
    engine of their own on the shrunk mesh, with the stacked `Trainer`'s
    metrics (rtol 1e-5), event row, survivors and mesh; the processes at
    the dead position leave after the handoff with the event row and a
    'left' row, and the world joins (the spawn returned). In the
    non-prefix run the survivor carries on from its own copy of a
    replicated leaf."""
    log, mesh, seen = stacked_shrink(key, str(stacked_dir))
    res = _part(world, ("shrink", key))
    (fail, dead), = C.SHRINK_RUNS[key][1]
    first = C.SHRINK_FROM + 1 if key == "data1" else 0
    want_steps = _steps(log)
    assert want_steps[0]["step"] == first
    leavers = [r for r in range(C.N)
               if res[r]["log"][-1].get("event") == "left"]
    survivors = [r for r in range(C.N) if r not in leavers]
    # (1, 2, 2): global rank r sits at data r // 2
    assert leavers == [r for r in range(C.N) if r // 2 == dead]
    for r in survivors:
        got = res[r]
        assert got["mesh"] == mesh == {"pod": 1, "data": 1, "model": 2}
        assert got["members"] == [g for g in range(C.N) if g // 2 != dead]
        assert _events(got["log"]) == _events(log)
        assert [s["step"] for s in _steps(got["log"])] == \
            [s["step"] for s in want_steps]
    for r in range(C.N):
        for a, b in zip(_steps(res[r]["log"]), want_steps):
            for k in METRICS:
                # `loss` is the process's own rows' (the stacked run's is
                # mesh position 0's): equal where those rows are the same
                if k != "loss" or r // 2 == 0 or a["step"] >= fail:
                    np.testing.assert_allclose(a[k], b[k], err_msg=k,
                                               **METRIC_TOL)
    for r in leavers:
        got = res[r]["log"]
        assert [s["step"] for s in _steps(got)] == list(range(first, fail))
        assert _events(got)[:-1] == _events(log)
        assert got[-1]["event"] == "left" and got[-1]["global_rank"] == r
    if key == "data0":
        for r in survivors:
            s = res[r]["seen"]
            assert torch.equal(s["after"], s["before"])
        assert torch.equal(seen["after"][:, 0], seen["before"])


def test_shrink_checkpoint_loads_stacked(world, stacked_dir):
    """The per-process run's final checkpoint, written after the shrink by
    the survivors' rank 0, holds the stacked shrink run's final state
    within the train step's tolerances, loaded into the stacked port on
    the shrunk mesh."""
    log, mesh, _ = stacked_shrink("data1", str(stacked_dir))
    d_proc = str(world["dir"] / "ckpt_data1")
    step = latest_step(d_proc)
    assert step == C.SHRINK_RUNS["data1"][2] - 1
    cfg = C.shrink_parts("data1")[0]
    specs = stages.param_specs(cfg, mesh["model"])
    specs = {"params": specs, "opt": adamw.opt_specs(specs)}
    shapes = stages.param_shapes(cfg, mesh, mesh["model"])
    like = {"params": shapes, "opt": {
        "leaves": tree_map(lambda p: {n: p.float() for n in
                                      ("master", "m", "v")}, shapes),
        "count": torch.empty((), dtype=torch.int32, device="meta")}}
    got, _ = load_checkpoint(d_proc, step, like, specs, mesh)
    d_stacked = str(stacked_dir / "data1")
    want, _ = load_checkpoint(d_stacked, latest_step(d_stacked), like, specs,
                              mesh)
    for (path, a), (_, b) in zip(flatten(got), flatten(want)):
        a, b = a.double().numpy(), b.double().numpy()
        if path[-1] in ("m", "v"):
            np.testing.assert_allclose(
                a, b, rtol=0, atol=MOMENT_RTOL * np.abs(b).max() + 1e-30,
                err_msg=str(path))
        else:
            np.testing.assert_allclose(a, b, atol=PARAM_ATOL, rtol=0,
                                       err_msg=str(path))


def test_shrink_without_survivors_reraises(world):
    """A dead rank on an axis of size 1 leaves no survivors: the
    `RankFailure` re-raises on every process, as the stacked one does."""
    for got in _part(world, ("shrink", "none")):
        assert "injected rank 0 loss at step 2" in got["raised"]


def test_shrink_matches_jax(world):
    """The per-process run "data1" from the JAX package's checkpoint
    after step 1, against the JAX package's `Trainer` through the same
    failure: every step's ce_mean within rtol 1e-5 on every process
    (before the shrink and, on the survivors, after it), the same
    survivors and shrunk mesh."""
    want = _steps(world["jax_shrink"])
    event = next(r for r in world["jax_shrink"] if "event" in r)
    for got in _part(world, ("shrink", "data1")):
        ev = next(r for r in got["log"] if "event" in r)
        assert (ev["rank"], ev["survivors"], ev["mesh_shape"]) == \
            (event["rank"], event["survivors"], dict(event["mesh_shape"]))
        steps = _steps(got["log"])
        assert steps and steps[0]["step"] == C.SHRINK_FROM + 1
        byst = {r["step"]: r for r in want}
        for s in steps:
            np.testing.assert_allclose(s["ce_mean"], byst[s["step"]]
                                       ["ce_mean"], err_msg=str(s["step"]),
                                       **METRIC_TOL)


def test_shrink_twice_matches_stacked(world, stacked_dir):
    """Two failures on (1, 4, 1): data rank 1 dies at step 2, then rank 0
    of the 3 survivors (global 0) at step 4. Each process that leaves
    logs its steps, its events and a 'left' row, and the process that
    left first joins the second shrink's groups; the survivors, global
    ranks 2 and 3, end on (1, 2, 1) with the stacked run's events,
    survivors and metrics (rtol 1e-5; `loss` where the process holds the
    stacked run's rows, mesh position 0)."""
    log, mesh, _ = stacked_shrink("twice", str(stacked_dir))
    res = _part(world, ("shrink", "twice"))
    assert mesh == {"pod": 1, "data": 2, "model": 1}
    assert [e["survivors"] for e in _events(log)] == [[0, 2, 3], [2, 3]]
    want = {r["step"]: r for r in _steps(log)}
    left_at = {1: 2, 0: 4}
    for r in range(C.N):
        got = res[r]["log"]
        if r in left_at:
            assert got[-1]["event"] == "left" and got[-1]["global_rank"] == r
            assert [s["step"] for s in _steps(got)] == \
                list(range(left_at[r]))
            assert _events(got)[:-1] == _events(log)[:1 + (r == 0)]
        else:
            assert res[r]["mesh"] == mesh and res[r]["members"] == [2, 3]
            assert _events(got) == _events(log)
            assert [s["step"] for s in _steps(got)] == sorted(want)
        for s in _steps(got):
            root = 0 if s["step"] < 4 else 2
            for k in METRICS:
                if k != "loss" or r == root:
                    np.testing.assert_allclose(s[k], want[s["step"]][k],
                                               err_msg=f"{k} {s['step']}",
                                               **METRIC_TOL)
