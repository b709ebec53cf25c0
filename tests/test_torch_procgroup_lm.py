"""LM serving and training one rank per process against the JAX package
and the stacked port.

One spawned world of 4 processes (`launch/procs.spawn`, gloo, the CPU)
runs `_torch_lm_procs_cases.py::run`: reduced qwen3-0.6b on the (pod,
data, model) = (1, 2, 2) mesh (FSDP 2 x TP 2), params and AdamW state
carried across from the JAX package's init (`state.pt`). The parent
stacks each rank's local results and holds them:
  * teacher-forced decode and prefill: tokens EQUAL the JAX package's
    and the stacked port's, caches within rtol = atol = 1e-5;
  * the serve session (prefill, the cache handoff through the engine,
    decode): tokens EQUAL both;
  * one train step (base, int8 grad buckets, SP + collective_matmul):
    the metrics, params and AdamW state within `test_torch_train.py`'s
    tolerances of the JAX package's step, and of the stacked port's;
  * every engine collective of a decode step and of a train step,
    replayed on the stacked engine on the ranks' own operands: BITWISE;
  * the grads of `allgather_matmul`, `matmul_reduce_scatter` and
    `ring_attention` per process against `jax.grad` of the reference
    engine under `shard_map` and the stacked port's (1e-5);
  * a checkpoint written by the world loads into the stacked port and
    through the reference's `checkpoint/store.py`, every leaf bitwise;
    a stacked checkpoint restores into the world as its local shards.
The launchers: `launch.train --procs 4` and `launch.serve --procs 4`
(and `launch.serve` under torchrun) give the stacked launchers' loss and
tokens, for qwen3-0.6b and for a non-dense family each (the MoE trained,
the hybrid served); whisper's serve refuses as the stacked one does;
without `--device cpu` they raise where there is no card.
"""
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_lm_procs_cases as C
from _torch_train_cases import METRIC_TOL, METRICS, MOMENT_RTOL, PARAM_ATOL
from repro.checkpoint import load_checkpoint as jax_load
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.configs.base import ParallelConfig as JaxParallelConfig
from repro.core import CollectiveEngine as JaxEngine
from repro.core.compat import shard_map
from repro.core.topology import make_mesh
from repro.optim import adamw as jax_adamw
from repro.parallel import stages as jax_stages
from repro.runtime.serve_session import ServeSession as JaxSession
from repro_torch import convert
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.core import CollectiveEngine
from repro_torch.launch import procs
from repro_torch.optim import adamw
from repro_torch.parallel import stages
from repro_torch.runtime.serve_session import ServeSession
from repro_torch.tree import flatten

MESH = C.MESH
LEAD = tuple(MESH.values())
TOL = dict(rtol=1e-5, atol=1e-5)
DP = stages.dp_axes(MESH, C.B)
_WORLD: dict = {}


@functools.lru_cache(maxsize=None)
def jax_mesh():
    return make_mesh(LEAD, tuple(MESH))


@functools.lru_cache(maxsize=None)
def jcfg():
    return jax_reduced_config(jax_get_config(C.ARCH))


def jpcfg(**kw):
    return JaxParallelConfig(remat="none", **kw)


@functools.lru_cache(maxsize=None)
def jax_state():
    params = jax_stages.init_params(jcfg(), jax_mesh(), 2, seed=0)
    return params, jax_adamw.adamw_init(params)


def state_np():
    params, opt = jax_state()
    return {"params": jax.tree.map(np.asarray, params),
            "opt": jax.tree.map(np.asarray, opt)}


def _specs():
    specs = stages.param_specs(C.cfg(), 2)
    return {"params": specs, "opt": adamw.opt_specs(specs)}


@functools.lru_cache(maxsize=None)
def stacked_step(key):
    """(metrics, params, opt state) of the stacked port's train step from
    the JAX init."""
    kw = dict(C.TRAIN_CASES)[key]
    ts = stages.build_train_step(C.cfg(), C.pcfg(**kw), MESH,
                                 adamw.AdamWConfig(lr=C.LR), device="cpu")
    st = state_np()
    params = convert.lm_params_from_jax(st["params"], C.cfg(), MESH)
    opt = convert.opt_state_from_jax(st["opt"], C.cfg(), MESH)
    _p, _s, m = ts.fn(params, opt, ts.put_batch(C.train_batch()), 0)
    return {k: float(v) for k, v in m.items()}, params, opt


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The per-rank results of one spawned 4-process world."""
    if not _WORLD:
        d = tmp_path_factory.mktemp("lm_procs")
        torch.save(state_np(), d / "state.pt")
        # a stacked checkpoint (after one step) for the world to restore
        _m, params, opt = stacked_step("base")
        _WORLD["ckpt_tree"] = {"params": params, "opt": opt}
        save_checkpoint(str(d / "ckpt_stacked"), 7, _WORLD["ckpt_tree"],
                        _specs(), mesh_shape=MESH)
        procs.spawn(C.run, C.N, backend="gloo", device="cpu", args=(str(d),))
        _WORLD["dir"] = d
        _WORLD["ranks"] = [torch.load(d / f"rank{r}.pt", weights_only=False)
                           for r in range(C.N)]
    return _WORLD


def _stack(tensors):
    """Per-rank local tensors (global rank order) -> mesh-stacked."""
    return torch.stack(tensors).reshape(LEAD + tuple(tensors[0].shape))


def _stack_tree(trees, path=()):
    """Per-rank local trees (dicts and lists) -> the stacked tree, layer
    dims in front; 0-d leaves as they are."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_tree([t[k] for t in trees], path + (k,))
                for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack_tree(list(ts), path + (i,))
                           for i, ts in enumerate(zip(*trees)))
    if first.ndim == 0:
        return first
    st = _stack(list(trees))
    if any(k in ("layers", "enc_layers") for k in path):
        st = st.movedim(len(LEAD), 0)
    return st


def _part(world, *key):
    res = [world["ranks"][r] for r in range(C.N)]
    for k in key:
        res = [x[k] for x in res]
    return res


# --------------------------------------------------------------------------
# Serving
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_decode():
    dstep, _, _, _ = jax_stages.build_decode_step(
        jcfg(), jpcfg(), jax_mesh(), s_max=C.S, global_batch=C.B)
    cache = jax_stages.init_cache(jcfg(), jpcfg(), jax_mesh(), 2, C.B, C.S)
    toks, preds = C.tokens(), []
    for t in range(C.S):
        nxt, cache = dstep(jax_state()[0], cache,
                           jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        preds.append(np.asarray(nxt))
    return np.stack(preds, 1), jax.tree.map(np.asarray, cache)


def stacked_decode():
    c, p = C.cfg(), C.pcfg()
    dstep, _, _, _ = stages.build_decode_step(c, p, MESH, s_max=C.S,
                                              global_batch=C.B, device="cpu")
    cache = stages.init_cache(c, p, MESH, 2, C.B, C.S, device="cpu")
    params = convert.lm_params_from_jax(state_np()["params"], c, MESH,
                                        serve=True)
    toks, preds = C.tokens(), []
    for t in range(C.S):
        nxt, cache = dstep(params, cache, convert.to_stacked(
            toks[:, t:t + 1], MESH, (DP, None)), t)
        preds.append(nxt)
    return torch.stack(preds, -1), cache


def test_decode_tokens_and_caches(world):
    """Teacher-forced decode one rank per process: tokens EQUAL the JAX
    package's and the stacked port's, caches within 1e-5 of both."""
    preds = convert.unstack(_stack(_part(world, "decode", "preds")), MESH,
                            (DP, None))
    want, jcache = jax_decode()
    np.testing.assert_array_equal(preds.numpy(), want)
    st_preds, st_cache = stacked_decode()
    assert torch.equal(preds, convert.unstack(st_preds, MESH, (DP, None)))
    caches = _stack_tree(_part(world, "decode", "caches"))
    got = convert.decode_caches_to_jax(caches, C.cfg(), C.pcfg(), MESH, C.B,
                                       C.S)
    for (path, a), b in zip(jax.tree.flatten_with_path(jcache)[0],
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(b, a, err_msg=str(path), **TOL)
    for i, (a, b) in enumerate(zip(caches, st_cache)):
        for k in a:
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(),
                                       err_msg=f"layer {i} {k}", **TOL)


@functools.lru_cache(maxsize=None)
def jax_prefill():
    pf, _, _, _ = jax_stages.build_prefill(jcfg(), jpcfg(), jax_mesh(), C.B,
                                           C.S)
    nxt, caches = pf(jax_state()[0], {"tokens": jnp.asarray(C.tokens())})
    return np.asarray(nxt), jax.tree.map(np.asarray, caches)


def test_prefill_tokens_and_caches(world):
    nxt = convert.unstack(_stack(_part(world, "prefill", "next")), MESH,
                          (DP,))
    want, jcaches = jax_prefill()
    np.testing.assert_array_equal(nxt.numpy(), want)
    caches = tuple(_stack(list(c)).movedim(len(LEAD), 0) for c in
                   zip(*_part(world, "prefill", "caches")))
    got = convert.prefill_caches_to_jax(caches, C.cfg(), C.pcfg(), MESH, C.B,
                                        C.S)
    for a, b in zip(jcaches, got):
        np.testing.assert_allclose(b, a, **TOL)


def test_serve_session(world):
    """The session one rank per process — prefill, the cache handoff
    through the engine, decode — generates the JAX package's tokens and
    the stacked session's, on every process."""
    toks = C.tokens()
    jsess = JaxSession(jcfg(), jpcfg(), jax_mesh(), 2, C.B, C.S,
                       C.S + C.GEN)
    want = jsess.generate(jax_state()[0], jnp.asarray(toks), C.GEN)
    sess = ServeSession(C.cfg(), C.pcfg(), MESH, 2, C.B, C.S, C.S + C.GEN,
                        device="cpu")
    params = convert.lm_params_from_jax(state_np()["params"], C.cfg(), MESH,
                                        serve=True)
    stacked = sess.generate(params, torch.from_numpy(toks), C.GEN)
    np.testing.assert_array_equal(stacked.numpy(), want)
    for got in _part(world, "session"):
        assert torch.equal(got, stacked)


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_step(key):
    kw = dict(C.TRAIN_CASES)[key]
    ts = jax_stages.build_train_step(jcfg(), jpcfg(**kw), jax_mesh(),
                                     jax_adamw.AdamWConfig(lr=C.LR))
    params = jax.tree.map(jnp.copy, jax_state()[0])
    state = jax_adamw.adamw_init(params)
    batch = {k: jnp.asarray(v) for k, v in C.train_batch().items()}
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


@pytest.mark.parametrize("key", [k for k, _ in C.TRAIN_CASES])
def test_train_step(world, key):
    """One train step one rank per process: rank 0's metrics, the params
    and the AdamW state within the stacked port's tolerances of the JAX
    package's step and of the stacked port's."""
    res = _part(world, ("train", key))
    jm, jp, js = jax_step(key)
    sm, sp, ss = stacked_step(key)
    for k in METRICS:
        np.testing.assert_allclose(res[0]["metrics"][k], jm[k], err_msg=k,
                                   **METRIC_TOL)
        np.testing.assert_allclose(res[0]["metrics"][k], sm[k], err_msg=k,
                                   **METRIC_TOL)
    params = _stack_tree([r["params"] for r in res])
    opt = _stack_tree([r["opt"] for r in res])
    c = C.cfg()
    got_p = convert.lm_params_to_jax(params, c, MESH)
    got_s = convert.opt_state_to_jax(opt, c, MESH)
    _close_state(got_p, got_s, jp, js)
    _close_state(got_p, got_s, convert.lm_params_to_jax(sp, c, MESH),
                 convert.opt_state_to_jax(ss, c, MESH))


# --------------------------------------------------------------------------
# Every collective bitwise the stacked engine's
# --------------------------------------------------------------------------

def _stack_arg(vals):
    if isinstance(vals[0], torch.Tensor):
        return _stack(vals) if vals[0].ndim else torch.stack(vals).reshape(
            LEAD)
    if isinstance(vals[0], (list, tuple)):
        return type(vals[0])(_stack_arg(list(v)) for v in zip(*vals))
    assert all(v == vals[0] for v in vals[1:]), vals
    return vals[0]


def _rows(t):
    return list(t.reshape((-1,) + tuple(t.shape[len(LEAD):])))


@pytest.mark.parametrize("part", [("decode",), ("train", "base")],
                         ids=["decode", "train"])
def test_collectives_bitwise_stacked(world, part):
    """Each engine collective a decode step (and a train step, forward
    and backward and the grad sync) issued, replayed on the stacked
    engine with every rank's own operands: each rank's result BITWISE
    the stacked row."""
    key = part if len(part) == 1 else (part,)
    logs = [r["collectives"] for r in _part(world, *key)]
    assert len(logs[0]) > 0 and all(len(g) == len(logs[0]) for g in logs)
    eng = CollectiveEngine(MESH, device="cpu")
    names = set()
    for calls in zip(*logs):
        name = calls[0]["name"]
        names.add(name)
        assert all(c["name"] == name for c in calls)
        args = _stack_arg([c["args"] for c in calls])
        kwargs = {k: _stack_arg([c["kwargs"][k] for c in calls])
                  for k in calls[0]["kwargs"]}
        if name == "itree_allreduce":
            name = "tree_allreduce"    # the queue is bitwise the blocking
        want = getattr(eng, name)(*args, **kwargs)
        if isinstance(want, torch.Tensor):
            want = [want]
            outs = [[c["out"]] for c in calls]
        else:
            outs = [c["out"] for c in calls]
        for j, w in enumerate(want):
            for r, row in enumerate(_rows(w)):
                assert torch.equal(outs[r][j], row), (name, j, r)
    assert "allreduce" in names
    if part != ("decode",):
        assert {"allgather", "reduce_scatter", "itree_allreduce"} <= names


# --------------------------------------------------------------------------
# The streaming ops' grads
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_x_mesh():
    return make_mesh((C.N,), ("x",))


def _jax_grads(call, *arrays):
    """Per-rank output and grads of sum(call(engine, locals) * cot) under
    the reference's shard_map, by `jax.grad` of the summed losses."""
    mesh = _jax_x_mesh()
    eng = JaxEngine(mesh)
    spec = P("x")

    def per_rank(*xs):
        *ins, cot = [x[0] for x in xs]
        y = call(eng, *ins)
        return (y * cot).sum()[None], y[None]

    f = shard_map(per_rank, mesh=mesh, in_specs=(spec,) * len(arrays),
                  out_specs=(spec, spec), check_vma=False)
    n_in = len(arrays) - 1

    def loss(*ins):
        return f(*ins, arrays[-1])[0].sum()

    y = jax.jit(f)(*map(jnp.asarray, arrays))[1]
    gs = jax.jit(jax.grad(loss, argnums=tuple(range(n_in))))(
        *map(jnp.asarray, arrays[:-1]))
    return [np.asarray(y)] + [np.asarray(g) for g in gs]


def _stacked_grads(call, *arrays):
    eng = CollectiveEngine({"x": C.N}, device="cpu")
    ins = [torch.tensor(a, requires_grad=True) for a in arrays[:-1]]
    y = call(eng, *ins)
    (y * torch.from_numpy(arrays[-1])).sum().backward()
    return [y.detach()] + [t.grad for t in ins]


_GRAD_KEYS = [(op,) for op, *_ in C.GRAD_CASES] + \
    [("ring", seg) for seg in C.RING_SEGMENTS]


@pytest.mark.parametrize("key", _GRAD_KEYS,
                         ids=["-".join(map(str, k)) for k in _GRAD_KEYS])
def test_streaming_grads_per_process(world, key):
    """`allgather_matmul`, `matmul_reduce_scatter` and `ring_attention`
    differentiate one rank per process (the adjoint Functions, the ring's
    reverse exchange): outputs and grads within 1e-5 of `jax.grad` of the
    reference engine under `shard_map` and of the stacked port's (whose
    products are batched over the ranks)."""
    if key[0] == "ring":
        arrays = C.ring_inputs()

        def call(e, q, k, v):
            return e.ring_attention(q, k, v, "x", causal=True,
                                    segments=key[1])
    else:
        i = [op for op, *_ in C.GRAD_CASES].index(key[0])
        op, xs, ws, cs = C.GRAD_CASES[i]
        arrays = C.grad_inputs(xs, ws, cs, seed=5 + i)

        def call(e, x, w):
            return getattr(e, op)(x, w, "x")
    got = [torch.stack(t) for t in zip(*_part(world, ("grad",) + key))]
    want = _jax_grads(call, *arrays)
    stacked = _stacked_grads(call, *arrays)
    assert len(got) == len(want) == len(stacked)
    for g, w, s in zip(got, want, stacked):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
        np.testing.assert_allclose(g.numpy(), s.numpy(), **TOL)


# --------------------------------------------------------------------------
# Checkpoints
# --------------------------------------------------------------------------

def _shape_tree():
    from repro_torch.tree import tree_map
    params = stages.param_shapes(C.cfg(), MESH, 2)
    return {"params": params, "opt": {
        "leaves": tree_map(
            lambda p: {n: p.float() for n in ("master", "m", "v")}, params),
        "count": torch.empty((), dtype=torch.int32, device="meta")}}


def test_checkpoint_written_per_process(world):
    """The world's checkpoint of the JAX init's state (each process its
    shards, gathered to rank 0) loads into the stacked port and through
    the reference's store, every leaf bitwise, with the stacked port's
    own files and manifest."""
    d = world["dir"]
    st = state_np()
    got, manifest = load_checkpoint(str(d / "ckpt_procs"), 3, _shape_tree(),
                                    _specs(), MESH)
    assert manifest["step"] == 3
    want = {"params": convert.lm_params_from_jax(st["params"], C.cfg(),
                                                 MESH),
            "opt": convert.opt_state_from_jax(st["opt"], C.cfg(), MESH)}
    for (path, a), (_, b) in zip(flatten(got), flatten(want)):
        assert torch.equal(a, b), path
    jtree = {"params": jax_state()[0], "opt": jax_state()[1]}
    jspecs = jax_stages.param_specs(jcfg(), 2)
    jspecs = {"params": jspecs, "opt": jax_adamw.opt_specs(jspecs)}
    jgot, _ = jax_load(str(d / "ckpt_procs"), 3, jtree, jspecs, jax_mesh())
    for (path, a), b in zip(jax.tree.flatten_with_path(jtree)[0],
                            jax.tree.leaves(jgot)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=str(path))
    save_checkpoint(str(d / "ckpt_same"), 3, want, _specs(), mesh_shape=MESH)
    step_p = d / "ckpt_procs" / "step_000000003"
    step_s = d / "ckpt_same" / "step_000000003"
    with open(step_p / "manifest.json") as f, \
            open(step_s / "manifest.json") as g:
        assert json.load(f) == json.load(g)
    for name in os.listdir(step_s):
        if name.endswith(".npy"):
            assert (step_p / name).read_bytes() == \
                (step_s / name).read_bytes(), name


def test_stacked_checkpoint_restores_per_process(world):
    """A stacked checkpoint (after one step) loads into every process as
    its own local shards, bitwise."""
    tree = world["ckpt_tree"]
    for r, got in enumerate(_part(world, "ckpt_loaded")):
        want = convert.local_params(tree, MESH, world["ranks"][r]
                                       ["coords"])
        for (path, a), (_, b) in zip(flatten(got), flatten(want)):
            assert torch.equal(a, b), (r, path)


# --------------------------------------------------------------------------
# The launchers
# --------------------------------------------------------------------------

def _torchrun(n: int, module, *argv):
    """Run a launcher's module in `n` processes under torchrun."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p]))
    head = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc_per_node={n}", "-m"]
    subprocess.run(head + [module] + list(argv), check=True, env=env,
                   stdout=subprocess.DEVNULL)


TRAIN_ARGS = ("--arch", "qwen3-0.6b", "--device", "cpu", "--steps", "2",
              "--batch", "4", "--seq", "16", "--ckpt-every", "1")


def test_train_launcher_procs(tmp_path):
    """`launch.train --procs 4` takes the stacked launcher's trajectory
    on four devices (loss, grad norm, ce exactly) and writes its
    checkpoints."""
    from repro_torch.launch import train
    train.main(list(TRAIN_ARGS) + ["--procs", "4", "--ckpt",
                                   str(tmp_path / "p"), "--log-json",
                                   str(tmp_path / "p.json")])
    train.main(list(TRAIN_ARGS) + ["--devices", "4", "--ckpt",
                                   str(tmp_path / "s"), "--log-json",
                                   str(tmp_path / "s.json")])
    got = json.loads((tmp_path / "p.json").read_text())
    want = json.loads((tmp_path / "s.json").read_text())
    assert [r["step"] for r in got] == [0, 1]
    for a, b in zip(got, want):
        for k in METRICS:
            assert a[k] == b[k], k
    assert sorted(os.listdir(tmp_path / "p")) == \
        sorted(os.listdir(tmp_path / "s"))


SERVE_ARGS = ("--arch", "qwen3-0.6b", "--device", "cpu", "--gen", "4",
              "--prompt-len", "6")


@pytest.mark.parametrize("how", ["procs", "torchrun"])
def test_serve_launcher_procs(tmp_path, how):
    """`launch.serve --procs 4` (and under torchrun, 2 processes) serves
    the stacked launcher's tokens."""
    from repro_torch.launch import serve
    n = 4 if how == "procs" else 2
    if how == "procs":
        serve.main(list(SERVE_ARGS) + ["--procs", str(n), "--out",
                                       str(tmp_path / "p.json")])
    else:
        _torchrun(n, "repro_torch.launch.serve", *SERVE_ARGS, "--out",
                  str(tmp_path / "p.json"))
    serve.main(list(SERVE_ARGS) + ["--devices", str(n), "--out",
                                   str(tmp_path / "s.json")])
    got = json.loads((tmp_path / "p.json").read_text())
    assert got == json.loads((tmp_path / "s.json").read_text())
    assert np.asarray(got).shape == (4, 10)


@pytest.mark.parametrize("arch", ["hymba-1.5b"])
def test_serve_launcher_procs_family(tmp_path, arch):
    """`launch.serve --procs 4` serves a non-dense family (the hybrid:
    attention and SSM branches, global and windowed layers) with the
    stacked launcher's tokens on four devices."""
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--device", "cpu", "--gen", "3",
            "--prompt-len", "5"]
    serve.main(argv + ["--procs", "4", "--out", str(tmp_path / "p.json")])
    serve.main(argv + ["--devices", "4", "--out", str(tmp_path / "s.json")])
    got = json.loads((tmp_path / "p.json").read_text())
    assert got == json.loads((tmp_path / "s.json").read_text())
    assert np.asarray(got).shape == (4, 8)


def test_serve_launcher_procs_refuses_audio():
    """The audio family: `launch.serve --procs 2` refuses as the stacked
    launcher (and the reference's) does: its decode has no cross cache
    (ROADMAP Queue 3)."""
    from repro_torch.launch import serve
    argv = ["--arch", "whisper-medium", "--device", "cpu", "--gen", "2",
            "--prompt-len", "3"]
    with pytest.raises(KeyError, match="xk"):
        serve.main(argv + ["--devices", "2"])
    with pytest.raises(Exception, match="xk"):
        serve.main(argv + ["--procs", "2"])


def test_train_launcher_procs_family(tmp_path):
    """`launch.train --procs 4` trains the MoE (its aux term) with the
    stacked launcher's trajectory on four devices."""
    from repro_torch.launch import train
    argv = ["--arch", "qwen3-moe-30b-a3b", "--device", "cpu", "--steps",
            "2", "--batch", "4", "--seq", "16", "--ckpt-every", "100"]
    train.main(argv + ["--procs", "4", "--ckpt", str(tmp_path / "p"),
                       "--log-json", str(tmp_path / "p.json")])
    train.main(argv + ["--devices", "4", "--ckpt", str(tmp_path / "s"),
                       "--log-json", str(tmp_path / "s.json")])
    got = json.loads((tmp_path / "p.json").read_text())
    want = json.loads((tmp_path / "s.json").read_text())
    assert [r["step"] for r in got] == [0, 1]
    for a, b in zip(got, want):
        for k in METRICS:
            np.testing.assert_allclose(a[k], b[k], err_msg=k, **METRIC_TOL)


def test_launchers_procs_need_the_card(monkeypatch):
    """`--procs` without `--device cpu` asks for CUDA and raises without
    it, before any process starts."""
    from repro_torch.launch import serve, train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (serve.main, train.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--arch", "qwen3-0.6b", "--procs", "2"])
