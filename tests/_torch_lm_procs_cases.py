"""Shared cases of `test_torch_procgroup_lm.py`: what each process of a
spawned 4-process world runs — reduced qwen3-0.6b served and trained one
rank per process on the (pod, data, model) = (1, 2, 2) mesh (FSDP 2 x
TP 2), the three streaming ops' grads, and checkpoints — and the inputs
the parent holds its results against.

This module imports no jax: the spawned children import it to find
`run`. The params and AdamW state are the JAX package's own init, made
by the parent and handed to the children as numpy (`state.pt`); each
child takes its shards with `convert.lm_params_from_jax(..., coords=)`.
Every engine collective a decode step and a train step issue is
recorded on each rank (`record_collectives`: operands and result of
each outermost call), so the parent can replay it on the stacked engine.
Each child saves its local results with `torch.save`.
"""
import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import ParallelConfig, get_config, reduced_config
from repro_torch.optim import adamw
from repro_torch.parallel import stages
from repro_torch.runtime.serve_session import ServeSession

N = 4
MESH = {"pod": 1, "data": 2, "model": 2}
ARCH = "qwen3-0.6b"
B, S = 4, 16           # the decode / prefill batch and prompt
GEN = 4                # the session's new tokens
LR = 1e-3
TRAIN_S = 16
#: the train step's variants: (key, ParallelConfig fields)
TRAIN_CASES = (
    ("base", {}),
    ("int8", {"grad_compression": "int8"}),
    ("sp", {"sequence_parallel": True, "collective_matmul": True}))
#: the engine methods whose calls are recorded and replayed
RECORDED = ("allreduce", "allgather", "reduce_scatter", "alltoall",
            "allgather_matmul", "matmul_reduce_scatter", "tree_allreduce",
            "itree_allreduce")
#: the streaming matmuls' grads on {"x": 4}: (op, x local, w local,
#: cotangent local)
GRAD_CASES = (("allgather_matmul", (4, 6), (6, 5), (16, 5)),
              ("matmul_reduce_scatter", (16, 6), (6, 5), (4, 5)))
RING_SHAPES = ((2, 8, 4, 8), (2, 8, 2, 8))     # q and k/v local, S over x
RING_SEGMENTS = (1, 2)


def cfg():
    return reduced_config(get_config(ARCH))


def pcfg(**kw):
    return ParallelConfig(remat="none", **kw)


def tokens() -> np.ndarray:
    return np.random.default_rng(0).integers(
        0, cfg().vocab_size, (B, S)).astype(np.int32)


def train_batch() -> dict:
    """As `_torch_train_cases.batch_np`: tokens and next-token labels."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg().vocab_size, (B, TRAIN_S + 1)).astype(
        np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def grad_inputs(shape_x, shape_w, shape_c, seed: int):
    """Stacked (N, ...) numpy inputs: x, w and the cotangent."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((N,) + s).astype(np.float32)
                 for s in (shape_x, shape_w, shape_c))


def ring_inputs():
    """Stacked (N, ...) q, k, v and the cotangent."""
    rng = np.random.default_rng(11)
    q, kv = RING_SHAPES
    return tuple(rng.standard_normal((N,) + s).astype(np.float32)
                 for s in (q, kv, kv, q))


# --------------------------------------------------------------------------
# Recording an engine's collectives
# --------------------------------------------------------------------------

def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return x


class _Ticket:
    def __init__(self, ticket, entry):
        self._ticket, self._entry = ticket, entry

    def wait(self):
        out = self._ticket.wait()
        self._entry["out"] = _host(out)
        return out


def record_collectives(engine, log: list):
    """Wrap `engine`'s RECORDED methods (on the instance) so each
    outermost call appends {"name", "args", "kwargs", "out"} to `log`
    while `log` is `active` (an `itree_allreduce`'s result at its
    ticket's wait); calls made inside another are not recorded."""
    depth = [0]
    log_state = {"active": False}

    def wrap(name, fn):
        def call(*args, **kwargs):
            top = depth[0] == 0 and log_state["active"]
            depth[0] += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                depth[0] -= 1
            if not top:
                return out
            entry = {"name": name, "args": _host(args),
                     "kwargs": _host(kwargs)}
            log.append(entry)
            if name == "itree_allreduce":
                return _Ticket(out, entry)
            entry["out"] = _host(out)
            return out
        return call

    for name in RECORDED:
        setattr(engine, name, wrap(name, getattr(engine, name)))
    return log_state


def unrecord(engine) -> None:
    """Take `record_collectives`'s wrappers off `engine`."""
    for name in RECORDED:
        engine.__dict__.pop(name, None)


# --------------------------------------------------------------------------
# What each process runs
# --------------------------------------------------------------------------

def _serve(eng, state_np, out):
    c, p = cfg(), pcfg()
    coords = eng.coords
    params = convert.lm_params_from_jax(state_np["params"], c, MESH,
                                        serve=True, coords=coords)
    # teacher-forced decode of `tokens()` from zero caches
    dstep, _, _, _ = stages.build_decode_step(c, p, MESH, s_max=S,
                                              global_batch=B, device="cpu",
                                              engine=eng)
    cache = stages.init_cache(c, p, MESH, 2, B, S, device="cpu",
                              coords=coords)
    toks = torch.from_numpy(tokens())
    spec = (stages.dp_axes(MESH, B), None)
    preds, log = [], []
    rec = record_collectives(eng, log)
    for t in range(S):
        rec["active"] = t == 3
        nxt, cache = dstep(params, cache, convert.shard_of(
            toks[:, t:t + 1], MESH, spec, coords), t)
        preds.append(nxt)
    unrecord(eng)
    out["decode"] = {"preds": torch.stack(preds, 1), "caches": cache,
                     "collectives": log}
    # prefill of the whole prompt
    pf, _, _, bspec = stages.build_prefill(c, p, MESH, B, S, device="cpu",
                                           engine=eng)
    nxt, caches = pf(params, {"tokens": convert.shard_of(
        toks, MESH, bspec["tokens"], coords)})
    out["prefill"] = {"next": nxt, "caches": caches}
    # the session: prefill, the cache handoff, decode
    sess = ServeSession(c, p, MESH, 2, B, S, S + GEN, device="cpu",
                        engine=eng)
    out["session"] = sess.generate(params, toks, GEN)


def _train(eng, state_np, out):
    c = cfg()
    coords = eng.coords
    for key, kw in TRAIN_CASES:
        ts = stages.build_train_step(c, pcfg(**kw), MESH,
                                     adamw.AdamWConfig(lr=LR), device="cpu",
                                     engine=eng)
        params = convert.lm_params_from_jax(state_np["params"], c, MESH,
                                            coords=coords)
        state = convert.opt_state_from_jax(state_np["opt"], c, MESH,
                                           coords=coords)
        log = []
        rec = record_collectives(eng, log)
        rec["active"] = key == "base"
        _p, _s, m = ts.fn(params, state, ts.put_batch(train_batch()), 0)
        unrecord(eng)
        out["train", key] = {"metrics": {k: float(v) for k, v in m.items()},
                             "params": params, "opt": state,
                             "collectives": log}


def _grads(rank, out):
    from repro_torch.core.procgroup import ProcessGroupEngine
    eng = ProcessGroupEngine({"x": N}, device="cpu")
    for i, (op, xs, ws, cs) in enumerate(GRAD_CASES):
        X, W, C = grad_inputs(xs, ws, cs, seed=5 + i)
        x = torch.tensor(X[rank], requires_grad=True)
        w = torch.tensor(W[rank], requires_grad=True)
        y = getattr(eng, op)(x, w, "x")
        (y * torch.from_numpy(C[rank])).sum().backward()
        out["grad", op] = (y.detach(), x.grad, w.grad)
    q, k, v, cot = ring_inputs()
    for seg in RING_SEGMENTS:
        qkv = [torch.tensor(t[rank], requires_grad=True) for t in (q, k, v)]
        y = eng.ring_attention(*qkv, "x", causal=True, segments=seg)
        (y * torch.from_numpy(cot[rank])).sum().backward()
        out["grad", "ring", seg] = (y.detach(),) + tuple(t.grad for t in qkv)


def _checkpoints(eng, state_np, outdir, out):
    """The world saves the JAX init's state (its local shards) one rank
    per process, and loads the parent's stacked checkpoint back as local
    shards."""
    c = cfg()
    coords = eng.coords
    tree = {"params": convert.lm_params_from_jax(state_np["params"], c, MESH,
                                                 coords=coords),
            "opt": convert.opt_state_from_jax(state_np["opt"], c, MESH,
                                              coords=coords)}
    specs = stages.param_specs(c, 2)
    specs = {"params": specs, "opt": adamw.opt_specs(specs)}
    save_checkpoint(f"{outdir}/ckpt_procs", 3, tree, specs,
                    mesh_shape=MESH, per_process=True)
    got, _ = load_checkpoint(f"{outdir}/ckpt_stacked", 7, tree, specs, MESH,
                             "cpu", coords)
    out["ckpt_loaded"] = got


def run(rank: int, n: int, outdir: str) -> None:
    from repro_torch.core.procgroup import ProcessGroupEngine
    torch.set_num_threads(1)
    state_np = torch.load(f"{outdir}/state.pt", weights_only=False)
    eng = ProcessGroupEngine(MESH, device="cpu")
    out = {"coords": eng.coords}
    _serve(eng, state_np, out)
    _train(eng, state_np, out)
    _grads(rank, out)
    _checkpoints(eng, state_np, outdir, out)
    out["transport"] = eng.transport_stats()
    torch.save(out, f"{outdir}/rank{rank}.pt")
