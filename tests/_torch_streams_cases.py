"""Shared cases of `test_torch_procgroup_streams.py`: what each process of
a spawned 4-process world runs — the native backend, the streaming
matmuls, `ring_attention` and the reduced DLRM one rank per process —
and the inputs the parent holds its results against.

This module imports no jax: the spawned children import it to find
`run`. Inputs come from numpy seeds, so the parent and every child make
the same ones; the DLRM's params are the JAX package's own init, made
by the parent and handed to the children as numpy (`params.pt`). Each
child saves its local results with `torch.save`.
"""
import numpy as np
import torch

from repro_torch.kernels import ops

N = 4
ROOT = 1
MESH1 = {"x": N}
MESH2 = {"pod": 2, "data": 2}
DLRM_MESHES = {"m4": {"pod": 1, "data": 1, "model": 4},
               "d2m2": {"pod": 1, "data": 2, "model": 2}}
DLRM_B = 16

#: the native backend's blocking collectives on {"x": 4}: (name, call,
#: local input shape); `call(engine, local or stacked input)`
NATIVE_CALLS = (
    ("allreduce", lambda e, v: e.allreduce(v, "x"), (96,)),
    ("allreduce_max", lambda e, v: e.allreduce(v, "x", op="max"), (40,)),
    ("allreduce_min", lambda e, v: e.allreduce(v, "x", op="min"), (40,)),
    ("reduce_scatter", lambda e, v: e.reduce_scatter(v, "x"), (96,)),
    ("allgather", lambda e, v: e.allgather(v, "x"), (24,)),
    ("bcast", lambda e, v: e.bcast(v, "x", root=ROOT), (30, 2)),
    ("reduce", lambda e, v: e.reduce(v, "x", root=2), (50,)),
    ("gather", lambda e, v: e.gather(v, "x", root=3), (12,)),
    ("alltoall", lambda e, v: e.alltoall(v, "x"), (8, 3)),
)
#: the (2, 2) mesh's native calls: the two-axis allreduce composes
#: reduce-scatter, allreduce and allgather per axis
NATIVE_MESH2_CALLS = (
    ("allreduce_2x2", lambda e, v: e.allreduce(v, ("pod", "data")), (768,)),
    ("allreduce_multi", lambda e, v: e.allreduce_multi(v, ["data", "pod"]),
     (100,)),
)
#: which native calls add (held within the summation bound on normal
#: values); the rest are bitwise in any order
NATIVE_SUMS = ("allreduce", "reduce_scatter", "reduce", "allreduce_2x2",
               "allreduce_multi")
KINDS = ("int", "normal")

#: the streaming matmuls: (key, op, segments, kind, x local, w local)
STREAM_CASES = [
    (f"{op}-s{seg}-{kind}", op, seg, kind, xs, ws)
    for op, xs, ws in (("allgather_matmul", (4, 6), (6, 5)),
                       ("matmul_reduce_scatter", (16, 6), (6, 5)))
    for seg in (1, 2) for kind in KINDS]

#: ring attention: (key, dtype, causal, segments); inputs (B, S, H, hd)
#: with S over the 4 ranks
RING_B, RING_S, RING_H, RING_KV, RING_HD = 4, 64, 4, 2, 16
RING_CASES = [(f"{dt}-{'causal' if c else 'full'}-s{s}", dt, c, s)
              for dt in ("float32", "bfloat16") for c in (True, False)
              for s in (1, 2)]

#: the reduced DLRM: (key, mesh key, params kind, collective_matmul,
#: backend)
DLRM_CASES = [(f"{m}-{kind}-cm{int(cm)}-{be}", m, kind, cm, be)
              for m, kind, cm, be in (
                  ("m4", "int", True, "microcode"),
                  ("m4", "int", False, "microcode"),
                  ("m4", "normal", True, "microcode"),
                  ("m4", "normal", False, "microcode"),
                  ("m4", "int", True, "native"),
                  ("m4", "normal", True, "native"),
                  ("d2m2", "normal", True, "microcode"))]


def array(shape, seed: int, kind: str) -> np.ndarray:
    """fp32: integers in [-8, 8] ('int': every sum here is exact) or
    standard normal."""
    rng = np.random.default_rng(seed)
    if kind == "int":
        return rng.integers(-8, 9, size=shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


def native_input(name: str, lead: tuple, local: tuple, kind: str):
    return array(lead + local, sum(map(ord, name)) + (kind == "normal"),
                 kind)


def stream_inputs(key: str, xs: tuple, ws: tuple, kind: str) -> tuple:
    seed = sum(map(ord, key))
    return (array((N,) + xs, seed, kind), array((N,) + ws, seed + 1, kind))


def ring_inputs(seed: int = 0) -> list:
    """Global fp32 q, k, v, as `test_torch_ring_attention._inputs` draws
    them (the caller rounds them to the case's dtype)."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(RING_B, RING_S, h, RING_HD)).astype(np.float32)
            for h in (RING_H, RING_KV, RING_KV)]


def dlrm_requests(rows: int, tables: int, seed: int = 3) -> np.ndarray:
    """Requests with an id at every shard edge of a 4-way and a 2-way
    split, below 0 and past the last row; the rest uniform."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, rows, (DLRM_B, tables)).astype(np.int32)
    edges = sorted({e for tp in (2, N) for m in range(tp)
                    for e in (m * rows // tp - 1, m * rows // tp)})
    edges += [rows - 1, rows, -1, 2**31 - 1, -2**31]
    idx.reshape(-1)[:len(edges)] = np.array(edges, dtype=np.int64)
    return idx


# --------------------------------------------------------------------------
# A child process
# --------------------------------------------------------------------------

_COUNTED = (("matmul", "matmul_tiled"),
            ("embedding_lookup_rows", "gather_rows"))


def count_calls() -> None:
    """Make K4's and K5's entry points count their calls into the
    kernel's `.launches`, as the card's wrappers count launches (the
    plain versions the CPU runs count nothing)."""
    for name, kernel in _COUNTED:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _k=ops.KERNELS[kernel], **kw):
            _k.launches += 1
            return _fn(*a, **kw)

        setattr(ops, name, counted)


def _native(rank: int) -> dict:
    from repro_torch.core.procgroup import ProcessGroupEngine
    eng = ProcessGroupEngine(MESH1, backend="native", device="cpu")
    eng2 = ProcessGroupEngine(MESH2, backend="native", device="cpu")
    pos = np.unravel_index(rank, tuple(MESH2.values()))
    out = {}
    for kind in KINDS:
        for name, call, local in NATIVE_CALLS:
            x = native_input(name, (N,), local, kind)[rank]
            out[name, kind] = call(eng, torch.from_numpy(x))
        for name, call, local in NATIVE_MESH2_CALLS:
            x = native_input(name, tuple(MESH2.values()), local, kind)[pos]
            out[name, kind] = call(eng2, torch.from_numpy(x))
    out["programs"] = len(eng._checked) + len(eng2._checked)
    out["stats"] = eng.transport_stats()
    return out


def _streams(rank: int) -> dict:
    from repro_torch.core.procgroup import ProcessGroupEngine
    eng = ProcessGroupEngine(MESH1, device="cpu")
    out = {}
    for key, op, seg, kind, xs, ws in STREAM_CASES:
        X, W = stream_inputs(key, xs, ws, kind)
        ops.reset_launch_counts()
        y = getattr(eng, op)(torch.from_numpy(X[rank]),
                             torch.from_numpy(W[rank]), "x", segments=seg)
        out[key] = (y, ops.launch_counts()["matmul_tiled"],
                    eng.trace_log[-1])
    q, k, v = ring_inputs()
    sl = RING_S // N
    for key, dt, causal, seg in RING_CASES:
        tdt = getattr(torch, dt)
        blk = [torch.from_numpy(t[:, rank * sl:(rank + 1) * sl]).to(tdt)
               for t in (q, k, v)]
        y = eng.ring_attention(*blk, "x", causal=causal, segments=seg)
        out["ring", key] = (y, eng.trace_log[-1])
    # a rank that asks for another segment count than its peers
    try:
        eng.allgather_matmul(torch.ones(4, 3), torch.ones(3, 2), "x",
                             segments=2 if rank else 4)
    except RuntimeError as e:
        out["mismatch"] = str(e)
    return out


def _dlrm(rank: int, params_np: dict) -> dict:
    from repro_torch import convert
    from repro_torch.configs import ParallelConfig, reduced
    from repro_torch.core.procgroup import ProcessGroupEngine
    from repro_torch.launch.dlrm_serve import DLRMServer
    cfg = reduced()
    idx = torch.from_numpy(dlrm_requests(cfg.rows_per_table, cfg.n_tables))
    out = {}
    for key, m, kind, cm, backend in DLRM_CASES:
        mesh = DLRM_MESHES[m]
        eng = ProcessGroupEngine(mesh, backend=backend, device="cpu")
        stacked = convert.dlrm_params_from_jax(params_np[kind, m], cfg, mesh)
        server = DLRMServer(
            cfg, engine=eng, params=convert.local_params(stacked, mesh,
                                                         eng.coords),
            pcfg=ParallelConfig(collective_matmul=cm, backend=backend))
        ops.reset_launch_counts()
        logits = server(idx)
        launches = ops.launch_counts()
        out[key] = {"logits": logits, "launches": launches,
                    "lookup": server.lookup(idx),
                    "own": server.own_rows(idx),
                    "assembled": server.assembled_rows(idx)}
    # params drawn per process from the seed
    mesh = DLRM_MESHES["m4"]
    eng = ProcessGroupEngine(mesh, device="cpu")
    server = DLRMServer(cfg, engine=eng, seed=5)
    out["init"] = {"logits": server(idx), "reference": server.reference(
        idx, dtype=torch.float64), "head": server.model.fc2_w.clone(),
        "tables": server.model.tables[:, :3].clone()}
    return out


def run(rank: int, n: int, tmp: str) -> None:
    """One process of the 4-process world: every case above, results to
    `{tmp}/rank{rank}.pt`."""
    count_calls()
    res = {"native": _native(rank), "streams": _streams(rank)}
    res["dlrm"] = _dlrm(rank, torch.load(f"{tmp}/params.pt",
                                         weights_only=False))
    torch.save(res, f"{tmp}/rank{rank}.pt")
