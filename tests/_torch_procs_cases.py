"""Shared cases of `test_torch_procgroup.py`: what each process of a
spawned world runs, one rank per process, and the cases the parent
holds its results against.

This module imports no jax: the spawned children import it (by its
module path) to find `run`. Every case is built from numpy seeds, so the
parent and every child make the same inputs and compile the same
programs. Each child saves its local results with `torch.save`; the
parent stacks them and compares.
"""
import inspect
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import algorithms as A
from repro_torch.core import hierarchical
from repro_torch.core.program import compile_schedule
from repro_torch.core.topology import Communicator, product_comm
from repro_torch.kernels import ops

ROOT = 1
TILES = 4
VECMAT_SIZE = 256


# --------------------------------------------------------------------------
# The CPU path's launch counts
# --------------------------------------------------------------------------

_COUNTED = {"fused_combine": ("fused_combine", "fused_combine_at"),
            "quantize_blocks": ("quantize_int8", "quantize_int8_at"),
            "dequantize_blocks": ("dequantize_int8", "dequantize_int8_at")}


def count_calls() -> None:
    """Make each kernel entry point of `ops` count its calls into the
    kernel's `.launches`, as the card's wrappers count launches (the
    plain versions the CPU runs count nothing; a 'meta' call, which
    launches nothing on the card either, counts nothing)."""
    for kernel, names in _COUNTED.items():
        for name in names:
            fn = getattr(ops, name)

            def counted(*a, _fn=fn, _k=ops.KERNELS[kernel], **kw):
                if a[0].device.type != "meta":   # shapes only: no launch
                    _k.launches += 1
                return _fn(*a, **kw)

            setattr(ops, name, counted)


# --------------------------------------------------------------------------
# The executor's grid
# --------------------------------------------------------------------------

def _schedule(coll, algo, comm):
    gen = A.GENERATORS[(coll, algo)]
    kw = {"root": ROOT} if "root" in inspect.signature(gen).parameters \
        else {}
    return gen(comm, **kw)


def grid(n: int) -> list:
    """(key, schedule, segments, codec, inputs) of every GENERATORS entry
    that accepts n ranks, at segments 1 and 4, codec None and int8, on
    integer-valued and normal fp32; bf16 at segments 1 for the ring and
    bidi_ring allreduce; one hierarchical allreduce on a (2, 2) product
    when n == 4."""
    comm = Communicator(axis="x", size=n)
    out = []
    for coll, algo in sorted(A.GENERATORS):
        try:
            sched = _schedule(coll, algo, comm)
        except ValueError:
            continue                          # e.g. pow2-only generators
        for segments in (1, 4):
            for codec in (None, "int8"):
                for inputs in ("int", "normal"):
                    out.append((f"{coll}-{algo}-s{segments}-{codec}-{inputs}",
                                sched, segments, codec, inputs))
    for algo in ("ring", "bidi_ring"):
        sched = _schedule("allreduce", algo, comm)
        out.append((f"allreduce-{algo}-s1-bf16-normal", sched, 1, "bf16",
                    "normal"))
    if n == 4:
        pc = product_comm({"pod": 2, "data": 2}, "pod", "data")
        for codec in (None, "int8"):
            sched = hierarchical.hierarchical_schedule("allreduce", pc)
            out.append((f"hier-allreduce-2x2-{codec}-normal", sched, 4,
                        codec, "normal"))
    return out


def program(sched, segments, codec):
    return compile_schedule(sched, segments=segments, codec=codec)


def grid_inputs(key: str, sched, n: int, codec, inputs: str) -> list:
    """Per-rank flat buffers, staged as the engine stages them (own
    shard at its slot for allgather / gather)."""
    seed = sum(map(ord, key)) * 7 + n
    rng = np.random.default_rng(seed)
    per_chunk = 256 if codec else 6

    def draw(size):
        if inputs == "int":
            return rng.integers(-20, 21, size).astype(np.float32)
        return rng.normal(size=size).astype(np.float32)

    coll = sched.collective
    if coll not in ("allgather", "gather"):
        return [draw(sched.chunks * per_chunk) for _ in range(n)]
    xs = []
    for r in range(n):
        buf = np.zeros((n * per_chunk,), np.float32)
        slot = r if sched.chunk_coords == "absolute" else (r - ROOT) % n
        buf[slot * per_chunk:(slot + 1) * per_chunk] = draw(per_chunk)
        xs.append(buf)
    return xs


# --------------------------------------------------------------------------
# The engine, the queue and use case 1
# --------------------------------------------------------------------------

def shift_generator(S, St, Se):
    """A plugin collective (a one-step ring shift of the original) built
    from a package's Schedule, Step and Sel classes."""
    def gen(comm, op="add"):
        return S(name="shift_exchange", collective="shift_exchange",
                 nranks=comm.size,
                 steps=(St(perm=tuple(comm.ring_perm(1)), op=op,
                           send_sel=Se.all(), recv_sel=Se.all(),
                           bytes_frac=1.0, uniform=True),),
                 chunks=1, result="full", relay="original")
    return gen


#: one blocking collective of each kind on {"x": 4}: (name, call, local
#: input shape); `call(engine, local or stacked input)`
ENGINE_CALLS = (
    ("allreduce", lambda e, v: e.allreduce(v, "x"), (96,)),
    ("allreduce_int8", lambda e, v: e.allreduce(
        v, "x", algorithm="ring", compression="int8", segments=4), (2048,)),
    ("reduce_scatter", lambda e, v: e.reduce_scatter(v, "x"), (96,)),
    ("allgather", lambda e, v: e.allgather(v, "x", algorithm="ring"),
     (24,)),
    ("bcast", lambda e, v: e.bcast(v, "x", root=ROOT), (30, 2)),
    ("reduce", lambda e, v: e.reduce(v, "x", root=2,
                                     algorithm="binomial_tree"), (50,)),
    ("gather", lambda e, v: e.gather(v, "x", root=3,
                                     algorithm="binomial_tree"), (12,)),
    ("alltoall", lambda e, v: e.alltoall(v, "x", algorithm="bruck"),
     (8, 3)),
    ("shift_exchange", lambda e, v: e.collective("shift_exchange", v, "x"),
     (16,)),
    ("send_recv", lambda e, v: e.send_recv(v, "x", shift=3), (33,)),
)
#: the (2, 2) mesh's calls
MESH2 = {"pod": 2, "data": 2}
MESH2_CALLS = (
    ("allreduce_2x2", lambda e, v: e.allreduce(v, ("pod", "data")), (768,)),
    ("allreduce_2x2_hier", lambda e, v: e.allreduce(
        v, ("pod", "data"), algorithm="hierarchical:ring+ring"), (768,)),
    ("allreduce_data", lambda e, v: e.allreduce(v, "data", algorithm="ring"),
     (64,)),
)


def int_array(shape, seed: int) -> np.ndarray:
    """Integer-valued fp32 in [-8, 8]: every sum here is exact."""
    return np.random.default_rng(seed).integers(
        -8, 9, size=shape).astype(np.float32)


def engine_input(name: str, lead: tuple, local: tuple) -> np.ndarray:
    return int_array(lead + local, sum(map(ord, name)))


def queue_inputs(n: int) -> dict:
    """Phase 7b's mix, stacked over n ranks: three small allreduces that
    coalesce, an int8 allreduce, an allreduce a reduce consumes."""
    return {"small": [int_array((n, m), 100 + m) for m in (40, 8, 24)],
            "big": int_array((n, 4096), 201), "mid": int_array((n, 1024),
                                                               202)}


def issue_queue(eng, q: dict, at) -> list:
    """Issue the mix into `eng`'s queue (`at(a)`: this engine's operand
    of the stacked array a); returns the requests in issue order."""
    reqs = [eng.iallreduce(at(v), "x") for v in q["small"]]
    r_mid = eng.iallreduce(at(q["mid"]), "x")
    reqs += [r_mid, eng.ireduce(r_mid, "x", root=2,
                                algorithm="binomial_tree"),
             eng.iallreduce(at(q["big"]), "x", compression="int8")]
    return reqs


def blocking_queue(eng, q: dict, at) -> list:
    out = [eng.allreduce(at(v), "x") for v in q["small"]]
    mid = eng.allreduce(at(q["mid"]), "x")
    return out + [mid, eng.reduce(mid, "x", root=2,
                                  algorithm="binomial_tree"),
                  eng.allreduce(at(q["big"]), "x", compression="int8")]


def vecmat_inputs(size: int, kind: str) -> tuple:
    rng = np.random.default_rng(size + (kind == "normal"))
    if kind == "int":
        return (rng.integers(-8, 9, size=(size,)).astype(np.float32),
                rng.integers(-8, 9, size=(size, size)).astype(np.float32))
    return (rng.normal(size=(size,)).astype(np.float32),
            rng.normal(size=(size, size)).astype(np.float32))


# --------------------------------------------------------------------------
# A child process
# --------------------------------------------------------------------------

def _grid_results(rank: int, n: int) -> dict:
    from repro_torch.core.procgroup import Transport, execute_program_local
    transport = Transport(dist.group.WORLD, range(n))
    out = {}
    for key, sched, segments, codec, inputs in grid(n):
        prog = program(sched, segments, codec)
        xs = grid_inputs(key, sched, n, codec, inputs)
        buf = torch.from_numpy(xs[rank])
        if codec == "bf16":
            buf = buf.bfloat16()
        ops.reset_launch_counts()
        res = execute_program_local(prog, buf, rank, transport)
        out[key] = (res, ops.launch_counts())
    out["transport"] = dict(transport.stats)
    return out


def _engine_results(rank: int, outdir: str) -> dict:
    from repro_torch.core import plugins
    from repro_torch.core.procgroup import ProcessGroupEngine
    from repro_torch.core.schedule import Schedule, Sel, Step
    from repro_torch.launch import distributed_vecmat as vm
    plugins.register_collective("shift_exchange",
                                shift_generator(Schedule, Step, Sel),
                                algorithm="ring_shift")
    out = {}
    eng = ProcessGroupEngine({"x": 4}, device="cpu")
    for name, call, local in ENGINE_CALLS:
        x = engine_input(name, (4,), local)[rank]
        out[name] = call(eng, torch.from_numpy(x))
    eng2 = ProcessGroupEngine(MESH2, device="cpu")
    pos = np.unravel_index(rank, (2, 2))
    for name, call, local in MESH2_CALLS:
        x = engine_input(name, (2, 2), local)[pos]
        out[name] = call(eng2, torch.from_numpy(x))
    # the queue: drained, then the same calls blocking
    q = queue_inputs(4)
    qeng = ProcessGroupEngine({"x": 4}, device="cpu")

    def at(a):
        return torch.from_numpy(a[rank])

    reqs = issue_queue(qeng, q, at)
    qeng.queue.drain()
    out["queue"] = [r.result for r in reqs]
    out["queue_stats"] = dict(qeng.queue.stats)
    out["queue_blocking"] = blocking_queue(qeng, q, at)
    # use case 1
    for kind in ("int", "normal"):
        x, w = vecmat_inputs(VECMAT_SIZE, kind)
        xs = torch.from_numpy(x).reshape(4, -1)[rank]
        ws = torch.from_numpy(w).reshape(4, -1, VECMAT_SIZE)[rank]
        out[f"vecmat_{kind}"] = vm.distributed_vecmat(eng, xs, ws, TILES)
    # the streaming ops differentiate one rank per process
    out["grads"] = streaming_grads(eng, rank)
    # every LM family's step context one rank per process
    out["families"] = family_contexts()
    # an engine over part of the world
    out["subset"] = subset_results(rank, outdir)
    # a rank that asks for another algorithm than its peers
    try:
        eng.allreduce(torch.ones(77), "x",
                      algorithm="ring" if rank else "bidi_ring")
    except RuntimeError as e:
        out["mismatch"] = str(e)
    return out


#: the streaming ops' grads: (op, local input shapes); each rank's
#: cotangent has the output's shape
GRAD_OPS = (("allgather_matmul", ((4, 3), (3, 2))),
            ("matmul_reduce_scatter", ((8, 3), (3, 2))),
            ("ring_attention", ((1, 2, 2, 4), (1, 2, 1, 4), (1, 2, 1, 4))))


def grad_inputs(n: int, shapes, seed: int) -> list:
    """Stacked (n, ...) fp32 inputs of a streaming op."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n,) + s).astype(np.float32)
            for s in shapes]


def grad_call(eng, op: str, ins, cot):
    """(output, grads of sum(op(ins) * cot)) of one streaming op on `eng`
    (stacked or one process's)."""
    ts = [torch.tensor(x, requires_grad=True) for x in ins]
    y = getattr(eng, op)(*ts, "x")
    (y * torch.as_tensor(cot)).sum().backward()
    return (y.detach(),) + tuple(t.grad for t in ts)


def streaming_grads(eng, rank: int) -> dict:
    out = {}
    for i, (op, shapes) in enumerate(GRAD_OPS):
        ins = [x[rank] for x in grad_inputs(4, shapes, 20 + i)]
        y = getattr(eng, op)(*[torch.from_numpy(x) for x in ins], "x")
        cot = np.random.default_rng(30 + i).standard_normal(
            (4,) + tuple(y.shape)).astype(np.float32)[rank]
        out[op] = grad_call(eng, op, ins, cot)
    return out


#: one arch of every LM family (the MoE twice: top-k and mixtral's)
FAMILY_ARCHS = ("qwen3-0.6b", "qwen3-moe-30b-a3b", "mixtral-8x7b",
                "mamba2-1.3b", "hymba-1.5b", "whisper-medium",
                "internvl2-26b")


def family_contexts() -> dict:
    """arch -> what `stages.make_ctx` builds for a reduced config of every
    LM family on this process's `ProcessGroupEngine` over (1, 2, 2): the
    family, the leading mesh dims, whether the context is on local
    shards, its TP size and TP rank, and the engine's coordinates."""
    from repro_torch.configs import ParallelConfig, get_config, \
        reduced_config
    from repro_torch.core.procgroup import ProcessGroupEngine
    from repro_torch.parallel import stages
    mesh = {"pod": 1, "data": 2, "model": 2}
    eng = ProcessGroupEngine(mesh, device="cpu")
    out = {}
    for arch in FAMILY_ARCHS:
        cfg = reduced_config(get_config(arch))
        ctx = stages.make_ctx(cfg, ParallelConfig(), mesh, engine=eng)
        out[arch] = {"family": cfg.family, "lead": ctx.lead,
                     "local": ctx.local, "tp": ctx.tp,
                     "tp_rank": int(ctx.tp_rank()),
                     "coords": dict(eng.coords),
                     "engine": type(ctx.engine).__name__}
    return out


#: the global ranks of a mesh over part of the world, in mesh order
SUBSET = (3, 1)


def subset_results(rank: int, outdir: str):
    """A `ProcessGroupEngine` over global ranks 3 and 1 of the world of
    four ({"x": 2}; mesh rank 0 is global rank 3): the other processes
    create its groups beside it (`mesh_groups`); its members allreduce
    and allgather an integer-valued vector and save it as a checkpoint
    per process through the mesh's group. Returns a member's results,
    None elsewhere."""
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.core.procgroup import ProcessGroupEngine, mesh_groups
    mesh = {"x": 2}
    if rank not in SUBSET:
        mesh_groups(mesh, SUBSET)
        return None
    eng = ProcessGroupEngine(mesh, device="cpu", members=SUBSET)
    x = subset_input(rank)
    out = {"mesh_rank": eng.mesh_rank, "coords": dict(eng.coords),
           "allreduce": eng.allreduce(x, "x"),
           "allgather": eng.allgather(x, "x")}
    save_checkpoint(f"{outdir}/subset_ckpt", 0, {"w": x}, {"w": ("x",)},
                    mesh_shape=mesh, per_process=True, engine=eng)
    return out


def subset_input(rank: int):
    return torch.arange(6.0) + 10 * rank


def run(rank: int, n: int, outdir: str) -> None:
    """One process of an n-rank world: the grid at every n; at n = 4 also
    the engine, the queue, use case 1 and a mismatched program."""
    count_calls()
    res = {"grid": _grid_results(rank, n)}
    if n == 4:
        res.update(_engine_results(rank, outdir))
    torch.save(res, f"{outdir}/rank{rank}.pt")


def fail_fast(rank: int, n: int) -> None:
    """Rank 1 raises at once; rank 0 waits for a message it never
    gets."""
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.recv(torch.zeros(4), src=1)


def hang(rank: int, n: int) -> None:
    """Rank 1 lives on without sending; rank 0 waits for its message
    until the group timeout."""
    if rank == 1:
        time.sleep(120)
    dist.recv(torch.zeros(4), src=1)
