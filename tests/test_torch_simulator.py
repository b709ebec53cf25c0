"""The port's numpy simulator (`repro_torch/core/simulator.py`) against
the reference's, and against the port's rank-stacked executor.

One per-rank numpy input per case, made from a seed, goes through
  * the reference's `repro.core.simulator` and the port's copy of it on
    the SAME-named compiled program (each package compiles its own):
    their final buffers must be equal BITWISE, and equal to
    `simulator.oracle` (integer-valued fp32, so every sum is exact);
  * the port's rank-stacked `execute_program` (CPU, plain versions):
    bitwise equal to the port's simulator, at 3 ranks as well as 8.
Every `(collective, algorithm)` in `GENERATORS` at n in {3, 8} (pow2-only
generators at 8), segments {1, 4}, codec {None, int8}. The simulator
executes uncompressed programs only, in both packages: a compressed
program must be refused by both, and runs instead through the port's
stacked executor and the reference's jax executor under `shard_map`,
bitwise. Mirrors `test_ir_parity.py`, `test_stream_fusion.py` and
`test_segmentation.py`. VERIFY_EXHAUSTIVE=1 widens n to {3, 4, 8}.
"""
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import algorithms as JA
from repro.core import simulator as jsim
from repro.core.engine import execute_program as jax_execute
from repro.core.program import compile_schedule as jax_compile
from repro.core.topology import Communicator as JaxComm
from repro.core.topology import make_mesh
from repro_torch.core import algorithms as A
from repro_torch.core import simulator as sim
from repro_torch.core.engine import execute_program
from repro_torch.core.program import (
    Compress, StackedRecv, Stream, StreamChain, compile_schedule,
)
from repro_torch.core.selector import _POW2_ONLY
from repro_torch.core.topology import Communicator

EXHAUSTIVE = bool(os.environ.get("VERIFY_EXHAUSTIVE"))
SIZES = (3, 4, 8) if EXHAUSTIVE else (3, 8)
ROOT = 1
CASES = [(c, a, n) for (c, a) in sorted(A.GENERATORS) for n in SIZES
         if not ((c, a) in _POW2_ONLY and n & (n - 1))]
IDS = [f"{c}-{a}-n{n}" for c, a, n in CASES]


def _schedules(coll, algo, n):
    """(port schedule, reference schedule) of one generator at n ranks."""
    out = []
    for gens, comm in ((A.GENERATORS, Communicator(axis="x", size=n)),
                       (JA.GENERATORS, JaxComm(axis="x", size=n))):
        gen = gens[(coll, algo)]
        kw = {"root": ROOT} if "root" in inspect.signature(gen).parameters \
            else {}
        out.append(gen(comm, **kw))
    return out


def _inputs(coll, sched, n, seed, per_chunk=4, integer=True):
    """Per-rank flat buffers, staged as the engine stages them (own shard
    at its slot for allgather / gather)."""
    rng = np.random.default_rng(seed)

    def draw(size):
        if integer:
            return rng.integers(-20, 21, size).astype(np.float32)
        return rng.normal(size=size).astype(np.float32)

    if coll not in ("allgather", "gather"):
        return [draw(sched.chunks * per_chunk) for _ in range(n)]
    xs = []
    for r in range(n):
        buf = np.zeros((n * per_chunk,), np.float32)
        slot = r if sched.chunk_coords == "absolute" else (r - ROOT) % n
        buf[slot * per_chunk:(slot + 1) * per_chunk] = draw(per_chunk)
        xs.append(buf)
    return xs


def _check_oracle(coll, sched, xs, out):
    """The simulated final buffers against `simulator.oracle`, bitwise."""
    n = len(xs)
    eq = np.testing.assert_array_equal
    if coll == "allreduce":
        for r in range(n):
            eq(out[r], sim.oracle("allreduce", xs))
    elif coll == "reduce_scatter":
        ref = sim.oracle("reduce_scatter", xs)
        cs = xs[0].shape[0] // sched.chunks
        for r in range(n):
            own = sched.owned_chunk(r)
            eq(out[r][own * cs:(own + 1) * cs], ref[own * cs:(own + 1) * cs])
    elif coll in ("allgather", "gather"):
        n_sl = xs[0].shape[0] // n
        shards = []
        for r in range(n):
            slot = r if (coll == "allgather"
                         or sched.chunk_coords == "absolute") \
                else (r - ROOT) % n
            shards.append(xs[r][slot * n_sl:(slot + 1) * n_sl])
        ref = np.concatenate(shards)
        if coll == "allgather":
            for r in range(n):
                eq(out[r], ref)
        else:
            got = out[ROOT]
            if sched.chunk_coords == "relative":
                got = np.roll(got.reshape(n, -1), ROOT, axis=0).reshape(-1)
            eq(got, ref)
    elif coll == "bcast":
        for r in range(n):
            eq(out[r], xs[ROOT])
    elif coll == "reduce":
        eq(out[ROOT], sim.oracle("allreduce", xs))
    elif coll == "alltoall":
        refs = sim.oracle("alltoall", xs)
        for r in range(n):
            eq(out[r], refs[r])
    else:
        raise ValueError(coll)


def _has_codec(prog) -> bool:
    def walk(x):
        if isinstance(x, Compress):
            return True
        if isinstance(x, (tuple, list)):
            return any(walk(y) for y in x)
        return any(walk(getattr(x, f)) for f in ("slots", "body", "bodies")
                   if hasattr(x, f))
    return walk(prog.ops)


def _stacked(prog, xs):
    """The port's rank-stacked executor on the CPU, as per-rank arrays."""
    out = execute_program(prog, torch.from_numpy(np.stack(xs)))
    return list(out.numpy())


_MESHES = {}


def _jax_run(prog, xs):
    """The reference's jax executor under shard_map on n host devices."""
    n = len(xs)
    if n not in _MESHES:
        _MESHES[n] = make_mesh((n,), ("x",))
    g = jax.jit(jax.shard_map(
        lambda v: jax_execute(prog, v[0], "x")[None], mesh=_MESHES[n],
        in_specs=P("x"), out_specs=P("x"), check_vma=False))
    return list(np.asarray(g(jnp.asarray(np.stack(xs)))))


def _equal_lists(a, b):
    assert len(a) == len(b)
    for r, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"rank {r}")


@pytest.mark.parametrize("codec", [None, "int8"])
@pytest.mark.parametrize("segments", [1, 4])
@pytest.mark.parametrize("coll,algo,n", CASES, ids=IDS)
def test_simulator_bitwise_equals_reference(coll, algo, n, segments, codec):
    """Both packages' simulators on their own compile of one schedule:
    bitwise equal, and equal to the oracle; a compressed program is
    refused by both and runs bitwise equal through the two engines'
    executors instead."""
    sched, jsched = _schedules(coll, algo, n)
    prog = compile_schedule(sched, segments=segments, codec=codec)
    jprog = jax_compile(jsched, segments=segments, codec=codec)
    assert prog.describe() == jprog.describe()
    per_chunk = 256 if codec else 4
    xs = _inputs(coll, sched, n, seed=n * 10 + segments,
                 per_chunk=per_chunk)
    if _has_codec(prog):
        with pytest.raises(NotImplementedError):
            sim.execute_program(prog, xs)
        with pytest.raises(NotImplementedError):
            jsim.execute_program(jprog, xs)
        _equal_lists(_stacked(prog, xs), _jax_run(jprog, xs))
        return
    got = sim.execute_program(prog, xs)
    _equal_lists(got, jsim.execute_program(jprog, xs))
    _check_oracle(coll, sched, xs, got)


@pytest.mark.parametrize("segments", [1, 4])
@pytest.mark.parametrize("coll,algo,n", CASES, ids=IDS)
def test_stacked_executor_bitwise_equals_simulator(coll, algo, n, segments):
    """The port's rank-stacked executor runs the same compiled program
    to the same bits as the port's simulator — at 3 ranks too (the
    engine tests run only 8). Normal fp32 inputs: the two must agree on
    every rounding, not only on exact sums."""
    sched, _ = _schedules(coll, algo, n)
    prog = compile_schedule(sched, segments=segments)
    xs = _inputs(coll, sched, n, seed=n + segments, per_chunk=8,
                 integer=False)
    _equal_lists(_stacked(prog, xs), sim.execute_program(prog, xs))


@pytest.mark.parametrize("coll,algo,n", CASES, ids=IDS)
def test_segmented_bitwise_equals_unsegmented(coll, algo, n):
    """Segmentation cuts elementwise combines into disjoint pieces: it
    never changes a value, in the simulator or the stacked executor."""
    sched, _ = _schedules(coll, algo, n)
    xs = _inputs(coll, sched, n, seed=21, per_chunk=8, integer=False)
    base = sim.execute_program(compile_schedule(sched, segments=1), xs)
    seg4 = compile_schedule(sched, segments=4)
    _equal_lists(sim.execute_program(seg4, xs), base)
    _equal_lists(_stacked(seg4, xs), base)


COMM8 = Communicator(axis="x", size=8)
JCOMM8 = JaxComm(axis="x", size=8)
_FUSED_CELLS = [
    ("ring", "ring_allreduce", 4, Stream),
    ("ring", "ring_allreduce", 8, Stream),
    ("bidi_ring", "bidi_ring_allreduce", 4, Stream),
    ("relay", "ring_reduce", 4, Stream),
    ("recursive_halving", "recursive_halving_reduce_scatter", 4,
     StreamChain),
    ("halving_doubling", "halving_doubling_allreduce", 4, StreamChain),
    ("recursive_doubling_ag", "recursive_doubling_allgather", 4,
     StreamChain),
    ("linear_alltoall", "linear_alltoall", 4, StreamChain),
]
# every chunk (bidi: 1/16 of the buffer) splits into whole 256-element
# int8 scale blocks at k <= 8, so the streams really stream
XL = list(np.random.default_rng(4).normal(size=(8, 16384))
          .astype(np.float32))


@pytest.mark.parametrize("codec", [None, "int8"])
@pytest.mark.parametrize("name,gen,k,kind", _FUSED_CELLS,
                         ids=[f"{c[0]}-k{c[2]}" for c in _FUSED_CELLS])
def test_fused_bitwise_equals_unfused(name, gen, k, kind, codec):
    """Streamed and chained programs equal their unfused forms bitwise —
    in the port's simulator (uncompressed) and stacked executor (int8
    too) — and the port's simulator equals the reference's on the fused
    program."""
    sched = getattr(A, gen)(COMM8)
    if codec is not None and all(s.op == "copy" for s in sched.steps):
        codec = None      # codecs compress combine wires only
    fused = compile_schedule(sched, segments=k, codec=codec)
    plain = compile_schedule(sched, segments=k, codec=codec, stream=False)
    assert any(isinstance(op, kind) for op in fused.ops)
    assert not any(isinstance(op, (Stream, StreamChain)) for op in plain.ops)
    _equal_lists(_stacked(fused, XL), _stacked(plain, XL))
    if codec is None:
        got = sim.execute_program(fused, XL)
        _equal_lists(got, sim.execute_program(plain, XL))
        _equal_lists(got, _stacked(fused, XL))
        jfused = jax_compile(getattr(JA, gen)(JCOMM8), segments=k)
        _equal_lists(got, jsim.execute_program(jfused, XL))


def test_stacked_recv_bitwise_equals_unrolled():
    """The stacked-receive peephole (linear alltoall): one STACKED_RECV,
    bitwise equal to the unrolled program and to the oracle, in the
    simulator and the stacked executor."""
    sched = A.linear_alltoall(COMM8)
    stacked = compile_schedule(sched)
    plain = compile_schedule(sched, stacked=False)
    assert [type(op) for op in stacked.ops] == [StackedRecv]
    X = list(np.random.default_rng(3).normal(size=(8, 2048))
             .astype(np.float32))
    got = sim.execute_program(stacked, X)
    _equal_lists(got, sim.execute_program(plain, X))
    _equal_lists(got, _stacked(stacked, X))
    _equal_lists(got, sim.oracle("alltoall", X))
