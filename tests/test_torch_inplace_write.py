"""The data plane's in-place write on the CPU: the compile-time proof
(each `Batch` verdict of `core/program.py::batches`) and the executor
that follows it.

Where the proof holds, `execute_program` writes each exchange straight
into the stacked buffer through its target index (K1's in-place entry,
the indexed copy) instead of computing it into a fresh tensor and
scattering it after. Held here:
  * the verdict of every registered schedule generator, at 2-8 ranks and
    1 or 4 segments, against a brute-force check of each rank's concrete
    rows (the engine's `_spans` on a real buffer length);
  * the programs the benchmark's cells run prove safe, and recursive
    doubling's whole-buffer regions do not;
  * the in-place run equals the deferred run bitwise, through the plain
    versions, for every collective, fp32 and bf16, with and without the
    int8 codec, and counts its exchanges into `exchange.in_place` /
    `exchange.deferred`.
"""
import inspect

import pytest
import torch

from repro_torch.core import CollectiveEngine, telemetry
from repro_torch.core import algorithms as A
from repro_torch.core import engine as tengine
from repro_torch.core.program import (
    SRC_BUFFER, Batch, Copy, Loop, RecvCombine, SegLoop, Send, StackedRecv,
    Stream, StreamChain, batches, compile_schedule, split_exchange,
)
from repro_torch.core.selector import _POW2_ONLY
from repro_torch.core.topology import Communicator
from repro_torch.kernels import ops, ref

SIZES = (2, 3, 4, 5, 8)
CASES = [(c, a, n) for (c, a) in sorted(A.GENERATORS) for n in SIZES
         if not ((c, a) in _POW2_ONLY and n & (n - 1))]
ROOT = 1


def _schedule(coll: str, algo: str, n: int):
    gen = A.GENERATORS[(coll, algo)]
    kw = {"root": ROOT % n} if "root" in inspect.signature(gen).parameters \
        else {}
    return gen(Communicator(axis="x", size=n), **kw)


# -- the proof against a brute force ------------------------------------------

def _rows_of(sel, chunks: int, length: int, rank: int, step) -> set:
    """The buffer rows region `sel` names in one rank's buffer."""
    return {row for start, ln in tengine._spans(sel, chunks, length, rank,
                                                step)
            for row in range(start, start + ln)}


def _brute_safe(bodies, steps, n: int, chunks: int) -> bool:
    """Concrete rows: which rows of which rank every body writes and which
    rows of the buffer its payloads read, on a buffer of 3 rows a chunk."""
    length = 3 * chunks
    writes, reads = [], []       # (rank, rows)
    for body, step in zip(bodies, steps):
        load, recv = body[0], body[-1]
        send = next(o for o in body if isinstance(o, Send))
        dsts = recv.dsts if recv.dsts is not None else range(n)
        src_of = {d: s for s, d in send.perm}
        for d in dsts:
            writes.append((d, _rows_of(recv.sel, chunks, length, d, step)))
            if load.source == SRC_BUFFER:
                s = src_of[d]
                reads.append((s, _rows_of(load.sel, chunks, length, s, step)))
    for i, (r, w) in enumerate(writes):
        if any(q == r and w & rows for q, rows in reads):
            return False
        if any(q == r and w & rows for q, rows in writes[i + 1:]):
            return False
    return True


def _brute_plan(prog) -> tuple:
    """The program's ops walked as the executor walks them, each group of
    exchanges that reads one buffer state checked by `_brute_safe`."""
    n, chunks, ops_ = prog.nranks, prog.chunks, prog.ops

    def alone(body):
        return _brute_safe([body], [body[0].step], n, chunks)

    out = []
    for i, op in enumerate(ops_):
        if isinstance(op, (Loop, Stream)):
            bodies = [split_exchange(s)[0] for s in op.slots] \
                if isinstance(op, Loop) else list(op.slots)
            out.append(all(_brute_safe(
                bodies, [op.base + it * op.period + j
                         for j in range(len(bodies))], n, chunks)
                for it in range(op.trip)))
        elif isinstance(op, (StreamChain, StackedRecv)):
            out.append(tuple(alone(b) for b in op.bodies))
        elif isinstance(op, SegLoop):
            out.append(alone(op.body))
        elif isinstance(op, Copy) and op.kind == "load":
            j = i
            while not isinstance(ops_[j], RecvCombine):
                j += 1
            out.append(alone(ops_[i:j + 1]))
        else:
            out.append(None)
    return tuple(out)


def _expanded(plan, prog) -> list:
    """The per-op brute plan in the walk's batch order: a LOOP's or
    STREAM's verdict once an iteration, a STREAM_CHAIN's once a body, and
    a STACKED_RECV's bodies, each proved alone, as one batch."""
    out = []
    for op, v in zip(prog.ops, plan):
        if isinstance(op, (Loop, Stream)):
            out.extend([v] * op.trip)
        elif isinstance(op, StackedRecv):
            out.append(all(v))
        elif isinstance(v, tuple):
            out.extend(v)
        elif v is not None:
            out.append(v)
    return out


def _verdicts(prog) -> list:
    return [b.in_place for b in batches(prog) if isinstance(b, Batch)]


@pytest.mark.parametrize("segments", [1, 4])
@pytest.mark.parametrize("coll,algo,n", CASES,
                         ids=[f"{c}-{a}-n{n}" for c, a, n in CASES])
def test_verdict_matches_brute_force(coll, algo, n, segments):
    """The compile-time verdict of every registered generator equals a
    brute-force check over each rank's concrete rows, batch for batch."""
    prog = compile_schedule(_schedule(coll, algo, n), segments=segments)
    assert _verdicts(prog) == _expanded(_brute_plan(prog), prog)
    assert batches(prog) is batches(prog)       # walked once a program


@pytest.mark.parametrize("coll,algo,segments,shape", [
    ("allreduce", "bidi_ring", 32, (Stream, Stream)),
    ("alltoall", "linear", 32, (StreamChain,)),
    ("allgather", "ring", 16, (Stream,))])
def test_benchmark_programs_prove_safe(coll, algo, segments, shape):
    """The programs the allreduce and Granite cells run at 8 ranks (the
    64 MiB allreduce and Granite's bf16 allreduces, its dispatch
    alltoall, its regather allgather) write every exchange in place."""
    prog = compile_schedule(_schedule(coll, algo, 8), segments=segments)
    assert tuple(type(op) for op in prog.ops) == shape
    verdicts = _verdicts(prog)
    assert verdicts and all(verdicts)


@pytest.mark.parametrize("segments", [1, 4])
def test_recursive_doubling_stays_deferred(segments):
    """Recursive doubling's whole-buffer (SEL_ALL) regions overlap: each
    rank's write lands where its partner's payload is read, so every
    exchange keeps the deferred write."""
    prog = compile_schedule(_schedule("allreduce", "recursive_doubling", 8),
                            segments=segments)
    verdicts = _verdicts(prog)
    assert len(verdicts) == 3 and not any(verdicts)


# -- the executor: in place against deferred, bitwise -------------------------

def _input(shape, dtype, seed: int):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


def _run(prog, buf, groups, deferred: bool, monkeypatch):
    """(result, counters) of one run; all writes deferred if asked."""
    with monkeypatch.context() as m:
        if deferred:
            path = tengine.exchange_path
            m.setattr(tengine, "exchange_path",
                      lambda codec, recv, _proved: path(codec, recv, False))
        rec = telemetry.WallTracer()
        with telemetry.use(rec):
            out = tengine.execute_program(prog, buf, groups=groups)
    return out, rec.counters


EXEC_CASES = [(c, a, codec) for (c, a) in sorted(A.GENERATORS)
              for codec in ((None, "int8") if c in ("allreduce",
                                                    "reduce_scatter")
                            else (None,))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("coll,algo,codec", EXEC_CASES,
                         ids=[f"{c}-{a}-{k}" for c, a, k in EXEC_CASES])
def test_in_place_equals_deferred_bitwise(monkeypatch, coll, algo, codec,
                                          dtype):
    """Every collective's every algorithm, fp32 and bf16, at 8 ranks in two
    groups and 4 segments: the run that writes in place where the program
    proves it equals the run that defers every write, bit for bit, and
    each exchange counts once, in place or deferred."""
    n, groups = 8, 2
    sched = _schedule(coll, algo, n)
    prog = compile_schedule(sched, segments=4, codec=codec)
    buf = _input((groups * n, sched.chunks * 4 * 5, 3), dtype, seed=40)
    got, c_in = _run(prog, buf, groups, False, monkeypatch)
    want, c_def = _run(prog, buf, groups, True, monkeypatch)
    assert torch.equal(got, want)
    exchanges = c_def["exchange.deferred"]
    assert c_def.get("exchange.in_place", 0) == 0
    in_place = _expected_in_place(prog)
    assert c_in.get("exchange.in_place", 0) == in_place
    assert c_in.get("exchange.deferred", 0) == exchanges - in_place


def _expected_in_place(prog) -> int:
    """Exchanges a run of `prog` writes in place: those its batch proves
    that have a kernel to write them (no codec, no relay register)."""
    def path(body, in_place) -> str:
        codec = tengine._codec_of(tengine._split_wire(body[1:-1])[0])
        return tengine.exchange_path(codec, body[-1], in_place)

    return sum(path(body, b.in_place) == "in_place"
               for b in batches(prog) if isinstance(b, Batch)
               for body, _k, _step in b.exchanges)


@pytest.mark.parametrize("L,width", [(8 * 2 * 32, 1), (8 * 2 * 32 * 3, 5),
                                     (8 * 2 * 32 * 64, 2)])
def test_bidi_ring_writes_every_exchange_in_place(L, width):
    """One `bidi_ring` x 32 allreduce at 8 ranks, at any size the program
    admits, writes all 28 of its exchanges in place (the spans say so);
    a `recursive_doubling` one defers its 3."""
    eng = CollectiveEngine({"x": 8}, device="cpu")
    X = _input((8, L, width), torch.float32, seed=41)
    rec = telemetry.WallTracer()
    with telemetry.use(rec):
        got = eng.allreduce(X, "x", algorithm="bidi_ring", segments=32)
    assert rec.counters["exchange.in_place"] == 28
    assert rec.counters.get("exchange.deferred", 0) == 0
    spans = [e for e in rec.spans() if e["name"] == "exchange"]
    assert len(spans) == 28 and all(e["args"]["in_place"] for e in spans)
    torch.testing.assert_close(got, X.sum(0).expand_as(X), rtol=1e-5,
                               atol=1e-4)
    rec = telemetry.WallTracer()
    with telemetry.use(rec):
        eng.allreduce(X, "x", algorithm="recursive_doubling")
    assert rec.counters.get("exchange.in_place", 0) == 0
    assert rec.counters["exchange.deferred"] == 3


def test_counters_only_while_recording():
    """Without a recorder the executor counts nothing."""
    before = dict(telemetry.WALL.counters)
    eng = CollectiveEngine({"x": 8}, device="cpu")
    eng.allreduce(_input((8, 64), torch.float32, seed=42), "x",
                  algorithm="ring")
    assert telemetry.LIVE is None and telemetry.WALL.counters == before


# -- the entry points' plain versions -------------------------------------------

def _ring_index(L: int, k: int, step: int, rows: int = 8):
    """Target and payload indices of ring step `step`: rank d combines
    chunk (d - 1 - step) of rank d - 1 into its own."""
    c = L // rows
    tgt = tuple((((d - 1 - step) % rows * c, c),) for d in range(rows))
    src = tuple((d - 1) % rows for d in range(rows))
    return (tengine._region_index(tuple(range(rows)), tgt, k, "cpu"),
            tengine._region_index(src, tgt, k, "cpu"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["add", "max", "min", "mul"])
def test_k1_in_place_plain_version(op, dtype):
    """K1 with its target's own index as the write index: the buffer
    afterwards is the buffer with the out-of-place result scattered into
    the target region; the call returns the buffer."""
    a = _input((8, 8 * 12, 2), dtype, seed=43)
    tgt, pay = _ring_index(8 * 12, 3, 1)
    want = a.clone()
    tengine._scatter(want, tgt, ref.fused_combine_at(a, tgt, a, pay, op))
    got = a.clone()
    assert ops.fused_combine_at(got, tgt, got, pay, op, in_place=True) \
        is got
    assert torch.equal(got, want)


def test_k1_in_place_refuses_another_write_index():
    """An in-place K1 writes only through its target's own index: it
    takes no `out` beside it and no other output dtype."""
    a = _input((8, 8 * 4), torch.float32, seed=44)
    tgt, pay = _ring_index(8 * 4, 1, 0)
    with pytest.raises(ValueError, match="out"):
        ops.fused_combine_at(a, tgt, a, pay, "add",
                             out=torch.empty((1, 8, 4)), in_place=True)
    with pytest.raises(ValueError, match="dtype"):
        ops.fused_combine_at(a, tgt, a, pay, "add",
                             out_dtype=torch.bfloat16, in_place=True)
    with pytest.raises(ValueError, match="dtype"):
        ref.fused_combine_at(a, tgt, a, pay, "add", torch.bfloat16,
                             in_place=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_region_copy_plain_version(dtype):
    """The indexed copy writes the payload region into the target region
    and leaves every other element as it was."""
    a = _input((8, 8 * 6, 3), dtype, seed=45)
    tgt, pay = _ring_index(8 * 6, 2, 2)
    want = a.clone()
    tengine._scatter(want, tgt, tengine._gather(a, pay))
    got = a.clone()
    assert ops.region_copy(got, pay, got, tgt) is got
    assert torch.equal(got, want)
