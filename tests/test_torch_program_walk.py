"""The program's one execution-order walk (`core/program.py::batches`)
and the one choice of kernel path (`core/engine.py::exchange_path`),
on the CPU. Held here:
  * for every registered generator at 2-8 ranks, 1 and 4 segments, with
    no codec and with int8: the walk's exchanges, with their bodies and
    requested segments, are the pricing walk's (`Program.exchange_terms`)
    expanded by multiplicity, in order, and their steps are the
    schedule's, each once, in order;
  * each batch's in-place verdict equals a brute force over the ranks'
    concrete rows, a LOOP's or STREAM's proved over all its iterations
    (one hand-built LOOP whose iterations differ);
  * for each combination of codec, op, relay register and in-place
    verdict: the path `exchange_path` names, and the kernels one
    exchange on it launches on the stacked executor, which are the
    per-rank executor's implied launches (`implied_launches`) where it
    does not write in place.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import engine as tengine
from repro_torch.core import plugins, simulator
from repro_torch.core.procgroup import implied_launches
from repro_torch.core.program import (
    SRC_BUFFER, SRC_RECEIVED, Batch, Compress, Copy, Decompress, Loop,
    Program, RecvCombine, SegLoop, Send, batches, compile_schedule,
)
from repro_torch.core.schedule import Sel
from repro_torch.kernels import ops

from test_torch_inplace_write import CASES, _brute_safe, _schedule

GRID = [(c, a, n, segments, codec) for c, a, n in CASES
        for segments in (1, 4) for codec in (None, "int8")]
IDS = [f"{c}-{a}-n{n}-k{k}-{codec}" for c, a, n, k, codec in GRID]


def _program(coll, algo, n, segments, codec):
    sched = _schedule(coll, algo, n)
    return sched, compile_schedule(sched, segments=segments, codec=codec)


def _runs(prog) -> list:
    """The walk's batches in runs: the iterations of one LOOP or STREAM
    (the same slot bodies, iteration after iteration) make one run, any
    other batch a run of its own."""
    runs = []
    for b in batches(prog):
        if not isinstance(b, Batch):
            continue
        last = runs[-1][-1] if runs else None
        if last is not None and len(last.exchanges) == len(b.exchanges) \
                and all(x[0] is y[0] for x, y in zip(last.exchanges,
                                                     b.exchanges)):
            runs[-1].append(b)
        else:
            runs.append([b])
    return runs


@pytest.mark.parametrize("coll,algo,n,segments,codec", GRID, ids=IDS)
def test_walk_is_the_pricing_walk_unrolled(coll, algo, n, segments, codec):
    sched, prog = _program(coll, algo, n, segments, codec)
    folded = [(len(run), k, body) for run in _runs(prog)
              for body, k, _step in run[0].exchanges]
    assert folded == [(m, k, body)
                      for m, k, body, _region in prog.exchange_terms()]
    steps = [(body, step) for b in batches(prog) if isinstance(b, Batch)
             for body, _k, step in b.exchanges]
    assert [s for _b, s in steps] == list(range(len(sched.steps)))
    assert all(body[0].step in (None, s) for body, s in steps)
    rolls = [c.kind for c in batches(prog) if isinstance(c, Copy)]
    assert rolls == [op.kind for op in prog.ops
                     if isinstance(op, Copy) and op.kind != "load"]


def _brute(batch, n: int, chunks: int) -> bool:
    return _brute_safe([b for b, _k, _s in batch.exchanges],
                       [s for _b, _k, s in batch.exchanges], n, chunks)


@pytest.mark.parametrize("coll,algo,n,segments,codec", GRID, ids=IDS)
def test_batch_verdicts_match_brute_force(coll, algo, n, segments, codec):
    _sched, prog = _program(coll, algo, n, segments, codec)
    for run in _runs(prog):
        want = all(_brute(b, n, prog.chunks) for b in run)
        assert [b.in_place for b in run] == [want] * len(run)
        if len(run) == 1 and len(run[0].exchanges) > 1:
            # a STACKED_RECV: proved together as each body alone
            assert want == all(
                _brute_safe([body], [step], n, prog.chunks)
                for body, _k, step in run[0].exchanges)


def test_loop_verdict_covers_every_iteration():
    """A LOOP whose first iteration is safe and whose second is not: rank
    r sends its chunk r each step and combines into chunk r - 1 + step,
    which at step 1 is the chunk it sends. Both iterations defer, and
    the run equals the numpy model's."""
    n = 4
    slot = (Copy("load", Sel.chunk(lambda r, s: r)),
            Send(tuple((r, (r + 1) % n) for r in range(n))),
            RecvCombine("add", Sel.chunk(lambda r, s: (r - 1 + s) % n)))
    prog = Program(name="drift", collective="drift", nranks=n, chunks=n,
                   relay=SRC_BUFFER, segments=1, codec=None,
                   ops=(Loop(base=0, trip=2, period=1, slots=(slot,)),))
    walk = batches(prog)
    assert [b.in_place for b in walk] == [False, False]
    assert [s for b in walk for _body, _k, s in b.exchanges] == [0, 1]
    assert _brute(walk[0], n, n) and not _brute(walk[1], n, n)
    X = torch.arange(n * n * 3, dtype=torch.float32).reshape(n, n * 3)
    want = simulator.execute_program(prog, [x.numpy() for x in X])
    assert torch.equal(tengine.execute_program(prog, X),
                       torch.from_numpy(np.stack(want)))


# -- the path of one exchange and what it launches ----------------------------

N, K = 4, 4                      # ranks; segments, each one int8 block
K1, K2, K3, COPY = ("fused_combine", "quantize_blocks", "dequantize_blocks",
                    "region_copy")
# (codec, op, relay register) -> in place: (path, launches); deferred: ...
TABLE = {
    (None, "add", False): (("in_place", {K1: 1}), ("indexed", {K1: 1})),
    (None, "add", True): (("gather", {K1: K}), ("gather", {K1: K})),
    (None, "copy", False): (("in_place", {COPY: 1}), ("gather", {})),
    (None, "copy", True): (("gather", {}), ("gather", {})),
    ("int8", "add", False): (("codec", {K2: 1, K3: 1}),
                             ("codec", {K2: 1, K3: 1})),
    ("int8", "add", True): (("codec", {K2: 1, K3: 2}),
                            ("codec", {K2: 1, K3: 2})),
    ("int8", "copy", False): (("codec", {K2: 1, K3: 1}),
                              ("codec", {K2: 1, K3: 1})),
    ("int8", "copy", True): (("codec", {K2: 1, K3: 2}),
                             ("codec", {K2: 1, K3: 2})),
    ("bf16", "add", False): (("gather", {K1: K}), ("gather", {K1: K})),
    ("bf16", "add", True): (("gather", {K1: K}), ("gather", {K1: K})),
    ("bf16", "copy", False): (("gather", {}), ("gather", {})),
    ("bf16", "copy", True): (("gather", {}), ("gather", {})),
}
PATHS = [(*key, in_place) for key in TABLE for in_place in (True, False)]

_ENTRIES = {K1: ("fused_combine", "fused_combine_at"),
            K2: ("quantize_int8", "quantize_int8_at"),
            K3: ("dequantize_int8", "dequantize_int8_at"),
            COPY: ("region_copy",)}


def _one_exchange(codec, op: str, relay: bool) -> Program:
    """A ring shift of K segments: rank r sends its chunk r (of the buffer,
    or of the relay register) to rank r + 1, which combines it into its
    chunk r. No rank writes a chunk any rank reads, so it proves safe."""
    perm = tuple((r, (r + 1) % N) for r in range(N))
    load = Copy("load", Sel.chunk(lambda r, s: r),
                SRC_RECEIVED if relay else SRC_BUFFER, step=0)
    recv = RecvCombine(op, Sel.chunk(lambda r, s: (r - 1) % N), step=0,
                       track_recv=relay)
    wire = (Compress(codec), Send(perm), Decompress(codec)) if codec \
        else (Send(perm),)
    return Program(name="shift", collective="shift", nranks=N, chunks=N,
                   relay=SRC_RECEIVED if relay else SRC_BUFFER, segments=K,
                   codec=codec, ops=(SegLoop(K, (load, *wire, recv)),))


@pytest.mark.parametrize("codec,op,relay,in_place", PATHS)
def test_exchange_path_and_its_launches(monkeypatch, codec, op, relay,
                                        in_place):
    prog = _one_exchange(codec, op, relay)
    (batch,) = batches(prog)
    ((body, k_req, _step),) = batch.exchanges
    assert batch.in_place and k_req == K
    path, launches = TABLE[codec, op, relay][0 if in_place else 1]
    got_path = tengine.exchange_path(
        codec and plugins.get_codec(codec), body[-1], in_place)
    assert got_path == path
    want = dict(dict.fromkeys(ops.KERNELS, 0), **launches)

    made = dict.fromkeys(ops.KERNELS, 0)
    for kernel, names in _ENTRIES.items():
        for name in names:
            def counted(*a, _fn=getattr(ops, name), _k=kernel, **kw):
                made[_k] += 1
                return _fn(*a, **kw)
            monkeypatch.setattr(ops, name, counted)
    real = tengine.exchange_path
    monkeypatch.setattr(tengine, "exchange_path",
                        lambda c, recv, _proved: real(c, recv, in_place))
    g = torch.Generator().manual_seed(7)
    X = torch.randn((N, N * K * 256), generator=g)
    got = tengine.execute_program(prog, X)
    assert made == want
    if not in_place:
        for r in range(N):
            assert implied_launches(prog, r, tuple(X.shape[1:])) == want
    if op == "add" and codec is None:
        src = torch.roll(X, 1, 0).reshape(N, N, -1)
        rows = torch.arange(N)
        want_x = X.reshape(N, N, -1).clone()
        want_x[rows, (rows - 1) % N] += src[rows, (rows - 1) % N]
        assert torch.equal(got, want_x.reshape(X.shape))
