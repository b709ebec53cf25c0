"""The port's offload queue (`repro_torch/core/sequencer.py` and the
engine's queue API) against the reference's.

The same numpy inputs, made from a seed, go through the JAX engine's
queue under `shard_map` on the 8 host devices and through the port's
engine on the CPU with the ranks stacked. Drained results must be equal
BITWISE to the blocking calls and to the reference's, fp32 and bf16; the
queue's model — `makespan`, `serial_cost`, the plan, the recorded result
shapes and byte counts — must be EQUAL (`==`) to the reference's for the
same queue: both run the same float arithmetic on one rank's bytes.
Mirrors `test_sequencer.py` and the queue part of `test_api_surface.py`.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import CollectiveEngine as JaxEngine
from repro.core import engine as jax_engine_mod
from repro.core import plugins as jplugins
from repro.core.hw_spec import ACCL_CLUSTER as JAX_ACCL
from repro.core.schedule import Schedule as JSchedule
from repro.core.schedule import Sel as JSel
from repro.core.schedule import Step as JStep
from repro.core.sequencer import Sequencer as JaxSequencer
from repro.core.topology import Communicator as JaxComm
from repro.core.topology import make_mesh
from repro_torch.core import (
    TIERS, CollectiveEngine, Communicator, Schedule, Sel, Selector, Step,
    engine as engine_mod, plugins, simulator,
)
from repro_torch.core.hw_spec import ACCL_CLUSTER
from repro_torch.core.sequencer import DrainModeError, Request, Sequencer
from tests._hypothesis_compat import given, settings, st

_ENVS = {}


def _env(shape, axes):
    """(JAX engine, its mesh, port engine) on one mesh shape."""
    key = (shape, axes)
    if key not in _ENVS:
        mesh = make_mesh(shape, axes)
        _ENVS[key] = (JaxEngine(mesh), mesh,
                      CollectiveEngine(dict(zip(axes, shape)), device="cpu"))
    return _ENVS[key]


def _jax_stacked(mesh, axes, fn, *Xs):
    """Run fn(*locals) -> tuple on every device; each output stacked by
    mesh position, as float32 numpy."""
    lead = len(axes)
    idx = (0,) * lead
    spec = P(*axes)

    def body(*xs):
        outs = fn(*[x[idx] for x in xs])
        return tuple(o[(None,) * lead] for o in outs)

    g = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec,) * len(Xs),
                              out_specs=spec, check_vma=False))
    return [np.asarray(o.astype(jnp.float32)) for o in g(*Xs)]


def _np32(t):
    return t.float().numpy()


def _draw(rng, shape):
    """Integer-valued inputs: exact in bf16 and in every 8-rank fp32 sum."""
    return rng.integers(-15, 16, size=shape).astype(np.float32)


_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


# --------------------------------------------------------------------------
# Issued == blocking, bitwise, on both packages
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_issued_collectives_bitwise_equal_blocking(dtype):
    """Every built-in collective issued through the queue equals its
    blocking counterpart bit for bit, with waits out of FIFO order and
    the stragglers left to drain() — on the port and on the JAX engine,
    and the two packages' drained results are equal."""
    jeng, mesh, eng = _env((8,), ("x",))
    jdt, tdt = _DTYPES[dtype]
    rng = np.random.default_rng(1)
    shapes = [(48,), (64,), (16,), (24,), (8, 6), (32,), (12,)]
    Xs = [_draw(rng, (8,) + s) for s in shapes]

    def queued(e, a, b, c, d, x5, f, h):
        r1 = e.iallreduce(a, "x")
        r2 = e.ireduce_scatter(b, "x")
        r3 = e.iallgather(c, "x")
        r4 = e.ibcast(d, "x", root=2)
        r5 = e.ialltoall(x5, "x")
        r6 = e.ireduce(f, "x", op="max")
        r7 = e.issue("gather", h, "x", root=1)
        out3, out1 = r3.wait(), r1.wait()   # out of issue order
        e.queue.drain("x")                  # the stragglers via drain
        return (out1, r2.result, out3, r4.result, r5.result, r6.result,
                r7.result)

    def blocking(e, a, b, c, d, x5, f, h):
        return (e.allreduce(a, "x"), e.reduce_scatter(b, "x"),
                e.allgather(c, "x"), e.bcast(d, "x", root=2),
                e.alltoall(x5, "x"), e.reduce(f, "x", op="max"),
                e.gather(h, "x", root=1))

    ts = [torch.from_numpy(X).to(tdt) for X in Xs]
    got = [_np32(o) for o in queued(eng, *ts)]
    want = [_np32(o) for o in blocking(eng, *ts)]
    jXs = [jnp.asarray(X).astype(jdt) for X in Xs]
    ref = _jax_stacked(mesh, ("x",), lambda *v: queued(jeng, *v), *jXs)
    for i, (g, w, r) in enumerate(zip(got, want, ref)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
        np.testing.assert_array_equal(g, r, err_msg=f"request {i} vs jax")


def _linear_scatter(comm, root: int = 0, *, S=Schedule, Stp=Step, Sl=Sel):
    n = comm.size
    steps = tuple(
        Stp(perm=((root, (root + i + 1) % n),), op="copy",
            send_sel=Sl.chunk(lambda r, s, i=i: (root + i + 1) % n),
            recv_sel=Sl.chunk(lambda r, s, i=i: (root + i + 1) % n),
            bytes_frac=1.0 / n, mask_recv=True)
        for i in range(n - 1))
    return S(name="linear", collective="qscatter", nranks=n, steps=steps,
             chunks=n, result="shard", owned_chunk=lambda r: r,
             relay="original")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_issued_plugin_collective_bitwise_equal_blocking(dtype):
    """Out-of-tree (plugin-registered) collectives ride the queue like
    built-ins: icollective == blocking collective == the reference."""
    jeng, mesh, eng = _env((8,), ("x",))
    jdt, tdt = _DTYPES[dtype]
    plugins.register_collective("qscatter", _linear_scatter,
                                algorithm="linear")
    jplugins.register_collective(
        "qscatter", lambda c, root=0: _linear_scatter(
            c, root, S=JSchedule, Stp=JStep, Sl=JSel), algorithm="linear")
    try:
        X = _draw(np.random.default_rng(2), (8, 16))
        t = torch.from_numpy(X).to(tdt)
        got = eng.icollective("qscatter", t, "x", algorithm="linear").wait()
        want = eng.collective("qscatter", t, "x", algorithm="linear")
        (ref,) = _jax_stacked(mesh, ("x",), lambda v: (jeng.icollective(
            "qscatter", v, "x", algorithm="linear").wait(),),
            jnp.asarray(X).astype(jdt))
        np.testing.assert_array_equal(_np32(got), _np32(want))
        np.testing.assert_array_equal(_np32(got), ref)
    finally:
        plugins.unregister_collective("qscatter")
        jplugins.unregister_collective("qscatter")


def test_coalesced_queue_bitwise_equal_blocking_in_engine():
    """Small same-(op, dtype) reductions coalesce into ONE bucketed
    program in the engine drain — and still match the blocking calls
    and the reference's drain bit for bit (the ORDER_SAFE rule), on
    normal fp32 inputs."""
    jeng, mesh, eng = _env((8,), ("x",))
    rng = np.random.default_rng(3)
    Xs = [rng.normal(size=(8, n)).astype(np.float32) for n in (40, 8, 24)]
    before = eng.queue.stats["coalesced_buckets"]

    def queued(e, *vs):
        rs = [e.iallreduce(v, "x", algorithm="recursive_doubling")
              for v in vs]
        return rs[2].wait(), rs[0].wait(), rs[1].wait()

    ts = [torch.from_numpy(X) for X in Xs]
    got = [_np32(o) for o in queued(eng, *ts)]
    assert eng.queue.stats["coalesced_buckets"] == before + 1
    want = [_np32(eng.allreduce(t, "x", algorithm="recursive_doubling"))
            for t in (ts[2], ts[0], ts[1])]
    ref = _jax_stacked(mesh, ("x",), lambda *v: queued(jeng, *v),
                       *[jnp.asarray(X) for X in Xs])
    for g, w, r in zip(got, want, ref):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, r)


def test_itree_allreduce_matches_blocking_and_reference():
    """The queued gradient path (issue-all-then-wait tickets) equals the
    blocking tree_allreduce and the reference's, bitwise, on a mixed
    fp32/bf16 tree with dict keys out of sorted order — with the
    reference's bucket plan (per-rank bytes, dtypes in first-appearance
    order, dict keys sorted)."""
    axes = ("pod", "data", "model")
    jeng, mesh, eng = _env((2, 2, 2), axes)
    rng = np.random.default_rng(4)
    spec = {"w": ((6,), "float32"), "b": ((3,), "float32"),
            "e": ((5,), "bfloat16"), "a": [((4,), "bfloat16"),
                                          ((7,), "float32")]}

    def build(make):
        def leaf(s):
            shape, dt = s
            return make(shape, dt)
        return {"w": leaf(spec["w"]), "b": leaf(spec["b"]),
                "e": leaf(spec["e"]), "a": [leaf(s) for s in spec["a"]]}

    arrays = {}

    def make_np(shape, dt):
        X = rng.normal(size=(2, 2, 2) + shape).astype(np.float32)
        arrays[len(arrays)] = (X, dt)
        return X

    build(make_np)
    it = iter(arrays.values())
    ttree = build(lambda s, d: torch.from_numpy(next(it)[0]).to(
        _DTYPES[d][1]))
    it = iter(arrays.values())
    jtree = build(lambda s, d: jnp.asarray(next(it)[0]).astype(
        _DTYPES[d][0]))
    cap = 24
    got = eng.itree_allreduce(ttree, ("data", "pod"), bucket_bytes=cap)
    got = got.wait()
    want = eng.tree_allreduce(ttree, ("data", "pod"), bucket_bytes=cap)
    specs = jax.tree.map(lambda _: P(*axes), jtree)
    ref = jeng.run(lambda t: jeng.itree_allreduce(
        t, ("data", "pod"), bucket_bytes=cap).wait(),
        in_specs=(specs,), out_specs=specs)(jtree)
    for key in ("w", "b", "e"):
        np.testing.assert_array_equal(_np32(got[key]), _np32(want[key]))
        np.testing.assert_array_equal(
            _np32(got[key]), np.asarray(ref[key].astype(jnp.float32)))
    for g, w, r in zip(got["a"], want["a"], ref["a"]):
        np.testing.assert_array_equal(_np32(g), _np32(w))
        np.testing.assert_array_equal(_np32(g),
                                      np.asarray(r.astype(jnp.float32)))
    assert list(got) == list(ttree)          # the caller's key order
    # the same bucket plan as the reference, over the same leaf order
    leaves, _ = engine_mod._tree_leaves(ttree)
    jleaves = [x[0, 0, 0] for x in jax.tree.leaves(jtree)]
    assert [tuple(x.shape[3:]) for x in leaves] == \
        [tuple(x.shape) for x in jleaves]
    plan = engine_mod._bucket_leaves(leaves, cap, (2, 2, 2))
    assert plan == jax_engine_mod._bucket_leaves(jleaves, cap)
    assert len(plan) >= 3


def test_issue_multi_bitwise_equal_blocking_and_reference():
    """issue_multi over two axes (one tuple-axis request) and three (the
    RS -> recurse -> AG chain with pad/trim hooks) equals the blocking
    allreduce_multi and the reference's."""
    axes = ("pod", "data", "model")
    jeng, mesh, eng = _env((2, 2, 2), axes)
    X = np.random.default_rng(5).normal(size=(2, 2, 2, 10)).astype(
        np.float32)
    t = torch.from_numpy(X)
    for ax in (["data", "pod"], ["data", "pod", "model"]):
        got = eng.issue_multi(t, ax).wait()
        want = eng.allreduce_multi(t, ax)
        (ref,) = _jax_stacked(mesh, axes, lambda v: (
            jeng.issue_multi(v, ax).wait(),), jnp.asarray(X))
        np.testing.assert_array_equal(_np32(got), _np32(want))
        np.testing.assert_array_equal(_np32(got), ref)


# --------------------------------------------------------------------------
# FIFO + dependency ordering (property test)
# --------------------------------------------------------------------------

class _FakeEngine:
    """Duck-typed port engine that records drain order instead of
    executing; enough surface for the sequencer."""

    backend = "microcode"

    def __init__(self, axes):
        self.mesh_shape = dict(axes)
        self.selector = Selector()

    def comm(self, axis):
        return Communicator(axis=axis, size=self.mesh_shape[axis])

    @property
    def stack_shape(self):
        return tuple(self.mesh_shape.values())

    def _run(self, x, axis, **_kw):
        return x

    allreduce = reduce_scatter = allgather = bcast = reduce = _run
    gather = alltoall = _run

    def collective(self, name, x, axis, **_kw):
        return x


class _TracingSequencer(Sequencer):
    def __init__(self, engine, **kw):
        super().__init__(engine, **kw)
        self.order = []

    def _finish(self, r, result):
        super()._finish(r, result)
        self.order.append(r)


@settings(max_examples=25, deadline=None)
@given(data=st.data())
def test_fifo_and_dependency_order_never_violated(data):
    """Property: whatever the wait order, (a) requests on one
    communicator execute in issue order, (b) every dependency — tensor
    identity, explicit `after=`, or a Request operand — executes before
    its dependent."""
    eng = _FakeEngine({"x": 8, "y": 4})
    seq = _TracingSequencer(eng, coalesce_bytes=0)  # ordering only
    reqs, tensors = [], []
    n_req = data.draw(st.integers(min_value=2, max_value=10))
    for _ in range(n_req):
        axis = ("x", "y")[data.draw(st.integers(0, 1))]
        kind = data.draw(st.integers(0, 3)) if reqs else 0
        after = None
        if kind == 1 and tensors:  # same-buffer conflict
            x = tensors[data.draw(st.integers(0, len(tensors) - 1))]
        elif kind == 2:            # request-operand chaining
            x = reqs[data.draw(st.integers(0, len(reqs) - 1))]
        else:
            x = torch.zeros((8, 4, data.draw(st.integers(1, 8)) * 8))
            tensors.append(x)
            if kind == 3:          # explicit after= edge
                after = (reqs[data.draw(st.integers(0, len(reqs) - 1))],)
        reqs.append(seq.issue("allreduce", x, axis, after=after))
    for _ in range(data.draw(st.integers(0, n_req))):
        reqs[data.draw(st.integers(0, n_req - 1))].wait()
    seq.drain()

    assert len(seq.order) == n_req
    done_at = {r: i for i, r in enumerate(seq.order)}
    for axis in ("x", "y"):
        issued = [r for r in reqs if r.axis == axis]
        assert sorted(issued, key=lambda r: done_at[r]) == issued
    for r in reqs:
        for d in r.deps:
            assert done_at[d] < done_at[r]
        if isinstance(r.operand, Request):
            assert done_at[r.operand] < done_at[r]


# --------------------------------------------------------------------------
# Coalescing
# --------------------------------------------------------------------------

_NP_DT = {"float32": np.float32, "int8": np.int8}
_T_DT = {"float32": torch.float32, "int8": torch.int8}


@settings(max_examples=15, deadline=None)
@given(data=st.data())
def test_coalesced_buckets_bitwise_equal_uncoalesced(data):
    """Property: a coalesced bucket's per-request results are bitwise
    equal to running each request alone and to the reference's drain —
    fp32 (non-associative adds: true only because the bucket algorithm's
    combine order is position-independent) and int8 (wrapping adds)."""
    jeng, _mesh, eng = _env((8,), ("x",))
    n = 8
    dt = ("float32", "int8")[data.draw(st.integers(0, 1))]
    op = ("add", "max")[data.draw(st.integers(0, 1))]
    sizes = [data.draw(st.integers(1, 40))
             for _ in range(data.draw(st.integers(2, 4)))]
    prng = np.random.default_rng(data.draw(st.integers(0, 1 << 16)))
    seq, jseq = Sequencer(eng), JaxSequencer(jeng)
    reqs, jreqs, feeds, jfeeds = [], [], {}, {}
    for sz in sizes:
        r = seq.issue("allreduce", torch.zeros((n, sz), dtype=_T_DT[dt]),
                      "x", op=op, algorithm="recursive_doubling")
        jr = jseq.issue("allreduce", np.zeros((sz,), _NP_DT[dt]), "x",
                        op=op, algorithm="recursive_doubling")
        feeds[r] = jfeeds[jr] = [
            prng.integers(-50, 50, size=(sz,)).astype(_NP_DT[dt])
            for _ in range(n)]
        reqs.append(r)
        jreqs.append(jr)
    plan = seq.plan("x")
    assert len(plan) == 1 and plan[0].coalesced      # the bucket formed
    got = seq.simulate_drain(feeds)
    ref = jseq.simulate_drain(jfeeds)
    comm = eng.comm("x")
    sched = eng._cached_schedule("allreduce", "recursive_doubling", comm,
                                 0, op)
    prog = sched.compile()
    for r, jr in zip(reqs, jreqs):
        alone = simulator.run_collective("allreduce", sched, prog, feeds[r])
        for rank in range(n):
            np.testing.assert_array_equal(got[r][rank], alone[rank])
            np.testing.assert_array_equal(got[r][rank], ref[jr][rank])


_ALLREDUCE_ALGOS = ["ring", "bidi_ring", "recursive_doubling",
                    "halving_doubling", "auto"]


@pytest.mark.parametrize("algo", _ALLREDUCE_ALGOS)
def test_coalescing_admits_order_safe_algorithms_only(algo):
    """Tiny same-key allreduces bucket iff every member and the bucket
    resolve to an ORDER_SAFE algorithm — the same decision as the
    reference's."""
    jeng, _mesh, eng = _env((8,), ("x",))
    seq, jseq = Sequencer(eng), JaxSequencer(jeng)
    for n in (16, 40, 24):
        seq.issue("allreduce", torch.zeros((8, n)), "x", algorithm=algo)
        jseq.issue("allreduce", np.zeros((n,), np.float32), "x",
                   algorithm=algo)
    plan, jplan = seq.plan("x"), jseq.plan("x")
    assert [len(it.requests) for it in plan] == \
        [len(it.requests) for it in jplan]
    comm = eng.comm("x")
    for it in plan:
        if it.coalesced:
            picked = seq._resolved_algorithm(
                "allreduce", it.msg_bytes, comm, algo, None, 4)
            assert picked in Sequencer.ORDER_SAFE_ALGORITHMS
    if algo in ("ring", "bidi_ring", "halving_doubling"):
        assert all(not it.coalesced for it in plan)
    if algo == "recursive_doubling":
        assert len(plan) == 1 and plan[0].coalesced
    seq.clear()
    jseq.clear()


def test_conflicting_large_or_mixed_requests_do_not_coalesce():
    _jeng, _mesh, eng = _env((8,), ("x",))
    seq = Sequencer(eng)
    x = torch.zeros((8, 16))
    r1 = seq.issue("allreduce", x, "x", algorithm="recursive_doubling")
    r2 = seq.issue("allreduce", x, "x", algorithm="recursive_doubling")
    assert r2.deps == (r1,)                       # same-tensor conflict
    assert all(not it.coalesced for it in seq.plan("x"))
    seq.clear()
    seq.issue("allreduce", torch.zeros((8, 1 << 18)), "x")
    seq.issue("allreduce", torch.zeros((8, 1 << 18)), "x")
    assert all(not it.coalesced for it in seq.plan("x"))   # > cap per rank
    seq.clear()
    seq.issue("allreduce", torch.zeros((8, 16)), "x")
    seq.issue("allreduce", torch.zeros((8, 16), dtype=torch.int8), "x")
    assert all(not it.coalesced for it in seq.plan("x"))   # dtype split
    seq.clear()
    # the cap counts ONE rank's bytes: 8 x 4096 fp32 stacked is 16 KiB
    # per rank, under the 64 KiB cap, so it still coalesces
    seq.issue("allreduce", torch.zeros((8, 4096)), "x")
    seq.issue("allreduce", torch.zeros((8, 4096)), "x")
    assert [it.coalesced for it in seq.plan("x")] == [True]
    seq.clear()


# --------------------------------------------------------------------------
# The queue model: equal to the reference's for the same queue
# --------------------------------------------------------------------------

def _q_independent(issue, seq):
    for _ in range(4):
        issue(seq, "allreduce", (1 << 16,), "float32", "x")


def _q_chain(issue, seq):
    r = issue(seq, "allreduce", (1 << 16,), "float32", "x")
    for _ in range(3):
        r = seq.issue("allreduce", r, "x")


def _q_coalesced(issue, seq):
    for _ in range(6):
        issue(seq, "allreduce", (64,), "float32", "x")


def _q_mixed(issue, seq):
    r = issue(seq, "reduce_scatter", (1 << 14,), "float32", "x")
    seq.issue("allgather", r, "x")
    issue(seq, "bcast", (300, 2), "float32", "x", root=3)
    issue(seq, "alltoall", (24, 100), "float32", "x")
    issue(seq, "reduce", (999,), "float32", "x", op="max", root=5)
    issue(seq, "gather", (12,), "float32", "x", root=1)
    issue(seq, "allreduce", (1 << 12,), "bfloat16", "x")
    issue(seq, "allreduce", (1 << 12,), "bfloat16", "x")
    issue(seq, "allreduce", (1 << 20,), "float32", "x", compression="int8")
    issue(seq, "allreduce", (4096,), "float32", "x", algorithm="ring",
          segments=4)


def _q_after(issue, seq):
    r1 = issue(seq, "allreduce", (1 << 18,), "float32", "x")
    issue(seq, "allreduce", (1 << 10,), "float32", "x", after=[r1])
    seq.issue("allreduce", r1, "x", after=[])


_QUEUES = {"independent": _q_independent, "chain": _q_chain,
           "coalesced": _q_coalesced, "mixed": _q_mixed, "after": _q_after}


def _issue_jax(seq, coll, shape, dt, axis, **kw):
    return seq.issue(coll, jnp.zeros(shape, _DTYPES[dt][0]), axis, **kw)


def _issue_torch(seq, coll, shape, dt, axis, **kw):
    lead = tuple(seq.engine.mesh_shape.values())
    return seq.issue(coll, torch.zeros(lead + shape, dtype=_DTYPES[dt][1]),
                     axis, **kw)


def _signature(seq, axis, comm=None):
    """Everything the queue model says about `axis`'s queue."""
    reqs = seq.outstanding(axis)
    pos = {r: i for i, r in enumerate(seq.outstanding())}   # every axis
    return {
        "shapes": [tuple(r.shape) for r in reqs],
        "msg_bytes": [r.msg_bytes for r in reqs],
        "deps": [[pos[d] for d in r.deps] for r in reqs],
        "plan": [[pos[r] for r in it.requests] for it in seq.plan(axis)],
        "makespan": seq.makespan(axis, comm=comm),
        "serial": seq.serial_cost(axis, comm=comm),
        "tiered": seq.makespan(axis, tier=TIERS["tcp-like"], drop_prob=0.1),
    }


@pytest.mark.parametrize("name", sorted(_QUEUES))
def test_queue_model_equals_reference(name):
    """makespan, serial_cost (on the engine's fabric, on ACCL_CLUSTER and
    under a lossy tier), the plan, the dependency edges and the recorded
    result shapes are EQUAL to the reference's for the same queue."""
    jeng, _mesh, eng = _env((8,), ("x",))
    seq, jseq = Sequencer(eng), JaxSequencer(jeng)
    _QUEUES[name](_issue_torch, seq)
    _QUEUES[name](_issue_jax, jseq)
    assert _signature(seq, "x") == _signature(jseq, "x")
    accl = Communicator(axis="x", size=8, hw=ACCL_CLUSTER)
    jaccl = JaxComm(axis="x", size=8, hw=JAX_ACCL)
    assert _signature(seq, "x", accl) == _signature(jseq, "x", jaccl)
    if name == "independent":
        assert seq.makespan("x") < seq.serial_cost("x")
    if name == "chain":
        assert seq.makespan("x") == pytest.approx(seq.serial_cost("x"),
                                                  rel=1e-9)
    seq.clear()
    jseq.clear()


def test_issue_multi_queue_model_equals_reference():
    """Two axes fold into one tuple-axis request; three chain over two
    queues — the per-axis plans and prices equal the reference's."""
    jeng, _mesh, eng = _env((2, 2, 2), ("pod", "data", "model"))
    for axes in (["data", "pod"], ["data", "pod", "model"]):
        seq, jseq = Sequencer(eng), JaxSequencer(jeng)
        for s in (seq, jseq):
            op = torch.zeros((2, 2, 2, 1 << 12)) if s is seq \
                else np.zeros((1 << 12,), np.float32)
            s.issue_multi(op, axes)
            s.issue_multi(op, axes)
        assert seq.axes_outstanding() == jseq.axes_outstanding()
        for ax in seq.axes_outstanding():
            sig = _signature(seq, ax)
            sig.pop("tiered")
            jsig = _signature(jseq, ax)
            jsig.pop("tiered")
            assert sig == jsig
        seq.clear()
        jseq.clear()


def test_issue_records_local_result_shapes():
    _jeng, _mesh, eng = _env((8,), ("x",))
    seq = Sequencer(eng)
    r1 = seq.issue("reduce_scatter", torch.zeros((8, 64)), "x")
    assert r1.shape == (8,) and r1.msg_bytes == 64 * 4
    r2 = seq.issue("allgather", r1, "x")
    assert r2.shape == (64,) and r2.msg_bytes == 8 * 4
    assert r2.deps == (r1,)
    r3 = seq.issue("allreduce", torch.zeros((8, 5, 3),
                                            dtype=torch.bfloat16), "x")
    assert r3.shape == (5, 3) and r3.msg_bytes == 5 * 3 * 2
    with pytest.raises(ValueError):
        _ = r2.result  # not materialized yet
    seq.clear()


def test_simulate_drain_honours_op_and_root_under_auto():
    """An auto request with op='max' (or a nonzero root) simulates the
    schedule rebuilt for that op/root, as the engine drain runs it."""
    _jeng, _mesh, eng = _env((8,), ("x",))
    rng = np.random.default_rng(6)
    seq = Sequencer(eng)
    r = seq.issue("allreduce", torch.zeros((8, 32)), "x", op="max")
    feeds = {r: [rng.normal(size=(32,)).astype(np.float32)
                 for _ in range(8)]}
    got = seq.simulate_drain(feeds)
    for rank in range(8):
        np.testing.assert_array_equal(got[r][rank],
                                      np.max(np.stack(feeds[r]), axis=0))
    seq2 = Sequencer(eng)
    r2 = seq2.issue("bcast", torch.zeros((8, 24)), "x", root=3)
    feeds2 = {r2: [rng.normal(size=(24,)).astype(np.float32)
                   for _ in range(8)]}
    got2 = seq2.simulate_drain(feeds2)
    for rank in range(8):
        np.testing.assert_array_equal(got2[r2][rank], feeds2[r2][3])


def test_engine_drain_bitwise_equals_simulate_drain():
    """The same queue drained through the engine (stacked tensors) and
    through the simulator (per-rank numpy) gives the same bits."""
    _jeng, _mesh, eng = _env((8,), ("x",))
    rng = np.random.default_rng(7)
    Xs = {n: rng.normal(size=(8, n)).astype(np.float32)
          for n in (40, 8, 24, 4096)}

    def build(seq):
        reqs = [seq.issue("allreduce", torch.from_numpy(X), "x")
                for X in Xs.values()]
        reqs.append(seq.issue("reduce", reqs[-1], "x", root=2,
                              algorithm="binomial_tree"))
        return reqs

    s_eng, s_sim = Sequencer(eng), Sequencer(eng)
    r_eng, r_sim = build(s_eng), build(s_sim)
    s_eng.drain()
    feeds = {r: list(X) for r, X in zip(r_sim, Xs.values())}
    got = s_sim.simulate_drain(feeds)
    assert s_eng.stats["coalesced_buckets"] == 1
    assert s_sim.stats["coalesced_buckets"] == 1
    for re_, rs in zip(r_eng, r_sim):
        np.testing.assert_array_equal(re_.result.numpy(), np.stack(got[rs]))


# --------------------------------------------------------------------------
# Drain modes, abort, the API surface
# --------------------------------------------------------------------------

def test_mixing_drain_modes_raises():
    _jeng, _mesh, eng = _env((8,), ("x",))
    seq = Sequencer(eng)
    r = seq.issue("allreduce", torch.zeros((8, 16)), "x")
    seq.simulate_drain({r: [np.zeros((16,), np.float32)] * 8})
    seq.issue("allreduce", torch.zeros((8, 16)), "x")
    with pytest.raises(DrainModeError):
        seq.drain()
    seq.clear()
    seq2 = Sequencer(eng)
    seq2.issue("allreduce", torch.zeros((8, 16)), "x").wait()
    r2 = seq2.issue("allreduce", torch.zeros((8, 16)), "x")
    with pytest.raises(DrainModeError):
        seq2.simulate_drain({r2: [np.zeros((16,), np.float32)] * 8})
    seq2.clear()


def test_abort_empties_the_engine_queue():
    eng = CollectiveEngine({"x": 8}, device="cpu")
    a, b = torch.randn(8, 32), torch.randn(8, 32)
    r1 = eng.iallreduce(a, "x", algorithm="ring")
    r2 = eng.iallreduce(b, "x", algorithm="ring")     # never waited
    out = r1.wait()
    dropped = eng.queue.abort()
    assert dropped == [r2] and r2.status == Request.CANCELLED
    assert eng.queue.outstanding() == [] and eng.queue._buffer_owner == {}
    assert torch.equal(out, eng.allreduce(a, "x", algorithm="ring"))
    with Sequencer(eng) as seq:
        r3 = seq.issue("allreduce", a, "x")
        r4 = seq.issue("allreduce", r3, "x")
    assert r3.status == r4.status == Request.CANCELLED
    assert seq.outstanding() == [] and seq._buffer_owner == {}


def _public_params(fn):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()
            if p.name != "self" and not p.name.startswith("_")]


def test_engine_issue_signatures_match_sequencer():
    assert _public_params(CollectiveEngine.issue) == \
        _public_params(Sequencer.issue)
    assert _public_params(CollectiveEngine.issue_multi) == \
        _public_params(Sequencer.issue_multi)
    for name in ("iallreduce", "ireduce_scatter", "iallgather", "ibcast",
                 "ireduce", "ialltoall", "icollective"):
        params = inspect.signature(getattr(CollectiveEngine, name)).parameters
        assert params["after"].default is None
        assert params["timeout"].default is None
        assert params["after"].kind == inspect.Parameter.KEYWORD_ONLY
    # the same public surface as the reference's engine
    for name in ("issue", "issue_multi", "iallreduce", "icollective",
                 "allreduce_multi", "tree_allreduce", "itree_allreduce"):
        assert _public_params(getattr(CollectiveEngine, name)) == \
            _public_params(getattr(JaxEngine, name)), name


def test_queue_property_is_one_sequencer():
    eng = CollectiveEngine({"x": 8}, device="cpu")
    assert eng._queue is None
    assert eng.queue is eng.queue and isinstance(eng.queue, Sequencer)
