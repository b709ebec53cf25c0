"""The port's fault model (`repro_torch/core/faults.py`) and its faulty
simulated drain (`Sequencer.simulate_drain(fault_plan=...)`) against the
reference's.

The same queue, the same per-rank numpy feeds (made from a seed) and the
same `FaultPlan` go through both packages' sequencers: every request
must end in the same typed terminal state, a recovered one BITWISE equal
to the fault-free drain and to the reference's result, and the virtual
clock — each drained item's [start, end], retries and backoff, read off
the telemetry trace — EQUAL to the reference's. `degrade=True` replans on
the survivors in both. Mirrors `test_faults.py`; the fault sweep runs a
small grid by default and the full one with VERIFY_EXHAUSTIVE=1.
"""
import itertools
import os

import numpy as np
import pytest
import torch

from repro.core import FaultPlan as JaxFaultPlan
from repro.core import TIERS as JAX_TIERS
from repro.core import CollectiveEngine as JaxEngine
from repro.core import telemetry as jtelemetry
from repro.core.faults import ReliabilityTier as JaxTier
from repro.core.sequencer import Sequencer as JaxSequencer
from repro.core.topology import make_mesh
from repro_torch.core import (
    TIERS, CollectiveEngine, FaultPlan, Request, RequestCancelled,
    Sequencer, telemetry,
)
from repro_torch.core.faults import (
    PeerFailedError, ReliabilityTier, TransportTimeout,
)
from tests._hypothesis_compat import given, settings, st

EXHAUSTIVE = bool(os.environ.get("VERIFY_EXHAUSTIVE"))
_ENV = {}


def _engines():
    if not _ENV:
        _ENV["e"] = (JaxEngine(make_mesh((8,), ("x",))),
                     CollectiveEngine({"x": 8}, device="cpu"))
    return _ENV["e"]


def _leaf(r):
    """A request whose operand is a tensor or array (in either package),
    not another request."""
    return type(r.operand).__name__ != "Request"


def _feeds(reqs, seed, local_shape, np_dtype, n=8):
    """Integer-valued per-rank feeds for the leaf requests, in issue
    order (exact fp32 sums, wrapping int8 sums)."""
    rng = np.random.default_rng(seed)
    return [[rng.integers(-20, 20, size=local_shape).astype(np_dtype)
             for _ in range(n)] for r in reqs if _leaf(r)]


def _virtual_clock(tracer):
    """(rids, start, end, status, retries, backoff) of every drained item,
    from the trace's virtual-clock `request` intervals."""
    return [(tuple(e["args"]["rids"]), e["ts"], e["ts"] + e["dur"],
             e["args"]["status"], e["args"]["retries"],
             e["args"]["backoff_s"])
            for e in tracer.to_chrome_trace()["traceEvents"]
            if e.get("ph") == "X" and e.get("name") == "request"]


def _drain_both(build, local_shape, np_dtype, t_dtype, seed, plan_kw=None,
                tier=None, degrade=False):
    """Build one queue in each package, drain both through the simulator
    under the same fault plan; returns ((reqs, out, clock) port,
    (reqs, out, clock) reference)."""
    jeng, eng = _engines()
    res = []
    for pkg in ("port", "jax"):
        if pkg == "port":
            seq, tel = Sequencer(eng), telemetry
            make = lambda: torch.zeros((8,) + local_shape,  # noqa: E731
                                       dtype=t_dtype)
            plan = FaultPlan(**plan_kw) if plan_kw is not None else None
            tr_tier = TIERS[tier] if tier else None
        else:
            seq, tel = JaxSequencer(jeng), jtelemetry
            make = lambda: np.zeros(local_shape, np_dtype)  # noqa: E731
            plan = JaxFaultPlan(**plan_kw) if plan_kw is not None else None
            tr_tier = JAX_TIERS[tier] if tier else None
        reqs = build(seq, make)
        feeds = dict(zip([r for r in reqs if _leaf(r)],
                         _feeds(reqs, seed, local_shape, np_dtype)))
        with tel.use(tel.Tracer()) as tr:
            out = seq.simulate_drain(feeds, fault_plan=plan, tier=tr_tier,
                                     degrade=degrade)
        assert seq.outstanding() == []
        res.append((reqs, out, _virtual_clock(tr)))
    return res


def _assert_same(port, ref):
    (reqs, out, clock), (jreqs, jout, jclock) = port, ref
    assert [r.status for r in reqs] == [r.status for r in jreqs]
    assert [type(r.error).__name__ for r in reqs] == \
        [type(r.error).__name__ for r in jreqs]
    for r, jr in zip(reqs, jreqs):
        if r.status == Request.DONE:
            assert len(out[r]) == len(jout[jr])
            for a, b in zip(out[r], jout[jr]):
                np.testing.assert_array_equal(a, b)
        else:
            assert r not in out
    assert clock == jclock


# --------------------------------------------------------------------------
# The fault model: the reference's numbers
# --------------------------------------------------------------------------

def test_tiers_and_backoff_equal_reference():
    assert set(TIERS) == set(JAX_TIERS)
    for name in TIERS:
        t, j = TIERS[name], JAX_TIERS[name]
        assert t.backoff_schedule() == j.backoff_schedule()
        for p in (0.0, 0.05, 0.5, 0.9, 1.0):
            assert t.expected_transmissions(p) == j.expected_transmissions(p)
            assert t.expected_backoff(p) == j.expected_backoff(p)
    assert TIERS["tcp-like"].backoff_schedule() == \
        (2e-6, 4e-6, 8e-6, 1.6e-5, 3.2e-5)
    capped = ReliabilityTier("t", max_retries=30, backoff_base=1e-6,
                             backoff_cap=1e-4)
    assert capped.backoff_schedule() == JaxTier(
        "t", max_retries=30, backoff_base=1e-6,
        backoff_cap=1e-4).backoff_schedule()
    assert max(capped.backoff_schedule()) == 1e-4


def test_fault_plan_decisions_equal_reference():
    plan = FaultPlan(seed=7, drop_prob=0.3, flaps=((0, 1, 2, 5),),
                     dead=((3, 4),))
    jplan = JaxFaultPlan(seed=7, drop_prob=0.3, flaps=((0, 1, 2, 5),),
                         dead=((3, 4),))
    coords = list(itertools.product(range(6), range(4), range(4), range(3)))
    got = [plan.drops_segment(*c) for c in coords]
    assert got == [jplan.drops_segment(*c) for c in coords]
    assert any(got) and not all(got)
    assert got == [plan.drops_segment(*c) for c in coords]   # deterministic
    for x in range(8):
        assert plan.dead_at(x) == jplan.dead_at(x)
        assert plan.link_flapped(0, 1, x) == jplan.link_flapped(0, 1, x)


# --------------------------------------------------------------------------
# Typed terminal states and the virtual clock, against the reference
# --------------------------------------------------------------------------

def _two_rings(seq, make):
    return [seq.issue("allreduce", make(), "x", algorithm="ring")
            for _ in range(2)]


def _ring_then_dependent(seq, make):
    r1 = seq.issue("allreduce", make(), "x", algorithm="ring")
    return [r1, seq.issue("allreduce", r1, "x", algorithm="ring")]


def _deadlines(seq, make):
    return [seq.issue("allreduce", make(), "x", algorithm="ring",
                      timeout=1.0),
            seq.issue("allreduce", make(), "x", algorithm="ring",
                      timeout=1e-12)]


def _three_rings(seq, make):
    return [seq.issue("allreduce", make(), "x", algorithm="ring")
            for _ in range(3)]


_SCENARIOS = {
    "tcp_recovers_drops": (_two_rings, dict(drops=frozenset(
        {(0, 0, 1), (3, 2, 3)})), "tcp-like", False),
    "udp_loss_times_out": (_two_rings, dict(drops=frozenset({(0, 0, 1)})),
                           "udp-like", False),
    "dead_rank_cascades": (_ring_then_dependent, dict(dead=((2, 0),)),
                           "tcp-like", False),
    "virtual_deadline": (_deadlines, None, None, False),
    "flap_with_backoff": (_two_rings, dict(flaps=((1, 2, 0, 2),)),
                          "tcp-like", False),
    "degrade_replans": (_three_rings, dict(dead=((3, 2),)), "tcp-like",
                        True),
}


@pytest.mark.parametrize("name", sorted(_SCENARIOS))
def test_faulty_drain_equals_reference(name):
    build, plan_kw, tier, degrade = _SCENARIOS[name]
    port, ref = _drain_both(build, (64,), np.float32, torch.float32,
                            seed=11, plan_kw=plan_kw, tier=tier,
                            degrade=degrade)
    _assert_same(port, ref)
    reqs = port[0]
    if name == "tcp_recovers_drops":
        # recovered requests are bitwise equal to the fault-free drain
        clean, _ = _drain_both(build, (64,), np.float32, torch.float32,
                               seed=11)
        assert all(r.status == Request.DONE for r in reqs)
        for r, c in zip(reqs, clean[0]):
            for a, b in zip(port[1][r], clean[1][c]):
                np.testing.assert_array_equal(a, b)
        assert sum(x[4] for x in port[2]) > 0          # it did retry
    if name == "udp_loss_times_out":
        assert reqs[0].status == Request.TIMED_OUT
        assert isinstance(reqs[0].error, TransportTimeout)
        with pytest.raises(TransportTimeout):
            reqs[0].wait()
    if name == "dead_rank_cascades":
        assert reqs[0].status == Request.PEER_FAILED
        assert isinstance(reqs[0].error, PeerFailedError)
        assert reqs[0].error.rank == 2
        assert reqs[1].status == Request.CANCELLED
        with pytest.raises(RequestCancelled):
            reqs[1].wait()
    if name == "virtual_deadline":
        assert [r.status for r in reqs] == [Request.DONE, Request.TIMED_OUT]
    if name == "degrade_replans":
        assert reqs[0].status == Request.PEER_FAILED
        for r in reqs[1:]:
            assert r.status == Request.DONE and len(port[1][r]) == 7


# --------------------------------------------------------------------------
# The chaos property, against the reference: the same typed outcome, the
# same bits, the same virtual clock — or bitwise the fault-free result
# --------------------------------------------------------------------------

_CHAOS_CASES = [("allreduce", "ring"), ("allreduce", "recursive_doubling"),
                ("bcast", "binomial_tree")]


def _chaos_queue(collective, algorithm):
    def build(seq, make):
        kw = {"root": 1} if collective == "bcast" else {}
        reqs = [seq.issue(collective, make(), "x", algorithm=algorithm, **kw)
                for _ in range(3)]
        reqs.append(seq.issue("allreduce", reqs[0], "x", algorithm="ring"))
        return reqs
    return build


def _chaos_check(seed, drop_prob, tier, dtype, case, dead):
    np_dt, t_dt = {"float32": (np.float32, torch.float32),
                   "int8": (np.int8, torch.int8)}[dtype]
    build = _chaos_queue(*case)
    plan_kw = dict(seed=seed, drop_prob=drop_prob, dead=dead)
    port, ref = _drain_both(build, (32,), np_dt, t_dt, seed, plan_kw, tier)
    _assert_same(port, ref)
    clean, _ = _drain_both(build, (32,), np_dt, t_dt, seed)
    for r, c in zip(port[0], clean[0]):
        assert r.finished
        if r.status == Request.DONE:
            for a, b in zip(port[1][r], clean[1][c]):
                np.testing.assert_array_equal(a, b)
        else:
            assert r.status in (Request.TIMED_OUT, Request.CANCELLED,
                                Request.PEER_FAILED)
            with pytest.raises(Exception):
                r.wait()


@settings(max_examples=12, deadline=None)
@given(data=st.data())
def test_chaos_bitwise_or_typed_failure_equals_reference(data):
    _chaos_check(
        seed=data.draw(st.integers(min_value=0, max_value=10_000)),
        drop_prob=data.draw(st.sampled_from([0.0, 0.05, 0.3, 0.9])),
        tier=data.draw(st.sampled_from(sorted(TIERS))),
        dtype=data.draw(st.sampled_from(["float32", "int8"])),
        case=data.draw(st.sampled_from(_CHAOS_CASES)),
        dead=data.draw(st.sampled_from([(), ((1, 3),), ((6, 0),)])))


_SWEEP = list(itertools.product(
    range(4) if EXHAUSTIVE else (5,),
    (0.0, 0.05, 0.3, 0.9) if EXHAUSTIVE else (0.05, 0.3),
    sorted(TIERS),
    _CHAOS_CASES,
    ((), ((1, 3),), ((6, 0),)) if EXHAUSTIVE else ((), ((1, 3),))))


@pytest.mark.parametrize("seed,drop_prob,tier,case,dead", _SWEEP)
def test_fault_sweep_equals_reference(seed, drop_prob, tier, case, dead):
    """The fault sweep: every (drop rate, tier, schedule, dead rank) cell
    ends as the reference's does. VERIFY_EXHAUSTIVE=1 runs the full grid
    (4 seeds x 4 drop rates x 3 tiers x 3 schedules x 3 death plans)."""
    _chaos_check(seed, drop_prob, tier, "float32", case, dead)


# --------------------------------------------------------------------------
# Cancel and abort on the port
# --------------------------------------------------------------------------

def test_cancel_request_and_dependents():
    _jeng, eng = _engines()
    seq = Sequencer(eng)
    r1 = seq.issue("allreduce", torch.zeros((8, 8)), "x")
    r2 = seq.issue("allreduce", r1, "x")
    r3 = seq.issue("allreduce", torch.zeros((8, 8)), "x")
    r1.cancel()
    assert r1.status == r2.status == Request.CANCELLED
    assert r3.status == Request.PENDING
    r1.cancel()                            # idempotent
    assert seq.outstanding() == [r3]


def test_context_manager_aborts_on_exception_mid_drain():
    _jeng, eng = _engines()
    with pytest.raises(RuntimeError, match="boom"):
        with Sequencer(eng) as seq:
            r1 = seq.issue("allreduce", torch.randn(8, 16), "x")
            seq.issue("allreduce", torch.randn(8, 16), "x")
            r1.wait()
            raise RuntimeError("boom")
    assert seq.outstanding() == [] and seq._buffer_owner == {}
    assert r1.status == Request.DONE
