"""The port's mesh-level makespan (`repro_torch/core/mesh_cost.py`)
against the reference's, and a port trace against the reference's
through `scripts/trace_report.py`.

The same queues — issued in each package, mesh-stacked tensors in the
port and local arrays in the reference — compose to EQUAL (`==`)
`MeshMakespan.total()`, `report()` and `timeline()`: shared and disjoint
fabrics, dependency chains across communicators, lossy tiers and a
what-if fabric. A trace of `simulate_drain` and one of
`MeshMakespan.timeline()`, each made in a fresh process per package,
give the same `trace_report.py --json` summary. Mirrors
`test_mesh_cost.py` and the trace part of `test_telemetry.py`.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import CollectiveEngine as JaxEngine
from repro.core import MeshMakespan as JaxMeshMakespan
from repro.core import PricingEnv as JaxPricingEnv
from repro.core import TIERS as JAX_TIERS
from repro.core.sequencer import Sequencer as JaxSequencer
from repro.core.topology import Communicator as JaxComm
from repro.core.topology import make_mesh
from repro_torch.core import (
    TIERS, CollectiveEngine, Communicator, FabricOccupancy, MeshMakespan,
    PricingEnv, Sequencer,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
_ENVS = {}


def _env(shape, axes):
    key = (shape, axes)
    if key not in _ENVS:
        _ENVS[key] = (JaxEngine(make_mesh(shape, axes)),
                      CollectiveEngine(dict(zip(axes, shape)), device="cpu"))
    return _ENVS[key]


class _Pkg:
    """One package's side of a scenario: its sequencer, makespan and
    operands (mesh-stacked tensors in the port, local arrays in the
    reference)."""

    def __init__(self, port: bool, shape, axes):
        jeng, eng = _env(shape, axes)
        self.port = port
        self.eng = eng if port else jeng
        self.Seq = Sequencer if port else JaxSequencer
        self.MM = MeshMakespan if port else JaxMeshMakespan
        self.Env = PricingEnv if port else JaxPricingEnv
        self.tiers = TIERS if port else JAX_TIERS
        self.Comm = Communicator if port else JaxComm
        self.lead = tuple(shape)

    def zeros(self, n):
        if self.port:
            return torch.zeros(self.lead + (n,))
        return np.zeros((n,), np.float32)

    def fill(self, seq, axis, nbytes, n=4):
        for _ in range(n):
            seq.issue("allreduce", self.zeros(nbytes // 4), axis)


def _single(p):
    s = p.Seq(p.eng)
    p.fill(s, "x", 1 << 20)
    return p.MM.of(s)


def _single_tier(p):
    s = p.Seq(p.eng)
    p.fill(s, "x", 1 << 18)
    return p.MM.of(s, p.Env(tier=p.tiers["tcp-like"], drop_prob=0.1))


def _shared(p):
    a, b = p.Seq(p.eng), p.Seq(p.eng)
    p.fill(a, "x", 1 << 24, n=8)
    p.fill(b, "x", 1 << 24, n=8)
    return p.MM().add(a, "x").add(b, "x")


def _shared_tiered(p):
    a, b = p.Seq(p.eng), p.Seq(p.eng)
    p.fill(a, "x", 1 << 20)
    p.fill(b, "x", 1 << 20)
    env = p.Env(tier=p.tiers["tcp-like"], drop_prob=0.3)
    return p.MM().add(a, "x", env).add(b, "x", env)


def _dep_chain(p):
    s = p.Seq(p.eng)
    r = s.issue("reduce_scatter", p.zeros(1 << 16), "x")
    s.issue("allgather", r, "x")
    return p.MM.of(s)


def _what_if(p):
    s = p.Seq(p.eng)
    p.fill(s, "x", 1 << 20)
    return p.MM.of(s, p.Env(comm=p.Comm(axis="x", size=8, is_dcn=True)))


def _disjoint(p):
    d, q = p.Seq(p.eng), p.Seq(p.eng)
    p.fill(d, "data", 1 << 22)
    p.fill(q, "pod", 1 << 22)
    return p.MM().add(d, "data").add(q, "pod")


def _two_dcn(p):
    a, b = p.Seq(p.eng), p.Seq(p.eng)
    p.fill(a, "pod", 1 << 24, n=8)
    p.fill(b, "pod", 1 << 24, n=8)
    return p.MM().add(a, "pod").add(b, "pod")


def _multi_chain(p):
    s = p.Seq(p.eng)
    s.issue_multi(p.zeros(1 << 16), ["data", "pod", "model"])
    s.issue_multi(p.zeros(1 << 12), ["data", "pod"])
    p.fill(s, "model", 1 << 16, n=2)
    return p.MM.of(s)


_MESH8 = ((8,), ("x",))
_MESH222 = ((2, 2, 2), ("pod", "data", "model"))
_SCENARIOS = {
    "single": (_single, _MESH8), "single_tier": (_single_tier, _MESH8),
    "shared": (_shared, _MESH8), "shared_tiered": (_shared_tiered, _MESH8),
    "dep_chain": (_dep_chain, _MESH8), "what_if": (_what_if, _MESH8),
    "disjoint": (_disjoint, _MESH222), "two_dcn": (_two_dcn, _MESH222),
    "multi_chain": (_multi_chain, _MESH222),
}


@pytest.mark.parametrize("name", sorted(_SCENARIOS))
def test_mesh_makespan_equals_reference(name):
    build, (shape, axes) = _SCENARIOS[name]
    mm = build(_Pkg(True, shape, axes))
    jmm = build(_Pkg(False, shape, axes))
    assert mm.total() == jmm.total()
    assert mm.report() == jmm.report()
    tl, jtl = mm.timeline(), jmm.timeline()
    assert tl == jtl
    ends = [iv["end_s"] for part in ("queues", "requests", "links")
            for iv in tl[part]]
    assert max(ends) == tl["end_s"] == mm.total()


def test_single_queue_composes_to_its_own_makespan():
    p = _Pkg(True, *_MESH8)
    seq = p.Seq(p.eng)
    p.fill(seq, "x", 1 << 20)
    assert MeshMakespan.of(seq).total() == seq.makespan("x")
    seq.clear()
    p = _Pkg(True, *_MESH222)
    seq = p.Seq(p.eng)
    for _ in range(3):
        seq.issue_multi(p.zeros(1 << 16), ["pod", "data"])
    (axis,) = seq.axes_outstanding()
    assert isinstance(axis, tuple)           # the folded two-level request
    assert MeshMakespan.of(seq).total() == seq.makespan(axis)
    seq.clear()


def test_shared_link_serializes_and_disjoint_fabrics_do_not():
    shared = _shared(_Pkg(True, *_MESH8))
    ms = shared._queues[0][0].makespan("x")
    total = shared.total()
    assert 0.95 * 2 * ms <= total <= 2 * ms
    p = _Pkg(True, *_MESH222)
    d, q = p.Seq(p.eng), p.Seq(p.eng)
    p.fill(d, "data", 1 << 22)
    p.fill(q, "pod", 1 << 22)
    md, mp = d.makespan("data"), q.makespan("pod")
    total = MeshMakespan().add(d, "data").add(q, "pod").total()
    assert max(md, mp) <= total <= 1.05 * max(md, mp)
    rep = _two_dcn(p).report()
    assert set(rep["links"]) == {FabricOccupancy.DCN_UPLINK}


# --------------------------------------------------------------------------
# trace_report.py: the port's trace summarises as the reference's does
# --------------------------------------------------------------------------

_TRACE_SCRIPT = r'''
import json, os, sys
import numpy as np
pkg, drain_path, timeline_path = sys.argv[1:4]
if pkg == "repro":
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")
    from repro.core import (CollectiveEngine, FaultPlan, MeshMakespan,
                            TIERS, telemetry)
    from repro.core.sequencer import Request, Sequencer
    from repro.core.topology import make_mesh
    eng = CollectiveEngine(make_mesh((8,), ("x",)))
    zeros = lambda n: np.zeros((n,), np.float32)
else:
    import torch
    from repro_torch.core import (CollectiveEngine, FaultPlan, MeshMakespan,
                                  TIERS, telemetry)
    from repro_torch.core.sequencer import Request, Sequencer
    eng = CollectiveEngine({"x": 8}, device="cpu")
    zeros = lambda n: torch.zeros((8, n))

def queue():
    seq = Sequencer(eng)
    reqs = [seq.issue("allreduce", zeros(256), "x", algorithm="ring")
            for _ in range(2)]
    r = seq.issue("reduce_scatter", zeros(256), "x")
    reqs += [r, seq.issue("allgather", r, "x")]
    for _ in range(3):
        reqs.append(seq.issue("allreduce", zeros(16), "x"))
    return seq, reqs

with telemetry.use(telemetry.Tracer()) as tr:
    seq, reqs = queue()
    rng = np.random.default_rng(3)
    feeds = {q: [rng.integers(-20, 20, size=(256 if i < 3 else 16,))
                 .astype(np.float32) for _ in range(8)]
             for i, q in enumerate(x for x in reqs
                                   if not isinstance(x.operand, Request))}
    seq.simulate_drain(feeds,
                       fault_plan=FaultPlan(drops=frozenset({(0, 0, 1)})),
                       tier=TIERS["tcp-like"])
json.dump(tr.to_chrome_trace(), open(drain_path, "w"))
seq, _ = queue()
tr = telemetry.Tracer()
tr.ingest_timeline(MeshMakespan.of(seq).timeline())
json.dump(tr.to_chrome_trace(), open(timeline_path, "w"))
'''


def _report(path):
    out = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "trace_report.py"),
         str(path), "--json"], capture_output=True, text=True, check=True,
        cwd=ROOT)
    return json.loads(out.stdout)


def test_trace_report_summary_equals_reference(tmp_path):
    """One drain (ring retries under a tcp-like tier, a dependency chain,
    a coalesced bucket) and one mesh timeline, traced in a fresh process
    per package: `trace_report.py --json` summarises both alike."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    reports = {}
    for pkg in ("repro", "repro_torch"):
        drain, timeline = tmp_path / f"{pkg}_d.json", tmp_path / f"{pkg}_t.json"
        subprocess.run([sys.executable, "-c", _TRACE_SCRIPT, pkg,
                        str(drain), str(timeline)], check=True, env=env,
                       cwd=ROOT)
        reports[pkg] = (_report(drain), _report(timeline))
    (d, t), (jd, jt) = reports["repro_torch"], reports["repro"]
    assert d == jd and t == jt
    assert d["links"] and len(d["requests"]) >= 4
    assert d["control"].get("instant:transport.retry", 0) > 0
    assert t["virtual_end_s"] > 0.0
