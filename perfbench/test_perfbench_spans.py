"""The readers of the program's spans (`bench_spans.py`, the metrics
`control_ms`, `dataplane_ms`, `launch_ms`, `model_ms.dlrm` and
`idle_dataplane`) on a made-up trace and made-up spans of known nesting,
and end to end on the CPU through a driver's traced run.
"""
import pathlib
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import bench_harness as H  # noqa: E402
import bench_spans  # noqa: E402
from bench_trace import Trace  # noqa: E402

E = bench_spans.ENTRY_NS
NEW = ("control_ms.coll", "control_ms.dlrm", "dataplane_ms.coll",
       "dataplane_ms.dlrm", "launch_ms.coll", "launch_ms.dlrm",
       "model_ms.dlrm", "idle_dataplane.coll", "idle_dataplane.dlrm")


def _ev(id_, name, start, end, parent=None, call=1, **counters):
    return {"type": "span", "name": name, "ts": start, "dur": end - start,
            "id": id_, "parent": parent, "call": call, "pid": 3,
            "counters": counters, "args": {}}


# two calls inside the window [1000, 101000]: an allreduce, then a batch
# whose lookup holds an engine allreduce; two spans lie outside
EVENTS = [
    _ev(100, "engine.allreduce", 500, 1500, call=0, **{E: 777}),
    _ev(1, "engine.allreduce", 2000, 40000, **{E: 5000}),
    _ev(2, "engine.resolve", 3000, 5000, parent=1),
    _ev(3, "selector.choose", 3500, 4500, parent=2),
    _ev(4, "engine.compile", 5000, 6000, parent=1),
    _ev(5, "execute_program", 6000, 38000, parent=1, **{E: 5000}),
    _ev(6, "exchange", 7000, 20000, parent=5, **{E: 3000}),
    _ev(7, "exchange", 20000, 37000, parent=5, **{E: 2000}),
    _ev(8, "dlrm.serve", 50000, 100000, call=2, **{E: 4000}),
    _ev(9, "dlrm.lookup", 51000, 70000, parent=8, call=2, **{E: 4000}),
    _ev(10, "engine.allreduce", 60000, 69000, parent=9, call=2, **{E: 1000}),
    _ev(11, "execute_program", 61000, 68000, parent=10, call=2,
        **{E: 1000}),
    _ev(12, "dlrm.fc", 70000, 90000, parent=8, call=2),
    _ev(101, "engine.allreduce", 200000, 300000, call=3, **{E: 999}),
]
# device busy [1000, 8000], [10000, 30000], [45000, 55000], [62000, 100000]
OPS = [("k", 1000, 7000), ("k", 10000, 20000), ("k", 45000, 10000),
       ("k", 62000, 38000)]


class FakeRecorder:
    dropped = 0

    def __init__(self, events):
        self.events = events

    def spans(self, t0_ns=None, t1_ns=None):
        return [e for e in self.events if e["ts"] >= t0_ns
                and e["ts"] + e["dur"] <= t1_ns]


def _run(ops=OPS, calls=2):
    t = Trace(window_s=100e-6, calls=calls, items=calls, t0_ns=1000,
              t1_ns=101_000, ops=list(ops),
              spans=[("harness.call", 1500, 45000),
                     ("harness.call", 49000, 100500)])
    return H.Run(setup_s=1.0, window_s=1.0, done=[(None, 1)] * calls,
                 attempted=calls, failed=0, checks={}, memory_peak_bytes=0,
                 device_kind="cpu", device_count=1, trace=t)


@pytest.fixture
def fake(monkeypatch):
    monkeypatch.setattr(bench_spans, "recorder",
                        lambda: FakeRecorder(EVENTS))


def test_self_times_and_nesting(fake):
    sp = {s.id: s for s in bench_spans.spans(_run())}
    assert set(sp) == set(range(1, 13))            # the window's alone
    assert [sp[i].depth for i in (1, 2, 3, 5, 6, 8, 9, 10, 11)] == \
        [0, 1, 2, 1, 2, 0, 1, 2, 3]
    want = {1: 3000, 2: 1000, 3: 1000, 4: 1000, 5: 2000, 6: 10000,
            7: 15000, 8: 11000, 9: 7000, 10: 2000, 11: 6000, 12: 20000}
    assert {i: s.self_ns for i, s in sp.items()} == want
    assert sp[9].entry_ns == 3000 and sp[5].entry_ns == 0


def test_per_call_values(fake):
    run = _run()
    sp = bench_spans.spans(run)
    assert bench_spans.control_ns(sp) == 3000      # selector.choose inside
    assert bench_spans.dataplane_ns(sp) == 2000 + 10000 + 15000 + 6000
    assert bench_spans.entry_ns(sp) == 9000
    assert bench_spans.model_ns(sp) == 11000 + 7000 + 20000
    assert bench_spans.api_ns(sp) == 3000 + 2000
    got = {m: H.reader(m)(run) for m in NEW}
    assert got["control_ms.coll"] == got["control_ms.dlrm"] == \
        pytest.approx(0.0015)
    assert got["dataplane_ms.coll"] == pytest.approx(0.0165)
    assert got["launch_ms.dlrm"] == pytest.approx(0.0045)
    assert got["model_ms.dlrm"] == pytest.approx(0.019)


def test_idle_goes_to_the_innermost_span(fake):
    run = _run()
    idle = bench_spans.idle_by_span(run)
    # gaps: [8000, 10000] in exchange 6; [30000, 45000] (mid 37500) past
    # exchange 7, in execute_program; [55000, 62000] in dlrm.lookup;
    # [100000, 101000] in no span
    assert idle == {"exchange": 2000, "execute_program": 15000,
                    "dlrm.lookup": 7000, "none": 1000}
    assert H.reader("idle_dataplane.coll")(run) == \
        pytest.approx(100.0 * 17000 / 25000)
    busy = [("k", 1000, 100_000)]
    assert H.reader("idle_dataplane.dlrm")(_run(ops=busy)) is None
    far = [(n, s + 10**12, d) for n, s, d in OPS]    # clocks disagree
    assert bench_spans.idle_by_span(_run(ops=far)) is None


def test_split_adds_up(fake):
    s = bench_spans.split(_run())
    p = s["parts_ms"]
    assert p["api"] == pytest.approx(0.0025)
    assert p["model"] == pytest.approx(0.019)
    # the harness's spans less the program's roots inside them
    assert p["harness:harness.call"] == pytest.approx(
        (43500 - 38000 + 51500 - 50000) / 2 / 1e6)
    assert s["counters_per_call"][E] == 4500
    assert s["spans_per_call"]["exchange"] == 1.0
    assert s["ops_inside_spans"] == 1.0
    assert s["parts_sum_ms"] == pytest.approx(sum(p.values()))


def test_no_recorder_reads_nothing(monkeypatch):
    monkeypatch.setattr(bench_spans, "recorder", lambda: None)
    run = _run()
    for m in NEW:
        assert H.reader(m)(run) is None
    assert bench_spans.split(run) is None
    monkeypatch.setattr(bench_spans, "recorder",
                        lambda: FakeRecorder([]))
    for m in NEW:
        assert H.reader(m)(run) is None


@pytest.mark.parametrize("cell", ["allreduce-fp32-64mib", "dlrm-table2-b32"])
def test_traced_cpu_run_reports_every_new_metric(cell):
    """A driver's traced run on the CPU at a tiny size: the cell's line
    holds every new metric its `workloads` name but the idle share, which
    needs device operations, and the parts of a call do not exceed
    it."""
    sys.path.insert(0, str(HERE))
    import test_perfbench_drivers as D
    c = D._stacked() if cell.startswith("allreduce") else D._dlrm()
    run = H.run_cell(c, D.SEED, 0.5, True, "cpu")
    assert run.correct, run.checks
    line = H.result_line(run, c, H.benchmark(), True)
    want = {m["name"] for m in H.benchmark()["per_layer"]
            if m["name"] in NEW and cell in m["workloads"]
            and not m["name"].startswith("idle_dataplane")}
    assert want and want <= set(line["metrics"])
    s = bench_spans.split(run)
    call = s["call_ms"]
    p = s["parts_ms"]
    assert 0 < p["control"] + p["dataplane"] + p["launch"] + p["model"] \
        <= call
    assert s["counters_per_call"][E] > 0
