"""The reader of the data plane's in-place share (`metrics/inplace_share.py`)
on made-up spans, where the program counts nothing, and end to end
through the stacked allreduce driver's traced run on the CPU.
"""
import pathlib
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import bench_harness as H  # noqa: E402
import bench_spans  # noqa: E402
from test_perfbench_spans import FakeRecorder, _ev, _run  # noqa: E402

NEW = ("inplace_share.coll", "inplace_share.granite")
IN, DEF = "exchange.in_place", "exchange.deferred"


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("counters,want", [
    ({IN: 28}, 100.0), ({IN: 21, DEF: 7}, 75.0), ({DEF: 3}, 0.0),
    ({}, None)])
def test_share_of_the_root_spans(monkeypatch, name, counters, want):
    """In-place over all exchanges, summed over the traced calls' root
    spans (a child's counters are inside its root's); None where the
    program counts neither, as a program without the counters does."""
    events = [_ev(1, "engine.allreduce", 2000, 40000, **counters),
              _ev(2, "execute_program", 3000, 30000, parent=1, **counters),
              _ev(3, "engine.allreduce", 50000, 90000, call=2, **counters)]
    monkeypatch.setattr(bench_spans, "recorder",
                        lambda: FakeRecorder(events))
    got = H.reader(name)(_run())
    assert got == want


@pytest.mark.parametrize("name", NEW)
def test_no_recorder_reads_nothing(monkeypatch, name):
    monkeypatch.setattr(bench_spans, "recorder", lambda: None)
    assert H.reader(name)(_run()) is None


@pytest.mark.parametrize("kib,want", [(32, 0.0), (1024, 100.0)])
def test_stacked_allreduce_share(kib, want):
    """The allreduce cell's driver on the CPU, traced, at two sizes a rank:
    at 32 KiB the selector picks recursive doubling, whose exchanges all
    stay deferred; at 1 MiB a ring, written wholly in place."""
    import test_perfbench_drivers as D
    c = D._cell("allreduce-fp32-64mib", bytes_per_rank=kib * 1024)
    run = H.run_cell(c, D.SEED, 0.5, True, "cpu")
    assert run.correct, run.checks
    line = H.result_line(run, c, H.benchmark(), True)
    assert line["metrics"]["inplace_share.coll"]["value"] == want


def test_granite_reports_its_share():
    """The Granite cell's driver at a tiny size on the CPU, traced: its
    line holds `inplace_share.granite`, a share of its exchanges."""
    import test_perfbench_granite as G
    cell = G._cell()
    run = H.run_cell(cell, G.SEED, G.SECONDS, True, "cpu")
    assert run.correct, run.checks
    line = H.result_line(run, cell, H.benchmark(), True)
    assert 0.0 < line["metrics"]["inplace_share.granite"]["value"] <= 100.0
