"""Each driver end to end on the CPU at a tiny size, with the port's plain
kernels, against the plain reference: a sound run is `correct`; the
control (the reference in bfloat16 in the program's place) and the
timed path broken in each way its cell can be are not.
"""
import json
import pathlib
import sys
import tempfile

import pytest

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import bench_harness as H  # noqa: E402

SEED = 2**31 + 12345          # larger than 32 signed bits hold
SECONDS = 0.3


def _cell(name, **sizes):
    cell = H.load_cell(name)
    cell.config = dict(cell.config, **sizes)
    return cell


def _stacked():
    return _cell("allreduce-fp32-64mib", bytes_per_rank=8 * 1024 * 4)


def _dlrm():
    cell = _cell("dlrm-table2-b32", n_tables=8, emb_dim=16,
                 rows_per_table=1000, fc_dims=[64, 32])
    cell.workload = dict(cell.workload,
                         params=dict(cell.params, pool=16))
    return cell


def _procs():
    cell = _cell("allreduce-procs4-fp32-64mib", bytes_per_rank=4096 * 4,
                 processes=2, mesh={"model": 2})
    cell.workload = dict(cell.workload, params=dict(cell.params, inputs=2))
    return cell


def _no_exchange_stacked(monkeypatch):
    from repro_torch.core import engine
    monkeypatch.setattr(engine, "_run_exchange", lambda *a, **k: None)


def _no_exchange_dlrm(monkeypatch):
    from repro_torch.core.engine import CollectiveEngine
    orig = CollectiveEngine.allreduce
    # the lookup's allreduce (the partial concat vectors) left out
    monkeypatch.setattr(CollectiveEngine, "allreduce",
                        lambda self, x, axis, **k: self._tensor(x))
    assert orig is not CollectiveEngine.allreduce


@pytest.mark.parametrize("trace", [False, True])
def test_stacked_allreduce_sound(trace):
    cell = _stacked()
    run = H.run_cell(cell, SEED, SECONDS, trace, "cpu")
    assert run.correct, run.checks
    assert run.attempted == len(run.done) > 0
    gap = run.checks["allreduce_gap"][0]
    assert 0 <= gap <= 7 * 2.0 ** -24          # (n - 1) u: any fp32 order
    line = H.result_line(run, cell, H.benchmark(), trace)
    assert list(line)[-1] == "checks"
    if trace:
        assert run.trace is not None and run.trace.calls >= 1
    else:
        assert set(line["metrics"]) == {"call_ms", "setup_s"}


@pytest.mark.parametrize("program", [
    "fault_cases:allreduce_control", "fault_cases:allreduce_unchanged",
    "fault_cases:allreduce_half", "fault_cases:allreduce_altered",
    "no_exchange"])
def test_stacked_allreduce_faults_fail(program, monkeypatch):
    if program == "no_exchange":
        _no_exchange_stacked(monkeypatch)
        program = None
    run = H.run_cell(_stacked(), SEED, SECONDS, False, "cpu",
                     program=program)
    assert not run.correct, run.checks


def test_dlrm_sound():
    cell = _dlrm()
    # a longer window: a loaded host may serve one batch in 0.3 s, and a
    # percentile needs two
    run = H.run_cell(cell, SEED, 2.0, False, "cpu")
    assert run.correct, run.checks
    assert run.attempted == 32 * len(run.done) > 0
    line = H.result_line(run, cell, H.benchmark(), False)
    want = {"qps", "setup_s"} | ({"batch_p95_ms"} if len(run.done) > 1
                                 else set())
    assert set(line["metrics"]) == want


@pytest.mark.parametrize("program", [
    "fault_cases:dlrm_control", "fault_cases:dlrm_unchanged",
    "fault_cases:dlrm_half", "fault_cases:dlrm_altered", "no_exchange"])
def test_dlrm_faults_fail(program, monkeypatch):
    if program == "no_exchange":
        _no_exchange_dlrm(monkeypatch)
        program = None
    run = H.run_cell(_dlrm(), SEED, SECONDS, False, "cpu", program=program)
    assert not run.correct, run.checks


def test_procs_allreduce_sound_and_faults():
    """One world for the sound run through `run_cell`, one for every
    fault in turn (the transport's patch last)."""
    cell = _procs()
    run = H.run_cell(cell, SEED, SECONDS, True, "cpu")
    assert run.correct, run.checks
    assert run.device_count == 2 and run.attempted > 0
    assert run.trace is not None and "staged_ms" in run.trace.counters
    drv = H.load_module("drivers/procs_allreduce.py")
    faults = ["procs_unchanged", "procs_half", "procs_altered",
              "procs_no_exchange"]
    from repro_torch.launch import procs
    with tempfile.TemporaryDirectory() as tmp:
        specs = []
        for f in faults:
            out = pathlib.Path(tmp, f)
            out.mkdir()
            specs.append(drv.child_spec(cell, SEED, SECONDS, False, "cpu",
                                        str(out), f"fault_cases:{f}"))
        procs.spawn(H.child_entry, 2, backend="gloo", device="cpu",
                    args=("fault_cases.py", "procs_variants", specs))
        for f, spec in zip(faults, specs):
            bad = drv.collect(cell, spec["out"], False, 0.0)
            assert not bad.correct, (f, bad.checks)


def test_procs_control_fails():
    drv = H.load_module("drivers/procs_allreduce.py")
    cell, program = drv.control(_procs())
    assert cell.workload["driver"] == "stacked_allreduce"
    run = H.run_cell(cell, SEED, SECONDS, False, "cpu", program=program)
    assert not run.correct, run.checks
    assert json.dumps(run.checks)
