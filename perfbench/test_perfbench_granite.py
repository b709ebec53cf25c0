"""The Granite cell's driver end to end on the CPU at a tiny size (the
port's plain kernels, float32), against the plain reference: a sound run
is `correct` and reports the cell's metrics; the control (the reference
with its products' operands rounded through fp8) and the timed path
broken in each way it can be are not; the new readers find nothing on an
empty trace or where the program records no span.
"""
import pathlib
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import bench_harness as H  # noqa: E402
import bench_spans  # noqa: E402
import lm_spans  # noqa: E402

SEED = 2**31 + 4242           # larger than 32 signed bits hold
SECONDS = 0.3
CELL = "granite-h-small-prefill-16k"
NEW = ("granite_mfu", "moe_ms.granite", "ssm_ms.granite", "a2a_ms.granite",
       "moe_slot_ratio.granite")


def _cell():
    cell = H.load_cell(CELL)
    cell.config = dict(
        cell.config, hidden_size=64, mamba_n_heads=8, mamba_d_head=16,
        mamba_d_state=16, mamba_chunk_size=16, num_attention_heads=4,
        num_key_value_heads=2, num_local_experts=8, num_experts_per_tok=2,
        intermediate_size=32, shared_intermediate_size=64, vocab_size=256,
        num_hidden_layers=4,
        layer_types=["mamba", "mamba", "attention", "mamba"],
        attention_multiplier=0.05, dtype="float32",
        mesh={"pod": 1, "data": 1, "model": 2})
    # the cell's limits are set for bfloat16 at the published widths; at
    # d 64 in float32 the program reads at most 4e-5 of the reference's
    # rms (`tests/test_torch_granite.py`), so the tiny run is held to
    # float32's own limits, which each fault has to exceed
    cell.workload = dict(cell.workload, params=dict(
        cell.params, prompt_tokens=32, pool=2, warmup_prompts=1,
        trace_calls=2), limits=dict(cell.limits, logit_gap=1e-3,
                                    cache_gap=1e-2))
    return cell


@pytest.mark.parametrize("trace", [False, True])
def test_granite_sound(trace):
    cell = _cell()
    run = H.run_cell(cell, SEED, SECONDS, trace, "cpu")
    assert run.correct, run.checks
    assert run.attempted == len(run.done) > 0
    assert run.checks["moe_dropped"][0] == 0
    line = H.result_line(run, cell, H.benchmark(), trace)
    if trace:
        assert set(NEW) <= set(line["metrics"])
        # one dispatch row at least for each routed assignment
        assert line["metrics"]["moe_slot_ratio.granite"]["value"] >= 1.0
        s = bench_spans.split(run)
        assert s["spans_per_call"]["lm.layer"] == 4
        assert s["counters_per_call"]["moe.assignments"] == 4 * 32 * 2
    else:
        assert {"qps", "setup_s"} <= set(line["metrics"])


@pytest.mark.parametrize("program", [
    "granite_faults:control", "granite_faults:no_alltoall",
    "granite_faults:no_shared", "granite_faults:state_dropped",
    "granite_faults:expert_altered", "granite_faults:drops"])
def test_granite_faults_fail(program):
    run = H.run_cell(_cell(), SEED, SECONDS, False, "cpu", program=program)
    assert not run.correct, run.checks


def test_granite_control_named_by_the_driver():
    drv = H.load_module("drivers/granite_prefill.py")
    cell, program = drv.control(_cell())
    assert program == "granite_faults:control"


def test_new_readers_find_nothing_without_spans(monkeypatch):
    cell = _cell()
    run = H.Run(setup_s=1.0, window_s=1.0, done=[], attempted=0, failed=0,
                checks={}, memory_peak_bytes=0, device_kind="cpu",
                device_count=1, config=cell.config, params=cell.params)
    for name in NEW:
        assert H.reader(name)(run) is None
    monkeypatch.setattr(bench_spans, "recorder", lambda: None)
    for fn in (lm_spans.moe_ms, lm_spans.ssm_ms, lm_spans.a2a_ms,
               lm_spans.slot_ratio):
        assert fn(run) is None
