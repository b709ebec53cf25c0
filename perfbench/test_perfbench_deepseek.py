"""The DeepSeek-V3 cell's driver end to end on the CPU at a tiny size (the
port's plain kernels, float32), against the plain reference: a sound run
is `correct` and reports the cell's metrics; the control (the reference
with its products' operands rounded through fp8) and the timed path
broken in each way it can be are not; `dsv3_counts` against a count
from the served weights; `launches`' pairing of device operations with
their launches and MLA's device time read from it; the new metrics go to the new cell alone, and
their readers find nothing where the program records no span.
"""
import pathlib
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import bench_harness as H  # noqa: E402
import bench_spans  # noqa: E402
import dsv3_counts  # noqa: E402

SEED = 2**31 + 4343           # larger than 32 signed bits hold
SECONDS = 0.3
CELL = "deepseek-v3-prefill-16k"
NEW = ("dsv3_mfu", "mla_ms.dsv3", "moe_ms.dsv3", "moe_slot_ratio.dsv3",
       "a2a_ms.dsv3", "inplace_share.dsv3", "device_idle.dsv3")
# read from the device's operations, which a CPU run has none of
DEVICE = {"mla_ms.dsv3", "device_idle.dsv3"}


def _cell():
    cell = H.load_cell(CELL)
    cell.config = dict(
        cell.config, hidden_size=64, intermediate_size=96,
        moe_intermediate_size=32, num_attention_heads=4,
        num_key_value_heads=4, q_lora_rank=32, kv_lora_rank=16,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=12,
        n_routed_experts=4, router_experts=16, n_group=4, topk_group=2,
        num_experts_per_tok=4, vocab_size=256, num_hidden_layers=4,
        first_k_dense_replace=1, dtype="float32",
        mesh={"pod": 1, "data": 1, "model": 2})
    # the cell's limits are set for bfloat16 at the published widths; at
    # d 64 in float32 the program reads at most ~4e-6 of the reference's
    # rms (`tests/test_torch_deepseek_v3.py`) and no near-tie differs, so
    # the tiny run is held to float32's own limits, which each fault has
    # to exceed
    cell.workload = dict(cell.workload, params=dict(
        cell.params, prompt_tokens=32, pool=2, warmup_prompts=1,
        trace_calls=2), limits=dict(cell.limits, logit_gap=1e-3,
                                    cache_gap=1e-3, cache_rms_gap=1e-3,
                                    near_tie_share=0.0,
                                    swap_gap=0.0))
    return cell


@pytest.mark.parametrize("trace", [False, True])
def test_deepseek_sound(trace):
    cell = _cell()
    run = H.run_cell(cell, SEED, SECONDS, trace, "cpu")
    assert run.correct, run.checks
    assert run.attempted == len(run.done) > 0
    assert run.checks["moe_dropped"][0] == 0
    line = H.result_line(run, cell, H.benchmark(), trace)
    if trace:
        assert set(line["metrics"]) == set(NEW) - DEVICE
        assert line["metrics"]["moe_slot_ratio.dsv3"]["value"] >= 1.0
        assert line["metrics"]["inplace_share.dsv3"]["value"] > 0
        s = bench_spans.split(run)
        assert s["spans_per_call"]["lm.layer"] == 4
        for name in ("mla.mixer", "mla.q", "mla.kv", "mla.core", "mla.out"):
            assert s["spans_per_call"][name] == 4
        c = s["counters_per_call"]
        assert c["moe.assignments"] == 3 * 32 * 4
        assert 0 < c["moe.absent"] < c["moe.assignments"]
        # each layer's latent pair, fp32, on each of the 2 stacked ranks
        assert c["mla.cache_bytes"] == 4 * 2 * 32 * (16 + 8) * 4
    else:
        # the p95 needs two calls, which a loaded host may not finish in
        # the short window
        assert {"qps", "setup_s"} <= set(line["metrics"]) <= {
            "qps", "batch_p95_ms", "setup_s"}


@pytest.mark.parametrize("program", [
    "deepseek_faults:control", "deepseek_faults:no_mscale",
    "deepseek_faults:bias_in_gates", "deepseek_faults:no_yarn",
    "deepseek_faults:no_alltoall", "deepseek_faults:wrong_share",
    "deepseek_faults:drops", "deepseek_faults:latent_dropped"])
def test_deepseek_faults_fail(program):
    run = H.run_cell(_cell(), SEED, SECONDS, False, "cpu", program=program)
    assert not run.correct, run.checks


def test_deepseek_control_named_by_the_driver():
    drv = H.load_module("drivers/deepseek_prefill.py")
    _cell_, program = drv.control(_cell())
    assert program == "deepseek_faults:control"


def test_counts_match_the_served_weights():
    """`dsv3_counts.prefill_flops` against a count made from the served
    weights' sizes: 2 S per weight of MLA and of the dense and shared
    SwiGLUs, the router's, the held experts' at the share of assignments
    uniform routing sends here, the core at its causal half, the head at
    the last position."""
    cell = _cell()
    cfg, s = cell.config, 32
    drv = H.load_module("drivers/deepseek_prefill.py")
    prog = drv.Program(cfg, dict(cell.params, prompt_tokens=s), SEED, "cpu")
    numel = {}
    for i in range(cfg["num_hidden_layers"]):
        for part, tree in prog.layer_of(i).items():
            if isinstance(tree, dict):
                for n, t in tree.items():
                    numel[(i, part, n)] = t.numel()
    want = 0
    for (i, part, n), k in numel.items():
        if "norm" in n or n == "router_bias":
            continue
        if part == "moe" and n != "router":
            # the held experts' weights, each taking top-k / width of
            # the tokens under uniform routing
            k = k * cfg["num_experts_per_tok"] / cfg["router_experts"]
        want += 2 * s * k
    pairs = s * (s + 1) // 2
    want += cfg["num_hidden_layers"] * 2 * pairs * 4 * ((16 + 8) + 12)
    want += 2 * cfg["hidden_size"] * cfg["vocab_size"]
    assert dsv3_counts.prefill_flops(cfg, s) == pytest.approx(want,
                                                               rel=1e-12)
    # at the cell's own size: 1.76e14 a prompt (MLA's core 44%)
    full = H.load_cell(CELL).config
    assert dsv3_counts.prefill_flops(full, 16384) == pytest.approx(
        1.7641e14, rel=1e-4)


def test_new_metrics_go_to_the_new_cell_alone():
    bench = H.benchmark()
    for wl in bench["workloads"]:
        _e2e, layer = H.cell_metrics(wl["name"], bench)
        got = {m["name"] for m in layer} & set(NEW)
        assert got == (set(NEW) if wl["name"] == CELL else set()), wl
    e2e, _layer = H.cell_metrics(CELL, bench)
    assert {m["name"] for m in e2e} == {"qps", "batch_p95_ms", "setup_s"}


def test_new_readers_find_nothing_without_spans(monkeypatch):
    cell = _cell()
    run = H.Run(setup_s=1.0, window_s=1.0, done=[], attempted=0, failed=0,
                checks={}, memory_peak_bytes=0, device_kind="cpu",
                device_count=1, config=cell.config, params=cell.params)
    for name in NEW:
        assert H.reader(name)(run) is None
    monkeypatch.setattr(bench_spans, "recorder", lambda: None)
    run.done = [(1.0, 1)]
    assert H.reader("mla_ms.dsv3")(run) is None
    assert H.reader("moe_ms.dsv3")(run) is None


class _Event:
    def __init__(self, name, device, corr, start, dur):
        self._v = (name, device, corr, start, dur)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def correlation_id(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4]


def test_launch_times_pair_operations_with_their_calls():
    import launches
    import torch
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [_Event("cudaLaunchKernel", cpu, 7, 100, 5),
              _Event("Activity Buffer Request", cpu, 0, 90, 1),
              _Event("gemm", cuda, 7, 400, 50),
              _Event("copy", cuda, 9, 460, 10),
              _Event("cuLaunchKernel", cpu, 9, 120, 4)]
    assert launches.launch_times(events) == [("gemm", 400, 50, 100),
                                             ("copy", 460, 10, 120)]
    assert launches.launch_times([_Event("k", cuda, 3, 1, 1)]) == [
        ("k", 1, 1, None)]


def _traced_run(launch_ns):
    import bench_trace
    t = bench_trace.Trace(window_s=1.0, calls=2, items=2, t0_ns=0,
                          t1_ns=10_000, ops=[
                              ("core", 2000, 1_000_000),
                              ("proj", 2100, 500_000),
                              ("expert", 2200, 250_000),
                              ("lost", 2300, 125_000)][:len(launch_ns)],
                          spans=[])
    t.launch_ns = launch_ns
    return H.Run(setup_s=1.0, window_s=1.0, done=[(1.0, 1)], attempted=2,
                 failed=0, checks={}, memory_peak_bytes=0,
                 device_kind="cpu", device_count=1, trace=t)


def test_mla_device_time_reads_operations_launched_in_its_spans(
        monkeypatch):
    """Operations launched inside the outermost `mla.*` spans count,
    whenever they ran; one launched outside them, or unmatched, does
    not; nested spans count once."""
    events = [
        {"name": "mla.mixer", "ts": 100, "dur": 400, "id": 1,
         "parent": None, "call": 0},
        {"name": "mla.core", "ts": 150, "dur": 100, "id": 2, "parent": 1,
         "call": 0},
        {"name": "moe.route", "ts": 600, "dur": 100, "id": 3,
         "parent": None, "call": 0}]

    class Rec:
        def spans(self, t0, t1):
            return events
    monkeypatch.setattr(bench_spans, "recorder", lambda: Rec())
    reader = H.reader("mla_ms.dsv3")
    # core launched in mla.core, proj in mla.mixer, expert in moe.route,
    # the last with no launch found: (1 + 0.5) ms over 2 calls
    run = _traced_run([160, 450, 650, None])
    assert reader(run) == pytest.approx(0.75)
    assert reader(_traced_run([])) is None
    run.trace.launch_ns = None
    assert reader(run) is None
    events[:] = events[2:]
    assert reader(_traced_run([160, 450, 650, None])) is None
