"""The benchmark's files, names and arithmetic, on the CPU (no card).

`BENCHMARK.json` against the contract's shapes and limits; every cell,
configuration, driver and metric found by its name; the import check;
the counts against the kernel table's bounds; the trace arithmetic on a
made-up trace.
"""
import ast
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))

import bench_counts  # noqa: E402
import bench_harness as H  # noqa: E402
import peaks  # noqa: E402
from bench_trace import INDEXING, Trace, breakdown, short_name  # noqa: E402

BENCH = H.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _one_line(text) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_benchmark_shape():
    assert set(BENCH) == KEYS
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _one_line(c["source"])
        assert _one_line(c["why"]) and c["file"].startswith("perfbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _one_line(w["why"])
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_names_units(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    else:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _one_line(m["layer"])
    if "roofline" in m["name"] or "mfu" in m["name"]:
        assert m["unit"] == "%"


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    cell = H.load_cell(w["name"], BENCH)
    wl = cell.workload
    assert (wl["config"], wl["traffic"], wl["chips"]) == \
        (w["config"], w["traffic"], w["chips"])
    assert (HERE / "drivers" / f"{wl['driver']}.py").is_file()
    assert cell.config["name"] == w["config"]
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    e2e, layer = H.cell_metrics(w["name"], BENCH)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in e2e + layer:
        assert callable(H.reader(m["name"]))


def test_every_config_used_and_own_file():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_one_reported_metric(m):
    e2e = {x["name"]: x for x in BENCH["end_to_end"]}
    assert m["moves"] in e2e and m["moves"] != "setup_s"
    cells = m.get("workloads", [w["name"] for w in BENCH["workloads"]])
    for cell in cells:
        names = {x["name"] for x in H.cell_metrics(cell, BENCH)[0]}
        assert m["moves"] in names, (m["name"], cell)
    # a layer's name is the one PERF.md's list of layers gives it
    assert m["layer"] in (ROOT / "PERF.md").read_text()


def test_forbidden_modules_compare_whole_top_level_names():
    ok = ["repro_torch", "repro_torch.core.engine", "reproduce", "jaxtyping",
          "flaxen", "torch", "bench_harness"]
    bad = ["repro", "repro.core", "jax", "jax.numpy", "jaxlib.xla_client",
           "flax", "flax.linen"]
    assert H.forbidden_modules(ok) == []
    assert H.forbidden_modules(ok + bad) == sorted(bad)


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_file_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & set(H.FORBIDDEN), path


def test_reference_is_plain_torch():
    for path in (HERE / "reference").glob("*.py"):
        assert _imports(path) <= {"__future__", "torch"}, path


def test_counts_match_the_kernel_table():
    ms = 1e3 / peaks.HBM_BYTES_PER_S
    cfg = json.loads((HERE / "configs" / "dlrm-table2.json").read_text())
    # K1: one launch of the fp32 allreduce combines (8 ranks, 32768)
    assert bench_counts.pairwise_combine_bytes(2, 8 * 32768) * ms == \
        pytest.approx(0.00094, rel=0.01)
    # the whole call: 2 x 8 x 64 MiB read and written once
    assert bench_counts.allreduce_least_bytes(8, 1 << 24) * ms == \
        pytest.approx(0.3205, rel=0.01)
    assert bench_counts.dlrm_flops_per_query(cfg) == 15_467_008
    k4 = bench_counts.fc1_flops(cfg, 2048) * 1e3 / peaks.FP32_FLOPS_PER_S
    assert k4 == pytest.approx(0.401, rel=0.01)
    assert bench_counts.fc1_bytes(cfg, 32, 8) * ms == \
        pytest.approx(0.0086, rel=0.01)
    assert bench_counts.lookup_bytes(cfg, 2048, 8) * ms == \
        pytest.approx(0.0707, rel=0.01)
    assert bench_counts.lookup_bytes(cfg, 32, 8) * ms == \
        pytest.approx(0.0011, rel=0.01)


def _trace(ops, spans=(), calls=2, counters=None):
    return Trace(window_s=1e-6 * 100, calls=calls, items=64 * calls,
                 t0_ns=1000, t1_ns=101_000, ops=list(ops),
                 spans=list(spans), counters=counters or {})


def test_trace_union_groups_and_breakdown():
    ops = [("void repro_torch::fused_combine_kernel_at<float>(a)", 11_000,
            20_000),
           ("void at::native::index_elementwise_kernel<4>(b)", 21_000,
            20_000),
           ("Memcpy DtoD (Device -> Device)", 71_000, 10_000)]
    spans = [("engine.allreduce", 1_000, 60_000),
             ("synchronize", 60_000, 101_000)]
    t = _trace(ops, spans)
    assert t.aligned
    assert t.busy_s == pytest.approx(40e-6)
    assert t.idle_share() == pytest.approx(0.6)
    assert t.group_s(INDEXING) == pytest.approx(20e-6)
    bd = breakdown(t)
    assert dict(bd["idle_gaps"]) == pytest.approx(
        {"engine.allreduce": 40e-6, "synchronize": 20e-6})
    assert bd["device_ops"][0][0] == \
        "void repro_torch::fused_combine_kernel_at<float>"
    # clocks that disagree: nothing is clipped or named
    far = _trace([(n, s + 10**12, d) for n, s, d in ops], spans)
    assert not far.aligned and far.busy_s == pytest.approx(40e-6)
    assert breakdown(far)["idle_gaps"][0][0] == "clocks not aligned"
    assert short_name("Memcpy HtoD (Pinned -> Device)") == \
        "Memcpy HtoD (Pinned -> Device)"


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_readers_on_an_empty_trace(m):
    cell = H.load_cell(m["workloads"][0], BENCH)
    run = H.Run(setup_s=1.0, window_s=1.0, done=[(None, 1)], attempted=1,
                failed=0, checks={}, memory_peak_bytes=0, device_kind="cpu",
                device_count=1, config=cell.config, params=cell.params,
                trace=_trace([], calls=1))
    reader = H.reader(m["name"])
    for trace in (run.trace, None):
        run.trace = trace
        if m["source"] == "host_clock":      # the whole window
            assert reader(run) > 0
        else:
            assert reader(run) is None


def test_rooflines_stay_below_a_full_card():
    """A trace whose kernels ran exactly at the bound reads 100%."""
    cell = H.load_cell("dlrm-table2-b2048", BENCH)
    cfg, B = cell.config, cell.params["batch"]
    k4 = max(bench_counts.fc1_bytes(cfg, B, 8) / peaks.HBM_BYTES_PER_S,
             bench_counts.fc1_flops(cfg, B) / peaks.FP32_FLOPS_PER_S)
    k5 = bench_counts.lookup_bytes(cfg, B, 8) / peaks.HBM_BYTES_PER_S
    ops = [("matmul_tiled_kernel", 0, round(k4 * 1e9)),
           ("k5_rows_kernel", 0, round(k5 * 1e9))]
    run = H.Run(setup_s=1.0, window_s=1.0, done=[], attempted=0, failed=0,
                checks={}, memory_peak_bytes=0, device_kind="cpu",
                device_count=1, config=cfg, params=cell.params,
                trace=_trace(ops, calls=1))
    for name in ("k4_roofline.dlrm", "k5_roofline.dlrm"):
        v = H.load_module(f"metrics/{name}.py").read(run)
        assert v == pytest.approx(100.0, rel=1e-4)   # durations in whole ns


def test_run_without_a_card_prints_no_result(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: run.py would run the cell")
    out = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         BENCH["workloads"][0]["name"], "--seed", str(2**31 + 7),
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "{" not in out.stdout


def test_bare_benchmark_cannot_run(tmp_path):
    """A directory with BENCHMARK.json and perfbench/ alone has no
    program: the driver cannot import it."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[:0] = ['perfbench', 'src']\n"
            "import bench_harness as H\n"
            "c = H.load_cell('allreduce-fp32-64mib')\n"
            "H.run_cell(c, 1, 0.1, False, 'cpu')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode != 0
    assert "No module named 'repro_torch'" in out.stderr


def test_stacked_tables_are_the_ports_layout():
    """The DLRM driver hands the tables, drawn by shard, as a view: it is
    the port's own stacked layout of the global tables."""
    import torch
    from repro_torch.convert import stack_global
    mesh = {"pod": 1, "data": 1, "model": 4}
    g = torch.arange(3 * 8 * 2, dtype=torch.float32).reshape(3, 8, 2)
    shards = g.reshape(3, 4, 2, 2).transpose(0, 1).contiguous()
    assert math.prod(mesh.values()) == 4
    view = shards.view((1, 1, 4) + tuple(shards.shape[1:]))
    assert torch.equal(view, stack_global(g, mesh, (None, "model", None)))


def test_every_metric_file_has_a_reader():
    """Every file of metrics/ loads and has a reader, also one that no
    cell of BENCHMARK.json reports yet."""
    for path in sorted((HERE / "metrics").glob("*.py")):
        assert callable(H.load_module(f"metrics/{path.name}").read), path


def test_split_metrics_share_a_reader():
    """A quantity split by cells without a file of its own is read by the
    file of its base name; one with a file of its own by that file."""
    idle = H.load_module("metrics/device_idle.py").read
    for name in ("device_idle.coll", "device_idle.dlrm", "device_idle.procs"):
        assert H.reader(name) is idle
    assert H.reader("k1_roofline.coll") is \
        H.load_module("metrics/k1_roofline.coll.py").read
    with pytest.raises(FileNotFoundError):
        H.reader("no_such_metric.coll")


def test_host_core_one_per_card():
    """One card: the middle core, as a one-card machine gives it; cards of
    one host: a core each, in the card's own share."""
    cpus = list(range(8))
    assert H.host_core((0, 1), cpus) == 3
    assert H.host_core(None, cpus) is None
    assert H.host_core((0, 1), [5]) is None
    cpus = list(range(32))
    cores = [H.host_core((k, 4), cpus) for k in range(4)]
    assert cores == [3, 11, 19, 27]
    assert len({H.host_core((k, 8), list(range(4))) for k in range(8)}) == 4
