"""The benchmark's harness: finds a cell's files by name, runs its driver,
reads its metrics and prints the result line.

Everything that belongs to one cell, configuration, driver kind or
metric sits in a file of its own, found by the name `BENCHMARK.json`
gives it:

  perfbench/workloads/<cell>.json   config, traffic, chips, driver, params,
                                    limits of the numbers compared
  perfbench/configs/<config>.json   the sizes as run (`file` in BENCHMARK.json)
  perfbench/drivers/<driver>.py     `run(cell, seed, seconds, trace, device,
                                    t0, program=None) -> Run`
  perfbench/metrics/<metric>.py     `read(run) -> float | None`; a metric
                                    split by cells (`<base>.<cells>`)
                                    without a file of its own is read by
                                    perfbench/metrics/<base>.py

A driver runs the program for the window, keeps the answers it will
check, frees the program and compares those answers with the plain
reference (`perfbench/reference/`). A metric's reader returns None where
it finds nothing to read, and the metric is then left out of the line.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import pathlib
import sys
import time
from typing import Optional

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names the process may not hold once the window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict          # perfbench/workloads/<name>.json
    config: dict            # the configuration's file

    @property
    def params(self) -> dict:
        return self.workload["params"]

    @property
    def limits(self) -> dict:
        return self.workload["limits"]


@dataclasses.dataclass
class Run:
    """What a driver measured. `done`: one (latency_s or None, items) per
    completed call of the window; `checks`: each number compared,
    (value, limit)."""

    setup_s: float
    window_s: float
    done: list
    attempted: int
    failed: int
    checks: dict
    memory_peak_bytes: int
    device_kind: str
    device_count: int
    config: dict = dataclasses.field(default_factory=dict)
    params: dict = dataclasses.field(default_factory=dict)
    trace: Optional[object] = None        # bench_trace.Trace
    setup_split: dict = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            v is not None and math.isfinite(v) and v <= lim
            for v, lim in self.checks.values()) and self.failed == 0


class Marks:
    """Where set-up's seconds go: `mark(name)` books the time since the
    last mark (the first since `t0`, the process's start) to `name`."""

    def __init__(self, t0: float):
        self.last = t0
        self.split: dict = {}

    def mark(self, name: str) -> None:
        now = time.time()
        self.split[name] = self.split.get(name, 0.0) + now - self.last
        self.last = now


def card_ready(device, marks: Marks) -> None:
    """Make the card's context and load the kernel library now, so that
    set-up's split shows them apart (the program would at its first
    tensor and its first launch)."""
    import torch
    marks.mark("start and imports")
    if torch.device(device).type != "cuda":
        return
    torch.empty(1, device=device)
    marks.mark("cuda context")
    from repro_torch.kernels import _build
    _build.library()
    marks.mark("kernel library")


def benchmark(root=ROOT) -> dict:
    return json.loads((pathlib.Path(root) / "BENCHMARK.json").read_text())


def load_module(relpath: str):
    """A module of perfbench/ by its path (metric names hold dots, so they
    are no module names), cached under a name of its own."""
    path = HERE / relpath
    name = "perfbench_" + relpath.replace("/", "__").replace(".", "_")
    mod = sys.modules.get(name)
    if mod is None:
        if not path.is_file():
            raise FileNotFoundError(f"perfbench: no file {relpath}")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or benchmark()
    wl = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    files = {c["name"]: c["file"] for c in bench["configs"]}
    path = files.get(wl["config"], f"perfbench/configs/{wl['config']}.json")
    cfg = json.loads((ROOT / path).read_text())
    return Cell(name=name, workload=wl, config=cfg)


def card_slot(index: int) -> Optional[tuple]:
    """(the card's place among the host's cards, their number) for the
    process's CUDA device `index`, or None where it is not known. Where
    CUDA_VISIBLE_DEVICES hides cards, nvidia-smi, which sees every card,
    places it by its UUID."""
    import os
    import subprocess
    import torch
    if os.environ.get("CUDA_VISIBLE_DEVICES") is None:
        return index, torch.cuda.device_count()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=uuid", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    uuids = [u.strip().removeprefix("GPU-") for u in out.split()]
    mine = str(torch.cuda.get_device_properties(index).uuid)
    hits = [k for k, u in enumerate(uuids) if u == mine.removeprefix("GPU-")]
    return (hits[0], len(uuids)) if len(hits) == 1 else None


def host_core(slot: Optional[tuple], cpus: list) -> Optional[int]:
    """The core that a run on the card at `slot` keeps to: the middle one
    of the card's share of `cpus` (the k-th of n equal shares), so that
    runs on different cards of one host keep to different cores."""
    if slot is None or len(cpus) < 2:
        return None
    k, n = slot
    share = cpus[k * len(cpus) // n:(k + 1) * len(cpus) // n]
    return share[(len(share) - 1) // 2] if share else cpus[k % len(cpus)]


def steady_host(index: int) -> str:
    """The host's side of a run on CUDA device `index` keeps to one core
    of its card's own (`host_core`) and one intra-op thread: the work is
    Python dispatch, and a process kept on one core spreads less from run
    to run (PERF.md §2). Where the card's place is not known, every core
    stays. Returns what was chosen, for standard error."""
    import os
    import torch
    torch.set_num_threads(1)
    slot = card_slot(index)
    core = host_core(slot, sorted(os.sched_getaffinity(0)))
    if core is not None:
        os.sched_setaffinity(0, {core})
    return f"host core {core} (card, cards: {slot})"


def cell_metrics(name: str, bench: dict) -> tuple:
    """The end-to-end and the per-layer metrics a cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}

    def reports(m) -> bool:
        if "workloads" in m:
            return name in m["workloads"]
        return m["moves"] in names

    return e2e, [m for m in bench["per_layer"] if reports(m)]


def forbidden_modules(names) -> list:
    """The modules whose top-level name, the part before the first dot,
    is one of FORBIDDEN, compared whole."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def reader(name: str):
    """The reader of metric `name`: perfbench/metrics/<name>.py, or for a
    quantity split by cells (`<base>.<cells>`) without a file of its own,
    perfbench/metrics/<base>.py."""
    path = f"metrics/{name}.py"
    if not (HERE / path).is_file():
        path = f"metrics/{name.split('.')[0]}.py"
    return load_module(path).read


def read_metrics(run: Run, specs: list) -> dict:
    out = {}
    for m in specs:
        v = reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def closed_loop(step, seconds: float, rec=None, trace_calls: int = 0,
                items: int = 1, counters=None) -> tuple:
    """Call `step(i)` back to back, each call ending with its result
    where the caller waits for it, until `seconds` have passed; the first
    `trace_calls` calls under `rec` (a bench_trace.Recorder). Returns
    (window_s, calls)."""
    i = 0
    if rec is not None and trace_calls:
        rec.start(counters)            # before the clock: CUPTI starts slowly
    t0 = time.perf_counter()
    while True:
        step(i)
        i += 1
        if rec is not None and rec.active and i == trace_calls:
            rec.stop(i, i * items, counters)
        if time.perf_counter() - t0 >= seconds:
            break
    if rec is not None and rec.active:
        rec.stop(i, i * items, counters)
    return time.perf_counter() - t0, i


def sample(seed: int, calls_expected: int, k: int) -> set:
    """k call indices drawn from the seed among the first
    `calls_expected` (90% of those a window is expected to complete), and
    index 0."""
    import random
    rng = random.Random(seed)
    hi = max(1, int(0.9 * calls_expected))
    return {0} | {rng.randrange(hi) for _ in range(k)}


def resolve(program: Optional[str]):
    """A program factory given as 'module:attr' (a module of perfbench/
    by its file name), or None for the driver's own."""
    if program is None:
        return None
    mod, attr = program.split(":")
    return getattr(load_module(f"{mod}.py"), attr)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t0: Optional[float] = None, program: Optional[str] = None) -> Run:
    """One run of `cell` through its driver (no look for a card)."""
    driver = load_module(f"drivers/{cell.workload['driver']}.py")
    run = driver.run(cell, seed, seconds, trace, device,
                     time.time() if t0 is None else t0, program)
    run.config, run.params = cell.config, cell.params
    return run


def child_entry(rank: int, world: int, relpath: str, attr: str,
                spec) -> None:
    """The target of a driver's spawned processes: loads a module of
    perfbench/ by its file (a driver module is no importable name) and
    runs its `attr(rank, world, spec)`."""
    getattr(load_module(relpath), attr)(rank, world, spec)


def result_line(run: Run, cell: Cell, bench: dict, trace: bool) -> dict:
    from bench_trace import breakdown
    import peaks
    e2e, layer = cell_metrics(cell.name, bench)
    device = {"platform": "gpu", "kind": run.device_kind,
              "count": run.device_count,
              "memory_peak_bytes": int(run.memory_peak_bytes),
              "power_limit": peaks.power_limit()}
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed,
           "metrics": read_metrics(run, layer if trace else e2e),
           "device": device}
    if trace and run.trace is not None:
        t = run.trace
        busy = (sum(t.busy_ranks_s) / len(t.busy_ranks_s)
                if t.busy_ranks_s else t.busy_s)
        device["busy_s"] = busy
        device["window_s"] = t.window_s
        out["breakdown"] = breakdown(t)
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in run.checks.items()}
    return out


def main(args, t0: float) -> int:
    import torch
    t_torch = time.time()
    bench = benchmark()
    cell = load_cell(args.workload, bench)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s), "
              f"found {n}", file=sys.stderr)
        return 2
    t_init = time.time()
    # a cell over several processes pins each in its own (its driver)
    host = steady_host(0) if chips == 1 else "host cores: every one"
    run = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   t0)
    bad = forbidden_modules(list(sys.modules))
    if bad:
        print(f"perfbench: the process holds {', '.join(bad)}",
              file=sys.stderr)
        return 3
    line = result_line(run, cell, bench, bool(args.trace))
    # the start before the driver's first mark, split further
    split = {"import torch": t_torch - t0, "CUDA init": t_init - t_torch}
    for k, v in run.setup_split.items():
        split[k] = v - (t_init - t0 if k == "start and imports" else 0.0)
    print(host, file=sys.stderr)
    print("setup split: " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                      split.items()), file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
