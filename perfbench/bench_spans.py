"""The program's own spans in a traced run, and the arithmetic on them.

While torch.profiler records, `repro_torch` records wall-clock spans and
counters of its own (`repro_torch.core.telemetry.WALL`): a root span a
call (`engine.<collective>`) or a served batch (`dlrm.serve`), with the
control plane (`engine.resolve`, `engine.compile`), the data plane
(`execute_program`, `exchange`) and the model's steps (`dlrm.*`) nested
under it by parent id. Each span holds the change of the recorder's
counters over it, among them the kernel entry points' ns
(`kernel.entry_ns`). They are stamped with `time.time_ns()`, the clock of
the traced stretch's `t0_ns` / `t1_ns` and of the device's events.

`spans(run)` takes those that start and end inside the traced stretch
and gives each its self time: its duration less its children's and less
the kernel-entry ns charged to it and not to a child. Where the program
records no span (a tree without the recorder, an untraced run) every
function here returns None.

    python3 perfbench/bench_spans.py --workload <cell> --seed <n> --seconds <s>

runs the cell once with `--trace 1` on the card and prints the split of
a traced call (`split`) as one JSON line.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Optional

from bench_trace import group_of

CONTROL = ("engine.resolve", "engine.compile")
DATA_PLANE = ("execute_program", "exchange")
ENTRY_NS = "kernel.entry_ns"
ENTRIES = "kernel.entries"
KERNEL_GROUPS = ("K1 ", "K2 ", "K3 ", "K4 ", "K5 ")   # bench_trace.GROUPS


@dataclasses.dataclass
class Span:
    name: str
    start: int                 # ns, time.time_ns()
    end: int
    id: int
    parent: Optional[int]      # None: a root, or its parent lies outside
    call: int
    counters: dict             # the counters' change over the span
    args: dict
    depth: int = 0
    self_ns: int = 0           # duration less children and own entry ns
    entry_ns: int = 0          # kernel-entry ns charged to it alone

    @property
    def dur(self) -> int:
        return self.end - self.start


def recorder():
    """The program's wall-clock recorder, or None where the program has
    none."""
    try:
        from repro_torch.core import telemetry
    except ImportError:
        return None
    return getattr(telemetry, "WALL", None)


def spans(run) -> Optional[list]:
    """The program's spans inside the traced stretch of `run`, oldest
    first, with depth, self time and own entry ns; None where there are
    none."""
    t = run.trace
    rec = recorder()
    if t is None or rec is None or not t.calls:
        return None
    return from_events(rec.spans(t.t0_ns, t.t1_ns))


def from_events(events) -> Optional[list]:
    """`Span`s from the recorder's span events (`WallTracer.spans`)."""
    out = [Span(e["name"], e["ts"], e["ts"] + e["dur"], e["id"],
                e["parent"], e["call"], dict(e.get("counters") or {}),
                dict(e.get("args") or {})) for e in events]
    if not out:
        return None
    out.sort(key=lambda s: (s.start, -s.end))
    by_id = {s.id: s for s in out}
    child_ns: dict = {}
    child_entry: dict = {}
    for s in out:
        if s.parent not in by_id:
            s.parent = None
            continue
        child_ns[s.parent] = child_ns.get(s.parent, 0) + s.dur
        child_entry[s.parent] = child_entry.get(s.parent, 0) + \
            s.counters.get(ENTRY_NS, 0)
    for s in out:
        s.depth = sum(1 for _a in _ancestors(s, by_id))
        s.entry_ns = s.counters.get(ENTRY_NS, 0) - child_entry.get(s.id, 0)
        s.self_ns = s.dur - child_ns.get(s.id, 0) - s.entry_ns
    return out


def _ancestors(s: Span, by_id: dict):
    while s.parent is not None:
        s = by_id[s.parent]
        yield s


def per_call_ms(run, ns: float) -> float:
    return ns / run.trace.calls / 1e6


def control_ns(sp: list) -> int:
    """Whole durations of the control plane's spans, nested spans
    included (a control span inside another counted once)."""
    by_id = {s.id: s for s in sp}
    return sum(s.dur for s in sp if s.name in CONTROL and not any(
        a.name in CONTROL for a in _ancestors(s, by_id)))


def dataplane_ns(sp: list) -> int:
    """Self time of the data plane's spans, less kernel-entry ns."""
    return sum(s.self_ns for s in sp if s.name in DATA_PLANE)


def entry_ns(sp: list) -> int:
    """Kernel entry points' ns under the root spans."""
    return sum(s.counters.get(ENTRY_NS, 0) for s in sp if s.parent is None)


def model_ns(sp: list) -> int:
    """Self time of the model's spans (`dlrm.*`) outside every engine
    span, less kernel-entry ns."""
    by_id = {s.id: s for s in sp}
    return sum(s.self_ns for s in sp if s.name.startswith("dlrm.")
               and not any(a.name.startswith("engine.")
                           for a in _ancestors(s, by_id)))


def api_ns(sp: list) -> int:
    """Self time of the engine's API spans (`engine.<collective>`), less
    kernel-entry ns."""
    return sum(s.self_ns for s in sp
               if s.name.startswith("engine.") and s.name not in CONTROL)


def innermost(sp: list):
    """A function from a time (ns) to the innermost span holding it, or
    None: the last span started at or before it, or the nearest of its
    ancestors that still holds it (spans nest)."""
    starts = [s.start for s in sp]
    by_id = {s.id: s for s in sp}

    def at(t: int):
        i = bisect.bisect_right(starts, t) - 1
        if i < 0:
            return None
        s = sp[i]
        while s is not None and s.end < t:
            s = by_id.get(s.parent) if s.parent is not None else None
        return s

    return at


def idle_gaps(trace) -> list:
    """The device's idle gaps of the traced stretch, (start, end) ns, as
    `bench_trace.breakdown` takes them."""
    iv = trace.intervals()
    edges = [trace.t0_ns] + [x for ab in iv for x in ab] + [trace.t1_ns]
    return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]


def idle_by_span(run) -> Optional[dict]:
    """Device-idle ns of the traced stretch by the innermost program span
    holding each gap's midpoint ('none' where none does); None where the
    program recorded no span or the clocks disagree."""
    t = run.trace
    sp = spans(run)
    if sp is None or not t.aligned:
        return None
    at = innermost(sp)
    out: dict = {}
    for a, b in idle_gaps(t):
        s = at((a + b) // 2)
        name = s.name if s is not None else "none"
        out[name] = out.get(name, 0) + b - a
    return out


def split(run) -> Optional[dict]:
    """A traced call's time by part, ms a call: the engine's API self
    time, the control plane, the data plane, the kernel entry points, the
    model, the harness's own spans less the program's spans inside them,
    and what no span holds; the program's
    counters a call; kernel entries against the device's operations and
    the K1-K5 launches among them; and
    the share of device operations inside the program's spans +- 1 ms."""
    t = run.trace
    sp = spans(run)
    if sp is None:
        return None
    ms = lambda ns: per_call_ms(run, ns)  # noqa: E731
    roots = [(s.start, s.end) for s in sp if s.parent is None]
    harness: dict = {}
    for name, a, b in t.spans:       # less the program's spans inside
        inner = sum(max(0, min(b, e) - max(a, s)) for s, e in roots)
        harness[name] = harness.get(name, 0) + b - a - inner
    parts = {"api": ms(api_ns(sp)), "control": ms(control_ns(sp)),
             "dataplane": ms(dataplane_ns(sp)), "launch": ms(entry_ns(sp)),
             "model": ms(model_ns(sp))}
    parts.update({f"harness:{k}": ms(v) for k, v in harness.items()})
    call = t.window_s * 1e3 / t.calls
    counters: dict = {}
    for s in sp:
        if s.parent is None:
            for k, v in s.counters.items():
                counters[k] = counters.get(k, 0) + v
    names: dict = {}
    for s in sp:
        names[s.name] = names.get(s.name, 0) + 1
    lo, hi = min(s.start for s in sp), max(s.end for s in sp)
    inside = sum(1 for _n, s, _d in t.ops if lo - 1e6 <= s <= hi + 1e6)
    idle = idle_by_span(run)
    return {"call_ms": call, "parts_ms": parts,
            "parts_sum_ms": sum(parts.values()),
            "unspanned_ms": call - sum(parts.values()),
            "counters_per_call": {k: v / t.calls for k, v in
                                  sorted(counters.items())},
            "spans_per_call": {k: v / t.calls for k, v in
                               sorted(names.items())},
            "device_ops_per_call": len(t.ops) / t.calls,
            "kernel_ops_per_call": sum(
                1 for n, _s, _d in t.ops
                if group_of(n).startswith(KERNEL_GROUPS)) / t.calls,
            "ops_inside_spans": inside / len(t.ops) if t.ops else None,
            "idle_ms_by_span": None if idle is None else
            {k: ms(v) for k, v in sorted(idle.items(), key=lambda kv:
                                         -kv[1])},
            "spans": len(sp), "dropped": recorder().dropped}


def main(argv=None) -> int:
    import argparse
    import json
    import os
    import pathlib
    import sys
    here = pathlib.Path(__file__).resolve().parent
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    build = here.parent / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "kernels")
    sys.path[:0] = [str(here), str(here.parent / "src")]
    import bench_harness as H
    H.steady_host(0)
    cell = H.load_cell(args.workload)
    run = H.run_cell(cell, args.seed, args.seconds, True, "cuda")
    out = {"workload": args.workload, "correct": run.correct,
           "split": split(run)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
