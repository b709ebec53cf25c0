"""Unified telemetry: the virtual-clock tracer and the metrics registry.

This repo prices everything it executes — `Program.cost_terms`,
`Sequencer.makespan`, `MeshMakespan` over `FabricOccupancy` — but until
this module it surfaced almost none of it: control-plane counters lived
in four ad-hoc dicts and the priced per-link/per-request schedule was
collapsed to one scalar. Two primitives fix that:

:class:`Tracer`
    Spans + instant events + typed counters on TWO clocks:

    * the **control-plane tick clock** — a deterministic monotone
      counter stamping trace-time work (selector choices, compiles,
      engine drains).  No wall clock is ever consulted, so traces are
      bit-reproducible;
    * the **virtual clock** — priced seconds.  `interval()` records
      per-request and per-link occupancy windows (`simulate_drain`,
      `MeshMakespan.timeline()`), the same numbers the makespan model
      composes.

    `to_chrome_trace()` exports Chrome trace-event JSON (one track per
    queue, one per physical link, retry/fault instants as markers —
    loadable in Perfetto or ui.perfetto.dev); `snapshot()` flattens the
    event stream into a dict for asserts and logs.

:class:`MetricsRegistry`
    Typed counters/gauges plus structured per-step records.  The
    scattered `Selector.stats` / `Sequencer.stats` / `engine.stats`
    dicts are now read-compatible :class:`StatsView` mappings over a
    registry — existing `stats["issued"]` reads keep working, but
    writers go through `inc()`/`set()` (rule LC004 in
    `scripts/lint_conventions.py` flags new direct `.stats[...] =`
    writes).

Zero overhead when off: the process-default tracer is :data:`NULL`,
whose methods are no-ops and whose `span()` returns a shared null
context manager.  Instrumented code guards argument assembly with
`tracer.enabled`.  **Pricing never reads the tracer** — enabling
tracing cannot change a priced or executed bit (regression-gated by
tests/test_telemetry.py and the bench baseline).

Scoping::

    from repro_torch.core import telemetry
    with telemetry.use(telemetry.Tracer()) as tr:
        ...  # everything issued/priced/drained here is recorded
    trace = tr.to_chrome_trace()

This module is stdlib-only and imports nothing from `repro_torch` — every
core module may import it without cycles.
"""
from __future__ import annotations

import contextlib
from collections.abc import Mapping
from typing import Iterator, Optional

__all__ = [
    "Tracer", "NullTracer", "MetricsRegistry", "StatsView",
    "NULL", "current", "use", "axis_label",
]


def axis_label(axis) -> str:
    """Human-readable track label for an axis key (str or tuple)."""
    if isinstance(axis, tuple):
        return "+".join(str(a) for a in axis)
    return str(axis)


# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------

#: pid of the control-plane track group (tick clock: 1 tick == 1 "us").
CONTROL_PID = 1
#: pid of the virtual-clock track group (priced seconds, exported as us).
VIRTUAL_PID = 2


class _NullSpan:
    """Shared no-op span: entering, exiting, and annotating cost nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def add(self, **args) -> None:
        pass


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The process-default tracer: every method is a no-op.

    `enabled` is False so instrumentation can skip argument assembly
    entirely; calling the methods anyway is still safe and free of
    side effects.
    """

    enabled = False

    def span(self, name: str, track: str = "control", **args) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, track: str = "control",
                ts_s: Optional[float] = None, **args) -> None:
        pass

    def counter(self, name: str, value, track: str = "control") -> None:
        pass

    def interval(self, name: str, track: str, start_s: float, end_s: float,
                 **args) -> None:
        pass

    def ingest_timeline(self, timeline: dict) -> None:
        pass


#: The shared disabled tracer (the process default).
NULL = NullTracer()


class _Span:
    """Context manager recording one control-plane span ("X" event)."""

    __slots__ = ("_tracer", "name", "track", "args", "_start")

    def __init__(self, tracer: "Tracer", name: str, track: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.track = track
        self.args = args
        self._start = 0

    def add(self, **args) -> None:
        """Attach more args to the span (e.g. the outcome, post-hoc)."""
        self.args.update(args)

    def __enter__(self) -> "_Span":
        self._start = self._tracer._next_tick()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        end = self._tracer._next_tick()
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        self._tracer._events.append({
            "type": "span", "name": self.name, "track": self.track,
            "pid": CONTROL_PID, "ts": self._start,
            "dur": end - self._start, "args": self.args,
        })
        return False


class Tracer:
    """Recording tracer: spans, instants, counters, virtual intervals.

    All timestamps are deterministic — the control-plane tick counter
    and the priced virtual clock — so two identical runs produce
    identical traces.  See the module docstring for the event model.
    """

    enabled = True

    def __init__(self):
        self._events: list = []
        self._tick = 0
        # (pid, track) -> tid, assigned in first-use order
        self._tids: dict = {}
        self._installed_prev = []  # `with tracer:` scoping stack

    def _next_tick(self) -> int:
        self._tick += 1
        return self._tick

    # -- recording ----------------------------------------------------------
    def span(self, name: str, track: str = "control", **args) -> _Span:
        """Open a control-plane span; use as a context manager.  The
        returned span's `add(**args)` attaches outcome fields before it
        closes.  Spans on one track are well-nested by construction
        (context-manager discipline + a global monotone tick clock)."""
        return _Span(self, name, track, dict(args))

    def instant(self, name: str, track: str = "control",
                ts_s: Optional[float] = None, **args) -> None:
        """A marker: tick-clocked by default, or pinned to the virtual
        clock when `ts_s` (priced seconds) is given."""
        if ts_s is None:
            self._events.append({
                "type": "instant", "name": name, "track": track,
                "pid": CONTROL_PID, "ts": self._next_tick(), "args": args,
            })
        else:
            self._events.append({
                "type": "instant", "name": name, "track": track,
                "pid": VIRTUAL_PID, "ts": float(ts_s), "args": args,
            })

    def counter(self, name: str, value, track: str = "control") -> None:
        """A typed counter sample (Chrome "C" event)."""
        self._events.append({
            "type": "counter", "name": name, "track": track,
            "pid": CONTROL_PID, "ts": self._next_tick(),
            "args": {name: value},
        })

    def interval(self, name: str, track: str, start_s: float, end_s: float,
                 **args) -> None:
        """A virtual-clock occupancy window (priced seconds): one
        request on a queue track, or one program's wire seconds on a
        physical-link track."""
        self._events.append({
            "type": "interval", "name": name, "track": track,
            "pid": VIRTUAL_PID, "ts": float(start_s),
            "dur": float(end_s) - float(start_s), "args": args,
        })

    def ingest_timeline(self, timeline: dict) -> None:
        """Record a `MeshMakespan.timeline()` as virtual-clock intervals:
        per-queue drain windows, chain-placed per-request windows, and
        serialized per-link busy windows (+ the trailing alpha term)."""
        for q in timeline.get("queues", ()):
            self.interval("drain", q["track"], q["start_s"], q["end_s"],
                          axis=axis_label(q["axis"]))
        for r in timeline.get("requests", ()):
            self.interval(r.get("name", "request"), r["track"],
                          r["start_s"], r["end_s"], rids=r["rids"],
                          full_s=r["full_s"], lat_s=r["lat_s"],
                          wire_s=r["wire_s"], coalesced=r["coalesced"])
        for lk in timeline.get("links", ()):
            self.interval(lk.get("name", "wire"), lk["track"],
                          lk["start_s"], lk["end_s"])

    # -- scoping ------------------------------------------------------------
    def __enter__(self) -> "Tracer":
        global _ACTIVE
        self._installed_prev.append(_ACTIVE)
        _ACTIVE = self
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        global _ACTIVE
        _ACTIVE = self._installed_prev.pop()
        return False

    # -- export -------------------------------------------------------------
    def _tid(self, pid: int, track: str) -> int:
        key = (pid, track)
        tid = self._tids.get(key)
        if tid is None:
            tid = len(self._tids) + 1
            self._tids[key] = tid
        return tid

    def to_chrome_trace(self) -> dict:
        """Chrome trace-event JSON (the `{"traceEvents": [...]}` form).

        Control-plane events live under pid 1 (1 tick == 1 us), virtual-
        clock events under pid 2 (1 priced second == 1e6 us).  Each
        track is a named thread; events are sorted by (pid, tid, ts) so
        per-track timestamps are monotone.  Load the file in Perfetto
        (ui.perfetto.dev) or chrome://tracing, or summarize it with
        `scripts/trace_report.py`.
        """
        events = []
        for ev in self._events:
            pid = ev["pid"]
            tid = self._tid(pid, ev["track"])
            ts = float(ev["ts"]) if pid == CONTROL_PID \
                else float(ev["ts"]) * 1e6
            if ev["type"] in ("span", "interval"):
                dur = float(ev["dur"]) if pid == CONTROL_PID \
                    else float(ev["dur"]) * 1e6
                events.append({"ph": "X", "name": ev["name"], "cat": "repro",
                               "pid": pid, "tid": tid, "ts": ts, "dur": dur,
                               "args": ev["args"]})
            elif ev["type"] == "instant":
                events.append({"ph": "i", "name": ev["name"], "cat": "repro",
                               "pid": pid, "tid": tid, "ts": ts, "s": "t",
                               "args": ev["args"]})
            else:  # counter
                events.append({"ph": "C", "name": ev["name"], "cat": "repro",
                               "pid": pid, "tid": tid, "ts": ts,
                               "args": ev["args"]})
        events.sort(key=lambda e: (e["pid"], e["tid"], e["ts"],
                                   -e.get("dur", 0.0)))
        meta = [
            {"ph": "M", "name": "process_name", "pid": CONTROL_PID, "tid": 0,
             "args": {"name": "control-plane (ticks)"}},
            {"ph": "M", "name": "process_name", "pid": VIRTUAL_PID, "tid": 0,
             "args": {"name": "virtual-clock (priced seconds)"}},
        ]
        for (pid, track), tid in sorted(self._tids.items(),
                                        key=lambda kv: kv[1]):
            meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                         "tid": tid, "args": {"name": track}})
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def snapshot(self) -> dict:
        """Flat summary of the event stream: per-name span/interval
        counts and total durations, instant counts, last counter
        values, and the total event count."""
        out: dict = {"events": len(self._events)}
        for ev in self._events:
            if ev["type"] in ("span", "interval"):
                k = f"{ev['type']}.{ev['name']}.count"
                out[k] = out.get(k, 0) + 1
                kd = f"{ev['type']}.{ev['name']}.total"
                out[kd] = out.get(kd, 0.0) + float(ev["dur"])
            elif ev["type"] == "instant":
                k = f"instant.{ev['name']}.count"
                out[k] = out.get(k, 0) + 1
            else:
                out[f"counter.{ev['name']}"] = ev["args"][ev["name"]]
        return out


# ---------------------------------------------------------------------------
# Process-default tracer + scoping
# ---------------------------------------------------------------------------

_ACTIVE = NULL


def current():
    """The tracer instrumentation should record to right now (the
    :data:`NULL` no-op tracer unless a `use()` / `with tracer:` scope is
    active)."""
    return _ACTIVE


@contextlib.contextmanager
def use(tracer):
    """Install `tracer` as the process tracer for the dynamic extent of
    the `with` block (restores the previous one on exit)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = tracer
    try:
        yield tracer
    finally:
        _ACTIVE = prev


# ---------------------------------------------------------------------------
# MetricsRegistry
# ---------------------------------------------------------------------------

class StatsView(Mapping):
    """Live read-compatible mapping over a :class:`MetricsRegistry`.

    Drop-in for the legacy ad-hoc `.stats` dicts: supports `[]`,
    `.get`, iteration, `len`, and equality with plain dicts.  Writing
    through the view delegates to `registry.set` (an out-of-tree
    back-compat shim — in-tree code emits through the registry, and
    LC004 flags new direct `.stats[...] =` writes in src/).
    """

    __slots__ = ("_reg",)

    def __init__(self, registry: "MetricsRegistry"):
        self._reg = registry

    def __getitem__(self, name: str):
        return self._reg._values[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._reg._values)

    def __len__(self) -> int:
        return len(self._reg._values)

    def __setitem__(self, name: str, value) -> None:
        self._reg.set(name, value)

    def __repr__(self) -> str:
        return f"StatsView({dict(self._reg._values)!r})"


class MetricsRegistry:
    """Typed counters/gauges + structured records, behind mapping views.

    `counter(name)` declares a monotone counter (so the key is present,
    at 0, before the first `inc` — tests read counters on fresh
    objects); `set(name, value)` writes a gauge, declaring it on first
    write.  `record(**fields)` appends one structured record (the
    trainer emits one per step).  `view()` returns the live
    :class:`StatsView` components expose as `.stats`.
    """

    __slots__ = ("_values", "_kinds", "_records")

    def __init__(self):
        self._values: dict = {}
        self._kinds: dict = {}
        self._records: list = []

    def __repr__(self) -> str:
        return f"MetricsRegistry({self._values!r})"

    # -- counters / gauges ---------------------------------------------------
    def counter(self, name: str, value=0) -> None:
        """Declare (or reset) a monotone counter."""
        self._kinds[name] = "counter"
        self._values[name] = value

    def inc(self, name: str, delta=1):
        """Increment a counter (declared on first use); returns the new
        value."""
        val = self._values.get(name, 0) + delta
        self._kinds.setdefault(name, "counter")
        self._values[name] = val
        return val

    def set(self, name: str, value) -> None:
        """Write a gauge (declared on first write)."""
        self._kinds.setdefault(name, "gauge")
        self._values[name] = value

    def get(self, name: str, default=None):
        return self._values.get(name, default)

    def discard(self, name: str) -> None:
        """Remove a metric entirely (its key disappears from views)."""
        self._values.pop(name, None)
        self._kinds.pop(name, None)

    # -- structured records --------------------------------------------------
    def record(self, **fields) -> dict:
        """Append one structured record (e.g. a per-step metrics row);
        returns it."""
        rec = dict(fields)
        self._records.append(rec)
        return rec

    def records(self) -> list:
        return list(self._records)

    # -- views ---------------------------------------------------------------
    def snapshot(self) -> dict:
        """A flat copy of every metric value."""
        return dict(self._values)

    def view(self) -> StatsView:
        return StatsView(self)
