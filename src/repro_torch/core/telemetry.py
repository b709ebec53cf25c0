"""Unified telemetry: the tick- and virtual-clock tracer, the wall-clock
recorder and the metrics registry.

This repo prices everything it executes — `Program.cost_terms`,
`Sequencer.makespan`, `MeshMakespan` over `FabricOccupancy` — and, on
the card, spends its time where the host dispatches the work. Three
primitives surface both:

:class:`Tracer`
    Spans + instant events + typed counters on TWO clocks:

    * the **control-plane tick clock** — a deterministic monotone
      counter stamping trace-time work (selector choices, compiles,
      engine drains).  A `Tracer` consults no wall clock, so its traces
      are bit-reproducible;
    * the **virtual clock** — priced seconds.  `interval()` records
      per-request and per-link occupancy windows (`simulate_drain`,
      `MeshMakespan.timeline()`), the same numbers the makespan model
      composes.

    `to_chrome_trace()` exports Chrome trace-event JSON (one track per
    queue, one per physical link, retry/fault instants as markers —
    loadable in Perfetto or ui.perfetto.dev); `snapshot()` flattens the
    event stream into a dict for asserts and logs.

:class:`WallTracer`
    The same recording interface on the **wall clock**: spans and
    instants stamped with `time.time_ns()`, the clock torch.profiler
    stamps its host and device events with, so a span can name the
    device's idle gaps. Each span records its id, its parent's id, the
    id of the call it belongs to (shared by every span under one root
    span: one engine call, one served batch) and the change of the
    recorder's counters over its extent (`count()`, instants by name,
    and the kernel entry points' calls and ns, `entry()`). Events sit
    in a bounded buffer: the oldest are dropped past `cap`, and
    `dropped` counts them. Exported as a third track group.

:class:`MetricsRegistry`
    Typed counters/gauges plus structured per-step records.  The
    scattered `Selector.stats` / `Sequencer.stats` / `engine.stats`
    dicts are now read-compatible :class:`StatsView` mappings over a
    registry — existing `stats["issued"]` reads keep working, but
    writers go through `inc()`/`set()` (rule LC004 in
    `scripts/lint_conventions.py` flags new direct `.stats[...] =`
    writes).

Who records: `current()` returns the tracer a `use(...)` / `with
tracer:` scope installed; else, while a torch profiler session is
active, the process's wall-clock recorder :data:`WALL`; else
:data:`NULL`, whose methods are no-ops and whose `span()` returns a
shared null context manager.  `wall()` is `current()` where it records
on the wall clock and :data:`NULL` otherwise: the spans of the engine,
its data plane and the DLRM server record there alone, so an installed
tick `Tracer` sees exactly the events it always saw.  Hot paths (a
kernel launch, a region-index lookup) read one global, :data:`LIVE` —
the wall-clock recorder while one of its spans is open, else None —
instead of calling `current()`.  Instrumented code guards argument
assembly with `tracer.enabled`.  **Pricing never reads the tracer** —
enabling tracing cannot change a priced or executed bit (regression-
gated by tests/test_telemetry.py, tests/test_torch_telemetry_wall.py
and the bench baseline).

Scoping::

    from repro_torch.core import telemetry
    with telemetry.use(telemetry.Tracer()) as tr:
        ...  # everything issued/priced/drained here is recorded
    trace = tr.to_chrome_trace()

    with torch.profiler.profile(...):
        ...  # engine calls and served batches record to telemetry.WALL
    spans = telemetry.WALL.spans()

This module imports nothing from `repro_torch` — every core module may
import it without cycles — and of torch only the profiler's state.
"""
from __future__ import annotations

import collections
import contextlib
import time
from collections.abc import Mapping
from typing import Iterator, Optional

try:
    from torch._C._autograd import _profiler_enabled as _profiling
except ImportError:          # no torch: no profiler session to follow
    def _profiling() -> bool:
        return False

__all__ = [
    "Tracer", "NullTracer", "WallTracer", "MetricsRegistry", "StatsView",
    "NULL", "WALL", "current", "wall", "use", "axis_label",
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
#: pid of the wall-clock track group (`time.time_ns()`, exported as us).
WALL_PID = 3
#: microseconds of one timestamp unit, by track group
_US_PER_UNIT = {CONTROL_PID: 1.0, VIRTUAL_PID: 1e6, WALL_PID: 1e-3}
_PROCESS_NAMES = {CONTROL_PID: "control-plane (ticks)",
                  VIRTUAL_PID: "virtual-clock (priced seconds)",
                  WALL_PID: "wall clock (time.time_ns)"}


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
    wall = False

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

    def annotate(self, **args) -> None:
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
    wall = False

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
    def events(self) -> list:
        """The recorded events, oldest first, as dicts."""
        return self._events

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
        clock events under pid 2 (1 priced second == 1e6 us), wall-clock
        events (:class:`WallTracer`) under pid 3 (ns since the epoch,
        exported as us; ids, call and counters among the args).  Each
        track is a named thread; events are sorted by (pid, tid, ts) so
        per-track timestamps are monotone.  Load the file in Perfetto
        (ui.perfetto.dev) or chrome://tracing, or summarize it with
        `scripts/trace_report.py`.
        """
        events = []
        for ev in self.events():
            pid = ev["pid"]
            tid = self._tid(pid, ev["track"])
            unit = _US_PER_UNIT[pid]
            ts = float(ev["ts"]) * unit
            if ev["type"] in ("span", "interval"):
                dur = float(ev["dur"]) * unit
                events.append({"ph": "X", "name": ev["name"], "cat": "repro",
                               "pid": pid, "tid": tid, "ts": ts, "dur": dur,
                               "args": _export_args(ev)})
            elif ev["type"] == "instant":
                events.append({"ph": "i", "name": ev["name"], "cat": "repro",
                               "pid": pid, "tid": tid, "ts": ts, "s": "t",
                               "args": _export_args(ev)})
            else:  # counter
                events.append({"ph": "C", "name": ev["name"], "cat": "repro",
                               "pid": pid, "tid": tid, "ts": ts,
                               "args": ev["args"]})
        events.sort(key=lambda e: (e["pid"], e["tid"], e["ts"],
                                   -e.get("dur", 0.0)))
        pids = [CONTROL_PID, VIRTUAL_PID]
        if any(pid == WALL_PID for pid, _track in self._tids):
            pids.append(WALL_PID)
        meta = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                 "args": {"name": _PROCESS_NAMES[pid]}} for pid in pids]
        for (pid, track), tid in sorted(self._tids.items(),
                                        key=lambda kv: kv[1]):
            meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                         "tid": tid, "args": {"name": track}})
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def snapshot(self) -> dict:
        """Flat summary of the event stream: per-name span/interval
        counts and total durations, instant counts, last counter
        values, and the total event count."""
        evs = self.events()
        out: dict = {"events": len(evs)}
        for ev in evs:
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


def _export_args(ev: dict) -> dict:
    """An event's exported args: its own, and a wall-clock event's ids,
    call and counters beside them."""
    if ev["pid"] != WALL_PID:
        return ev["args"]
    out = dict(ev["args"], id=ev["id"], parent=ev["parent"], call=ev["call"])
    if ev.get("counters"):
        out["counters"] = ev["counters"]
    return out


# ---------------------------------------------------------------------------
# WallTracer: the same interface on the wall clock
# ---------------------------------------------------------------------------

#: the wall-clock recorder's counter of kernel entry-point calls ...
ENTRIES = "kernel.entries"
#: ... and of their ns (argument and index checks, the launch)
ENTRY_NS = "kernel.entry_ns"
#: the segments K1's whole-exchange entry point combined (k a call)
K1_SEGMENTS = "k1.segments"
#: SSD prefill scans run by the kernel, and by the plain version (on the
#: CPU and on 'meta'), one a call
SSD_KERNEL = "ssd.kernel"
SSD_PLAIN = "ssd.plain"


def _delta(c0: Optional[dict], c1: Optional[dict]) -> dict:
    """The change of monotone counters from snapshot `c0` to `c1`."""
    if not c1:
        return {}
    return {k: v - c0.get(k, 0) for k, v in c1.items() if v != c0.get(k, 0)}


def _wall_event(t: tuple) -> dict:
    """A held wall-clock record as `Tracer`'s event dict, with `id`,
    `parent`, `call` and `counters` (the change over a span) beside."""
    kind, name, track, pid, ts, dur, id_, parent, call, c0, c1, args = t
    ev = {"type": kind, "name": name, "track": track, "pid": pid, "ts": ts,
          "args": args}
    if dur is not None:
        ev["dur"] = dur
    if pid == WALL_PID:
        ev.update(id=id_, parent=parent, call=call, counters=_delta(c0, c1))
    return ev


class _WallSpan:
    """Context manager recording one wall-clock span."""

    __slots__ = ("_rec", "name", "track", "args", "id", "parent", "call",
                 "_start", "_c0")

    def __init__(self, rec: "WallTracer", name: str, track: str, args: dict):
        self._rec = rec
        self.name = name
        self.track = track
        self.args = args

    def add(self, **args) -> None:
        """Attach more args to the span (e.g. the outcome, post-hoc)."""
        self.args.update(args)

    def __enter__(self) -> "_WallSpan":
        global LIVE
        rec = self._rec
        stack = rec._stack
        rec._ids += 1
        self.id = rec._ids
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            rec._calls += 1
            self.parent, self.call = None, rec._calls
            LIVE = rec
        stack.append(self)
        self._c0 = rec.counters.copy()
        self._start = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        global LIVE
        end = time.time_ns()
        rec = self._rec
        stack = rec._stack
        if stack[-1] is self:
            stack.pop()
        else:
            stack.remove(self)
        if not stack:
            LIVE = None
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        # the counters' change is taken on read (`_wall_event`)
        rec._append(("span", self.name, self.track, WALL_PID, self._start,
                     end - self._start, self.id, self.parent, self.call,
                     self._c0, rec.counters.copy(), self.args))
        return False


class WallTracer(Tracer):
    """Recording tracer on the wall clock (`time.time_ns()`).

    Spans nest by parent id (one thread records at a time); a span
    opened with no span open is a root and starts a new call id.
    `counters` are monotone over the recorder's life: `count(name)`,
    every instant under its own name, and `entry(t0_ns)` for each
    kernel entry point (:data:`ENTRIES`, :data:`ENTRY_NS`). Each span
    keeps their change over its extent. Virtual-clock intervals are
    kept as `Tracer` keeps them. At most `cap` records are held, as
    compact tuples (`events()` and `spans()` give them as dicts); the
    oldest are dropped first and `dropped` counts them.
    """

    wall = True

    def __init__(self, cap: int = 1 << 16):
        super().__init__()
        self._events = collections.deque(maxlen=cap)
        self.cap = cap
        self.dropped = 0
        self.counters: dict = {}
        self._stack: list = []
        self._ids = 0
        self._calls = 0

    def _append(self, rec: tuple) -> None:
        if len(self._events) == self.cap:
            self.dropped += 1
        self._events.append(rec)

    def events(self) -> list:
        return [_wall_event(t) for t in self._events]

    def span(self, name: str, track: str = "control", **args) -> _WallSpan:
        """Open a wall-clock span; use as a context manager."""
        return _WallSpan(self, name, track, args)

    def instant(self, name: str, track: str = "control",
                ts_s: Optional[float] = None, **args) -> None:
        """A marker on the wall clock, counted under its name; pinned to
        the virtual clock instead when `ts_s` (priced seconds) is
        given."""
        if ts_s is not None:
            self._append(("instant", name, track, VIRTUAL_PID, float(ts_s),
                          None, None, None, None, None, None, args))
            return
        self.count(name)
        top = self._stack[-1] if self._stack else None
        self._append(("instant", name, track, WALL_PID, time.time_ns(), None,
                      None, top and top.id, top and top.call, None, None,
                      args))

    def counter(self, name: str, value, track: str = "control") -> None:
        """A counter sample on the wall clock (Chrome "C" event)."""
        self._append(("counter", name, track, WALL_PID, time.time_ns(), None,
                      None, None, None, None, None, {name: value}))

    def interval(self, name: str, track: str, start_s: float, end_s: float,
                 **args) -> None:
        self._append(("interval", name, track, VIRTUAL_PID, float(start_s),
                      float(end_s) - float(start_s), None, None, None, None,
                      None, args))

    def annotate(self, **args) -> None:
        """Attach args to the innermost open span, if any."""
        if self._stack:
            self._stack[-1].args.update(args)

    def count(self, name: str, n: int = 1) -> None:
        """Add `n` to counter `name`."""
        self.counters[name] = self.counters.get(name, 0) + n

    def entry(self, t0_ns: int) -> None:
        """One kernel entry point's call, begun at `t0_ns`
        (`time.perf_counter_ns()`), ended now."""
        c = self.counters
        c[ENTRY_NS] = c.get(ENTRY_NS, 0) + time.perf_counter_ns() - t0_ns
        c[ENTRIES] = c.get(ENTRIES, 0) + 1

    def spans(self, t0_ns: Optional[int] = None,
              t1_ns: Optional[int] = None) -> list:
        """The wall-clock spans held, oldest first, as event dicts; with
        `t0_ns` / `t1_ns`, those that start and end inside [t0_ns,
        t1_ns]."""
        lo = -1 if t0_ns is None else t0_ns
        hi = float("inf") if t1_ns is None else t1_ns
        return [_wall_event(t) for t in self._events
                if t[0] == "span" and t[4] >= lo and t[4] + t[5] <= hi]

    def clear(self) -> None:
        """Drop every record held (counters, ids and `dropped` stay)."""
        self._events.clear()


# ---------------------------------------------------------------------------
# Process-default tracer + scoping
# ---------------------------------------------------------------------------

_ACTIVE = NULL
#: The process's wall-clock recorder: what `current()` returns while a
#: torch profiler session is active and no tracer is installed.
WALL = WallTracer()
#: The wall-clock recorder while one of its spans is open, else None:
#: the one global a hot path reads (a kernel launch, a cache lookup).
LIVE: Optional[WallTracer] = None


def current():
    """The tracer instrumentation should record to right now: the one a
    `use()` / `with tracer:` scope installed; else :data:`WALL` while a
    torch profiler session is active; else the :data:`NULL` no-op
    tracer."""
    if _ACTIVE is not NULL:
        return _ACTIVE
    return WALL if _profiling() else NULL


def wall():
    """`current()` where it records on the wall clock, else :data:`NULL`:
    the gate of the spans that only the wall clock carries."""
    tr = current()
    return tr if tr.wall else NULL


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
