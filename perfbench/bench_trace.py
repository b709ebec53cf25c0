"""The traced run: device operations from torch.profiler, host spans from
the harness, and the arithmetic that turns them into busy time, groups
and a breakdown.

`Recorder` profiles a stretch of calls with the CUDA activity alone (no
CPU-op recording, which would slow the host-bound calls it measures) and
records the harness's own spans around each call into the program and
each copy to the host, on the host's wall clock in ns, the clock the
profiler stamps its events with. The kernel groups are a frozen copy of
`chip_smoke.py`'s (`_KERNEL_GROUPS`, `_DLRM_GROUPS`, `_LM_GROUPS`): the
first pattern a device operation's name holds names its group.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import torch

CUBLAS = "cuBLAS"
INDEXING = "gather/scatter (indexing)"
GROUPS = (("fused_combine_kernel", "K1 fused_combine"),
          ("dequantize_kernel", "K3 dequantize_blocks"),
          ("quantize_kernel", "K2 quantize_blocks"),
          ("matmul_tiled_kernel", "K4 matmul_tiled"),
          ("k5_rows_kernel", "K5 gather_rows"),
          ("gemm", CUBLAS), ("gemv", CUBLAS), ("xmma", CUBLAS),
          ("cutlass", CUBLAS), ("nvjet", CUBLAS),
          ("CatArrayBatchedCopy", "torch.cat"),
          ("index", INDEXING),
          ("elementwise", "elementwise"), ("reduce", "reductions"),
          ("Memcpy", "memcpy"), ("Memset", "memset"))


@contextlib.contextmanager
def no_span(_name: str):
    yield


def span_of(rec):
    """`rec.span`, or a span that records nothing where there is no
    recorder."""
    return rec.span if rec is not None else no_span


def short_name(name: str, width: int = 120) -> str:
    """A kernel's name without its argument list, cut to `width`."""
    head = name.split("(", 1)[0] if not name.startswith("Mem") else name
    return head[:width]


def group_of(name: str) -> str:
    return next((g for pat, g in GROUPS if pat in name), "other")


@dataclasses.dataclass
class Trace:
    """A traced stretch of `calls` calls (`items` queries) that took
    `window_s` on the host clock, between `t0_ns` and `t1_ns` on the
    wall clock. `ops`: the device operations, (name, start_ns, dur_ns);
    `spans`: the harness's host spans, (name, start_ns, end_ns);
    `counters`: the program's counters' change over the stretch."""

    window_s: float
    calls: int
    items: int
    t0_ns: int
    t1_ns: int
    ops: list
    spans: list
    counters: dict = dataclasses.field(default_factory=dict)
    busy_ranks_s: Optional[list] = None   # every card's busy s (procs)

    def group_s(self, group: str) -> float:
        return sum(d for n, _s, d in self.ops if group_of(n) == group) / 1e9

    def count(self, group: str) -> int:
        return sum(1 for n, _s, _d in self.ops if group_of(n) == group)

    @property
    def aligned(self) -> bool:
        """Whether the device's stamps fall inside the host's window
        (within 1 ms), so that gaps can be named by host spans."""
        if not self.ops:
            return False
        slack = 1_000_000
        inside = sum(1 for _n, s, _d in self.ops
                     if self.t0_ns - slack <= s <= self.t1_ns + slack)
        return inside >= 0.9 * len(self.ops)

    def intervals(self) -> list:
        """The union of the device operations' intervals, merged and
        sorted, clipped to the window where the clocks agree."""
        iv = sorted((s, s + d) for _n, s, d in self.ops)
        if self.aligned:
            iv = [(max(a, self.t0_ns), min(b, self.t1_ns)) for a, b in iv]
            iv = [(a, b) for a, b in iv if b > a]
        merged: list = []
        for a, b in iv:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals()) / 1e9

    def idle_share(self) -> Optional[float]:
        if not self.ops or self.window_s <= 0:
            return None
        return 1.0 - self.busy_s / self.window_s


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, by name, and the idle
    time by what the host was doing (the host span that holds each gap's
    midpoint; 'harness' where none does)."""
    by_name: dict = {}
    for n, _s, d in trace.ops:
        n = short_name(n)
        by_name[n] = by_name.get(n, 0.0) + d / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps: dict = {}
    if trace.aligned:
        iv = trace.intervals()
        edges = [trace.t0_ns] + [x for ab in iv for x in ab] + [trace.t1_ns]
        spans = sorted(trace.spans, key=lambda s: s[1])
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            name = next((n for n, s, e in spans if s <= mid <= e), "harness")
            gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e9
    else:
        gaps["clocks not aligned"] = max(trace.window_s - trace.busy_s, 0.0)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle]}


class Recorder:
    """Profiles a stretch of calls on `device`; `span(name)` records a
    host span while it runs (and costs nothing otherwise)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.active = False
        self.spans: list = []
        self.trace: Optional[Trace] = None
        self._prof = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self, counters=None) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._sync()
        acts = ([ProfilerActivity.CUDA] if self.device.type == "cuda"
                else [ProfilerActivity.CPU])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._counters0 = dict(counters() if counters else {})
        self.spans = []
        self.active = True
        self._t0_ns = time.time_ns()
        self._p0 = time.perf_counter()

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.active:
            yield
            return
        s = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, s, time.time_ns()))

    def stop(self, calls: int, items: int, counters=None) -> Trace:
        self._sync()
        window_s = time.perf_counter() - self._p0
        t1_ns = time.time_ns()
        self.active = False
        c1 = dict(counters() if counters else {})
        self._prof.__exit__(None, None, None)
        ops = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                ops.append((e.name(), int(e.start_ns()), int(e.duration_ns())))
        self._prof = None
        delta = {k: c1[k] - self._counters0.get(k, 0) for k in c1}
        self.trace = Trace(window_s=window_s, calls=calls, items=items,
                           t0_ns=self._t0_ns, t1_ns=t1_ns, ops=ops,
                           spans=list(self.spans), counters=delta)
        return self.trace
