"""Each device operation's launch on the host, in a traced run.

torch.profiler, with the CUDA activity alone, records beside every
device operation the CUDA runtime or driver call that issued it
(`cudaLaunchKernel`, `cuLaunchKernel`, `cudaMemcpyAsync`, ...), under the
same correlation id, stamped on the wall clock the program's spans use
(`time.time_ns()`). `LaunchRecorder` is the harness's `Recorder` that
also keeps, for each operation of its trace's `ops`, the host time its
call started (`trace.launch_ns`, None where no call matched).
`device_ms(run, prefix)` reads a span family's device time from it: the
device operations launched inside the program's outermost spans named
`prefix`*, whatever later moment the device ran them at. A trace with no
launches (the parent's, an untraced run, the CPU) reads None.
"""
from __future__ import annotations

import bisect
from typing import Optional

import torch

import bench_spans
from bench_trace import Recorder


def launch_times(events) -> list:
    """[(name, start_ns, dur_ns, launch_ns or None)] of the device
    operations among kineto `events`, in their order: the start of the
    host call with the operation's correlation id."""
    cuda = torch.autograd.DeviceType.CUDA
    calls = {}
    ops = []
    for e in events:
        if e.device_type() == cuda:
            ops.append(e)
        elif e.correlation_id():
            calls[e.correlation_id()] = int(e.start_ns())
    return [(e.name(), int(e.start_ns()), int(e.duration_ns()),
             calls.get(e.correlation_id())) for e in ops]


class LaunchRecorder(Recorder):
    """`Recorder` whose trace also holds `launch_ns`, one host launch
    time an operation of `ops`."""

    def stop(self, calls: int, items: int, counters=None):
        prof = self._prof
        trace = super().stop(calls, items, counters)
        got = launch_times(prof.profiler.kineto_results.events())
        trace.launch_ns = ([lt for *_op, lt in got]
                           if [tuple(g[:3]) for g in got] == trace.ops
                           else None)
        return trace


def device_ms(run, prefix: str) -> Optional[float]:
    """The device time of the operations launched inside the program's
    outermost spans named `prefix`*, a traced call, ms; None where the
    trace has no launch times or the program no such span."""
    t = run.trace
    launch = getattr(t, "launch_ns", None) if t is not None else None
    sp = bench_spans.spans(run)
    if not launch or sp is None:
        return None
    by_id = {s.id: s for s in sp}
    outer = sorted((s.start, s.end) for s in sp if s.name.startswith(prefix)
                   and not any(a.name.startswith(prefix)
                               for a in bench_spans._ancestors(s, by_id)))
    if not outer:
        return None
    starts = [a for a, _b in outer]
    ns = 0
    for (_n, _s, dur), at in zip(t.ops, launch):
        if at is None:
            continue
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and at <= outer[i][1]:
            ns += dur
    return bench_spans.per_call_ms(run, ns)
