"""staged_ms.procs: rank 0's `Transport` `staged_ms` (host time of the
copies that stage CUDA payloads through pinned host memory for gloo,
closed by a synchronize) over the traced calls, ms a call."""


def read(run):
    t = run.trace
    if t is None or not t.calls or "staged_ms" not in t.counters:
        return None
    return t.counters["staged_ms"] / t.calls
