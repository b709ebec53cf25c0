"""batch_p95_ms: the 95th percentile over every batch of the window of
its latency, from issue to its logits on the host, ms: CUDA events
recorded at the issue and after the copy to the host, read on the
device's clock (the source `device_trace`; not the profiler's trace,
which the untraced runs that report this do not take)."""
import statistics


def read(run):
    lat = [t for t, _n in run.done if t is not None]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94] * 1e3
