"""idle_dataplane.<cells>: the share of the traced stretch's device-idle
time spent while the host was in the data plane, %: each idle gap
between the device's operations (`Trace.intervals()`) goes to the
innermost program span holding its midpoint, and the share is that of
the gaps whose span is `execute_program` or `exchange`
(`bench_spans.idle_by_span`)."""
import bench_spans


def read(run):
    idle = bench_spans.idle_by_span(run)
    total = sum(idle.values()) if idle else 0
    if not total:
        return None
    dp = sum(v for k, v in idle.items() if k in bench_spans.DATA_PLANE)
    return 100.0 * dp / total
