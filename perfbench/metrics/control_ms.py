"""control_ms.<cells>: the control plane's wall time a traced call or
batch, ms: the whole duration of the program's `engine.resolve` (the
selector's pick, the schedule) and `engine.compile` (the compile memo)
spans, nested spans included (`bench_spans.control_ns`)."""
import bench_spans


def read(run):
    sp = bench_spans.spans(run)
    return None if sp is None else \
        bench_spans.per_call_ms(run, bench_spans.control_ns(sp))
