"""model_ms.dlrm: the model step's own host time a traced batch, ms: the
self time of the program's `dlrm.*` spans (ids in, lookup, FC layers,
unstack) outside every engine span, less the kernel entry points' ns
charged to them (`bench_spans.model_ns`)."""
import bench_spans


def read(run):
    sp = bench_spans.spans(run)
    return None if sp is None else \
        bench_spans.per_call_ms(run, bench_spans.model_ns(sp))
