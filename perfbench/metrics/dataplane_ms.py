"""dataplane_ms.<cells>: the data plane's host time a traced call or
batch, ms: the self time of the program's `execute_program` and
`exchange` spans (the program walk, the region indices, the index
views and copies it issues), less the kernel entry points' ns charged to
them (`bench_spans.dataplane_ns`)."""
import bench_spans


def read(run):
    sp = bench_spans.spans(run)
    return None if sp is None else \
        bench_spans.per_call_ms(run, bench_spans.dataplane_ns(sp))
