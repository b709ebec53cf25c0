"""launch_ms.<cells>: the kernel entry points' host time a traced call
or batch, ms: the `kernel.entry_ns` counter of the program's root spans
(K1-K5 in `kernels/ops.py`: argument and index checks, the ctypes
launch; `bench_spans.entry_ns`)."""
import bench_spans


def read(run):
    sp = bench_spans.spans(run)
    return None if sp is None else \
        bench_spans.per_call_ms(run, bench_spans.entry_ns(sp))
