"""indexing_ms.coll: device time of the data plane's gathers and scatters
(the "gather/scatter (indexing)" group of the trace) a call, ms."""
from bench_trace import INDEXING


def read(run):
    t = run.trace
    if t is None or not t.calls or not t.count(INDEXING):
        return None
    return t.group_s(INDEXING) / t.calls * 1e3
