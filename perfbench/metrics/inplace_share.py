"""inplace_share.<cells>: the share of the data plane's exchanges written
straight into the buffer through their target index, %: the program's
counters `exchange.in_place` over `exchange.in_place` + `exchange.deferred`
(`core/engine.py::_exchange`, one an exchange) of the traced calls' root
spans. None where the program counts neither."""
import bench_spans

IN_PLACE, DEFERRED = "exchange.in_place", "exchange.deferred"


def read(run):
    sp = bench_spans.spans(run)
    if sp is None:
        return None
    got = {IN_PLACE: 0, DEFERRED: 0}
    for s in sp:
        if s.parent is None:
            for k in got:
                got[k] += s.counters.get(k, 0)
    total = got[IN_PLACE] + got[DEFERRED]
    return 100.0 * got[IN_PLACE] / total if total else None
