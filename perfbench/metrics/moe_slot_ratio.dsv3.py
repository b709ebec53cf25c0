"""moe_slot_ratio.dsv3: the dispatch rows the alltoall moves over the
assignments to the experts this card holds, x: the program's counters
`moe.slots` (every rank's experts x capacity, padding included, summed
over a dispatch's runs) over `moe.assignments` less `moe.absent` (those
routed to experts held elsewhere, which are sent nowhere) of the traced
calls' root spans; 1 is a dispatch with no padding. None where the
program counts none of them."""
import bench_spans

NAMES = ("moe.slots", "moe.assignments", "moe.absent")


def read(run):
    sp = bench_spans.spans(run)
    if sp is None:
        return None
    got = dict.fromkeys(NAMES, 0)
    for s in sp:
        if s.parent is None:
            for k in NAMES:
                got[k] += s.counters.get(k, 0)
    held = got["moe.assignments"] - got["moe.absent"]
    return got["moe.slots"] / held if held > 0 else None
