"""moe_slot_ratio.<cells>: the dispatch rows the alltoall moves over the
routed assignments, x: the program's counters `moe.slots` (every rank's
experts x capacity, padding included) over `moe.assignments` (tokens x
top-k) of the traced calls (`lm_spans.slot_ratio`); 1 is a dispatch
with no padding."""
import lm_spans


def read(run):
    return lm_spans.slot_ratio(run)
