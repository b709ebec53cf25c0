"""moe_ms.<cells>: the MoE's own host time a traced call, ms: the self
time of the program's `moe.*` spans (route, dispatch, experts, combine,
shared) outside every engine span, less the kernel entry points' ns;
the per-expert counts' read to the host (`moe.count_sync`, the host
waiting for the device) is left out (`lm_spans.moe_ms`)."""
import lm_spans


def read(run):
    return lm_spans.moe_ms(run)
