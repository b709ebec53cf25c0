"""a2a_ms.<cells>: the MoE's expert-parallel exchange a traced call, ms:
the whole duration of the engine's `engine.alltoall` spans under
`moe.dispatch` and `moe.combine` (`lm_spans.a2a_ms`)."""
import lm_spans


def read(run):
    return lm_spans.a2a_ms(run)
