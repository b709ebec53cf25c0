"""ssm_ms.<cells>: the Mamba2 mixer's own host time a traced call, ms: the
self time of the program's `ssm.*` spans (mixer, proj, scan, norm)
outside every engine span, less the kernel entry points' ns
(`lm_spans.ssm_ms`)."""
import lm_spans


def read(run):
    return lm_spans.ssm_ms(run)
