"""mla_ms.<cells>: MLA's device time a traced call, ms: the device
operations launched inside the program's `mla.*` spans (the mixer with
its q, kv, core and out, the TP collectives under them included), paired
with their launch calls by torch.profiler's correlation ids
(`launches.device_ms`). None where the trace has no launch times or the
program recorded no such span."""
import launches


def read(run):
    return launches.device_ms(run, "mla.")
