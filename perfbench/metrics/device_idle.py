"""device_idle.<cells>: the device's idle share over the traced calls, %:
1 - (the union of the device operations' intervals in the torch.profiler
trace) / the traced window (host clock). One rank per process: rank 0's
card. One reader for every cell's split of the quantity."""


def read(run):
    t = run.trace
    share = t.idle_share() if t is not None else None
    return None if share is None else 100.0 * share
