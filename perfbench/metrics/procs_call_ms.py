"""procs_call_ms: rank 0's window over the calls it completed in it, ms
(host clock), one rank per process and card."""


def read(run):
    return run.window_s / len(run.done) * 1e3 if run.done else None
