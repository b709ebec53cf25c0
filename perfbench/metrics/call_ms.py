"""call_ms: the window over the calls completed in it, ms (host clock).
A call ends with its result on the card and the device synchronised."""


def read(run):
    return run.window_s / len(run.done) * 1e3 if run.done else None
