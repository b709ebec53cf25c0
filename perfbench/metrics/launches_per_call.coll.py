"""launches_per_call.coll: device operations (kernels, copies, sets) in
the trace over the traced calls, a count."""


def read(run):
    t = run.trace
    if t is None or not t.ops or not t.calls:
        return None
    return len(t.ops) / t.calls
