"""launches_per_batch.dlrm: device operations (kernels, copies, sets) in
the trace over the traced batches, a count."""


def read(run):
    t = run.trace
    if t is None or not t.ops or not t.calls:
        return None
    return len(t.ops) / t.calls
