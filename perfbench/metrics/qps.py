"""qps: queries whose logits reached the host in the window, over the
window, queries/s (host clock)."""


def read(run):
    return sum(n for _lat, n in run.done) / run.window_s if run.done else None
