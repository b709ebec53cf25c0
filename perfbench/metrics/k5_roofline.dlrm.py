"""k5_roofline.dlrm: the lookup's K5 against its least time, %: the ids,
each looked-up row and every rank's partial concat vector, each once
(`bench_counts.lookup_bytes`), over the HBM bandwidth, for every traced
batch, over K5's device time."""
import bench_counts
import peaks

K5 = "K5 gather_rows"


def read(run):
    t = run.trace
    if t is None or not t.calls or not t.count(K5):
        return None
    cfg, B = run.config, run.params["batch"]
    least = bench_counts.lookup_bytes(cfg, B, cfg["mesh"]["model"]) \
        / peaks.HBM_BYTES_PER_S
    return 100.0 * t.calls * least / t.group_s(K5)
