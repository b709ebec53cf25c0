"""k1_roofline.coll: K1's least time over its device time, %. K1's work
is the allreduce's pairwise combines: (ranks - 1) two-operand adds an
element, each operand read once and each result written once
(`bench_counts.pairwise_combine_bytes`), at the HBM bandwidth."""
import bench_counts
import peaks

K1 = "K1 fused_combine"


def read(run):
    t = run.trace
    if t is None or not t.calls or not t.count(K1):
        return None
    cfg = run.config
    least = t.calls * bench_counts.pairwise_combine_bytes(
        cfg["mesh"][cfg["axis"]], cfg["bytes_per_rank"] // 4) \
        / peaks.HBM_BYTES_PER_S
    return 100.0 * least / t.group_s(K1)
