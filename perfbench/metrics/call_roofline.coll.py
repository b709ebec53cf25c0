"""call_roofline.coll: the allreduce's least time over its time, %. The
least time: every rank's input read once and every rank's result written
once, at the card's HBM bandwidth (2 x 8 x 64 MiB / 3.35 TB/s); its time:
the whole window over its calls (host clock), as `call_ms` reads it, and
not the profiled stretch alone, which CUPTI slows. Whatever replaces K1,
the work counted stays the same."""
import bench_counts
import peaks


def read(run):
    if not run.done or run.window_s <= 0:
        return None
    cfg = run.config
    least = bench_counts.allreduce_least_bytes(
        cfg["mesh"][cfg["axis"]], cfg["bytes_per_rank"] // 4) \
        / peaks.HBM_BYTES_PER_S
    return 100.0 * least / (run.window_s / len(run.done))
