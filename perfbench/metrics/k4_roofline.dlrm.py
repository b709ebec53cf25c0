"""k4_roofline.dlrm: FC1's K4 against its least time, %: the larger of
its bytes (the concat slices, the weight, every rank's partial product,
each once) over the HBM bandwidth and its operations (2 B concat fc0)
over the fp32 peak, for every traced batch, over K4's device time."""
import bench_counts
import peaks

K4 = "K4 matmul_tiled"


def read(run):
    t = run.trace
    if t is None or not t.calls or not t.count(K4):
        return None
    cfg, B = run.config, run.params["batch"]
    tp = cfg["mesh"]["model"]
    least = max(bench_counts.fc1_bytes(cfg, B, tp) / peaks.HBM_BYTES_PER_S,
                bench_counts.fc1_flops(cfg, B) / peaks.FP32_FLOPS_PER_S)
    return 100.0 * t.calls * least / t.group_s(K4)
