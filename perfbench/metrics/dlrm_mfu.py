"""dlrm_mfu: the model's operations in the window over what the card's
fp32 peak could do in it, %: the whole window and its queries (host
clock), as `qps` reads them, and not the profiled stretch alone, which
CUPTI slows. The model's operations: 2 K N for each FC layer of Table 2,
15.47 MFLOP a query (`bench_counts`); the peak is fp32's, 67 TFLOP/s: the
configuration computes in fp32 and no TF32."""
import bench_counts
import peaks


def read(run):
    queries = sum(n for _lat, n in run.done)
    if not queries or run.window_s <= 0:
        return None
    flops = queries * bench_counts.dlrm_flops_per_query(run.config)
    return 100.0 * flops / (run.window_s * peaks.FP32_FLOPS_PER_S)
