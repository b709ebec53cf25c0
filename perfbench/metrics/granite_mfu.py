"""granite_mfu: the model's operations in the window over what the card's
bf16 peak could do in it, %: the whole window and its prompts (host
clock), as `qps` reads them. The operations (`granite_counts`): a
16384-token prompt of the 20-layer stage, routed experts at top-10,
attention and the SSD's intra-chunk products at their causal half, the
head at the last position; the peak is bf16's, 989 TFLOP/s: the
configuration computes in bf16."""
import granite_counts
import peaks


def read(run):
    prompts = sum(n for _lat, n in run.done)
    if not prompts or run.window_s <= 0:
        return None
    flops = prompts * granite_counts.prefill_flops(
        run.config, run.params["prompt_tokens"])
    return 100.0 * flops / (run.window_s * peaks.BF16_FLOPS_PER_S)
