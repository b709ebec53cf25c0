"""dsv3_mfu: the model's operations in the window over what the card's
bf16 peak could do in it, %: the whole window and its prompts (host
clock), as `qps` reads them. The operations (`dsv3_counts`): a
16384-token prompt of the 7-layer cut, MLA's core at its causal half,
the routed experts held here at 2 assignments a token, the head at the
last position; the peak is bf16's, 989 TFLOP/s: the configuration
computes in bf16."""
import dsv3_counts
import peaks


def read(run):
    prompts = sum(n for _lat, n in run.done)
    if not prompts or run.window_s <= 0:
        return None
    flops = prompts * dsv3_counts.prefill_flops(
        run.config, run.params["prompt_tokens"])
    return 100.0 * flops / (run.window_s * peaks.BF16_FLOPS_PER_S)
