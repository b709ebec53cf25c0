"""Plain reference of the allreduce: the exact sum over the ranks.

Plain PyTorch; it imports nothing of the program. `gap` is the number
that decides `correct`: the widest error of any rank's result element
against the float64 sum, as a share of that element's sum of magnitudes
(sum_r |x_r|). Any order of n - 1 float32 additions stays within
(n - 1) 2^-24 of it; a result in a lower precision, a rank left out or
an element altered does not.
"""
from __future__ import annotations

import torch

BLOCK = 1 << 22      # elements a rank per block: bounds the float64 temporaries


def gap(results, inputs) -> float:
    """results: (R, elems), every rank's copy of the allreduce (or one
    rank's, (elems,)); inputs: (ranks, elems), every rank's input.
    max over ranks and elements of |y - sum_r x_r| / sum_r |x_r|; inf
    where a result is not a number."""
    if results.ndim == 1:
        results = results[None]
    worst = 0.0
    for lo in range(0, inputs.shape[1], BLOCK):
        x = inputs[:, lo:lo + BLOCK].double()
        exact = x.sum(0)
        mag = x.abs().sum(0).clamp_min(torch.finfo(torch.float64).tiny)
        y = results[:, lo:lo + BLOCK].double()
        err = (y - exact).abs() / mag
        if bool(err.isnan().any()):
            return float("inf")
        worst = max(worst, float(err.max()))
    return worst


def lower_precision_sum(inputs, dtype=torch.bfloat16):
    """The control: the same sum, inputs and result in `dtype`, returned
    as every rank's copy (ranks, elems) in float32."""
    s = inputs.to(dtype).sum(0, dtype=dtype).float()
    return s.expand(inputs.shape[0], -1)
