"""Entry points of the port (the only place its library code prints):

  dlrm_serve          the distributed DLRM server and its CLI
  distributed_vecmat  use case 1: the vector-matrix offload and its CLI
  serve               LM serving: the teacher-forced decode loop and its CLI
  train               LM training: the Trainer and its CLI
  dryrun              every (arch x shape) cell run once on 'meta' tensors
                      at production scale, and its CLI
  analysis            the counters of one eager step the dry run reads
  mesh                make_mesh_for, the launchers' (pod, data, model)
                      mesh, and make_production_mesh

and `median_ms`, the timing helper they and `chip_smoke.py` share.
"""
from __future__ import annotations

import statistics
import time

import torch


def median_ms(fn, reps: int, device) -> float:
    """Median time of one call of `fn`, in ms, after a warm-up call: CUDA
    events around each call on the card, the host clock on the CPU."""
    device = torch.device(device)
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize(device)
            times.append(e0.elapsed_time(e1))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)
