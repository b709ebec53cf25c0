#!/usr/bin/env python3
"""Probe the SSD prefill scan (`kernels/csrc/ssd_scan.cu`) on an NVIDIA GPU.

Prints `nvcc -Xptxas -v` for the source (registers, shared memory,
spills of each kernel), then, at each shape of `tests/test_torch_cuda.py`'s
SSD cases, the kernel's and the plain version's largest errors against
the float64 recurrence, and at Granite-4.0-H's per-card prefill shape (8
sequences x 16384 positions, 16 heads, P 64, n 128, chunk 256, bf16) the
kernel's time (CUDA events over many calls), each of its four kernels'
device time (torch.profiler), the plain version's time, both peaks of
allocated memory and the bound: the larger of the bytes the work needs
(inputs read once, y and the final state written once) over 3.35 TB/s
and the products it needs (the causal pairs only) over 67 TFLOP/s. One
JSON line each, with the card's `nvidia-smi` name and power limit.
Needs a card and `nvcc`:

    python3 scripts/ssd_probe.py [--skip-errors]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))
from repro_torch.kernels import _build, ops, ref, ssd_scan  # noqa: E402

GRANITE = (8, 16384, 16, 64, 128, 256)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def ptxas() -> str:
    out = ROOT / "build" / "ssd_probe"
    out.mkdir(parents=True, exist_ok=True)
    res = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
         str(_build.CSRC / "ssd_scan.cu"), "-o", str(out / "ssd_scan.o")],
        capture_output=True, text=True)
    return res.stdout + res.stderr


def kernels_ms(fn, reps: int = 5) -> dict:
    """Each kernel's device time a call of `fn` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        if us:
            split[ev.key[:80]] = us / reps / 1e3
    return split


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def peak_bytes(fn) -> int:
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-errors", action="store_true")
    args = ap.parse_args()
    import test_torch_cuda as T
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi()
    emit({"probe": "ptxas", "card": card, "out": ptxas()})
    _build.library()
    dev = torch.device("cuda")
    if not args.skip_errors:
        for case, (*dims, chunk) in T.SSD_CASES.items():
            for dtype in (torch.float32, torch.bfloat16):
                a = T._ssd_inputs(*dims, dtype, dev, seed=len(case))
                y, h = ops.ssd_chunked(*a, chunk)
                y_p, h_p = ref.ssd_chunked(*a, chunk)
                y64, h64 = ref.ssd_recurrence(*a)
                emit({"probe": "error", "case": case,
                      "dtype": str(dtype).split(".")[-1],
                      "y_err": T._rel_err(y, y64),
                      "y_plain_err": T._rel_err(y_p, y64),
                      "state_err": T._rel_err(h, h64),
                      "state_plain_err": T._rel_err(h_p, h64),
                      "card": card})
                del a, y, h, y_p, h_p, y64, h64
        torch.cuda.empty_cache()

    *dims, chunk = GRANITE
    a = T._ssd_inputs(*dims, torch.bfloat16, dev, seed=1)
    nbytes, flops = ssd_scan.needs(*dims, chunk, 2)
    bound = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3
    kernel_ms = time_ms(lambda: ops.ssd_chunked(*a, chunk), 20)
    plain_ms = time_ms(lambda: ref.ssd_chunked(*a, chunk), 3)
    kernel_peak = peak_bytes(lambda: ops.ssd_chunked(*a, chunk))
    plain_peak = peak_bytes(lambda: ref.ssd_chunked(*a, chunk))
    split = kernels_ms(lambda: ops.ssd_chunked(*a, chunk))
    emit({"probe": "granite", "shape": dict(zip("N S H P n".split(), dims),
                                            chunk=chunk, dtype="bfloat16"),
          "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound,
          "bound_by": "operations" if flops / FP32_FLOP_PER_S
          > nbytes / HBM_BYTES_PER_S else "bytes",
          "needed_bytes": nbytes, "needed_flops": flops,
          "achieved_tflop_per_s": flops / kernel_ms / 1e9,
          "roofline_share": bound / kernel_ms,
          "kernels_ms": split,
          "kernel_peak_bytes": kernel_peak, "plain_peak_bytes": plain_peak,
          "card": card, "card_after": smi()})


if __name__ == "__main__":
    main()
