"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), the yardstick of
every roofline and utilization share the benchmark reports.

Source of every number: NVIDIA H100 Tensor Core GPU data sheet (SXM
column, dense rates without sparsity), at the card's full power limit
of 700 W. A card set below that limit runs slower under load, so every
share is reported beside the power limit that `nvidia-smi` reads
(`power_limit`).
"""
from __future__ import annotations

import subprocess

#: HBM3 bandwidth, bytes/s (data sheet: 3.35 TB/s)
HBM_BYTES_PER_S = 3.35e12
#: float32 outside the tensor cores, FLOP/s (data sheet: 67 TFLOP/s)
FP32_FLOPS_PER_S = 67e12
#: TF32 tensor cores, dense, FLOP/s (data sheet: 495 TFLOP/s)
TF32_FLOPS_PER_S = 495e12
#: bf16 / fp16 tensor cores, dense, FLOP/s (data sheet: 989 TFLOP/s)
BF16_FLOPS_PER_S = 989e12
#: device memory, bytes (data sheet: 80 GB)
MEMORY_BYTES = 80e9
#: the power limit the peaks above assume, W
POWER_LIMIT_W = 700.0


def power_limit() -> str:
    """The card's name and power limit as `nvidia-smi` reads them, or
    'not read' where it cannot run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.stdout.strip().replace("\n", "; ") or "not read"
