"""Parallelism knobs: `ParallelConfig`, copied field for field from
`repro/configs/base.py`.

`ArchConfig`, `ShapeConfig` and `get_config` wait for the LM stack
(`get_config` imports `repro.configs.<id>`, which the port must not).
The port reads `backend`, `tp_axis`, `fsdp_axis`, `sequence_parallel`,
`collective_matmul` and `serving`; `use_pallas` is kept for the copy but
has no effect — on the card the port's kernels always run, on the CPU
their plain versions (`kernels/ops.py`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Parallelism & perf knobs (the hillclimb levers)."""

    backend: str = "microcode"         # 'microcode' | 'native'
    fsdp_axis: str = "data"            # weight-shard axis
    dp_axes: tuple = ("pod", "data")   # batch axes
    tp_axis: str = "model"
    sequence_parallel: bool = False    # SP norm regions (RS/AG pairs)
    remat: str = "full"                # 'none' | 'full' | 'dots'
    grad_compression: Optional[str] = None  # None | 'int8' | 'bf16'
    collective_matmul: bool = False    # streaming TP matmuls
    attn_q_block: int = 512
    attn_kv_block: int = 1024
    moe_capacity_factor: float = 1.25
    use_pallas: bool = False
    scan_layers: bool = True
    # gradient accumulation: split the per-device batch into k microbatches
    # (scan with per-microbatch backward — activations shrink k x, enabling
    # remat='none' at full-remat memory budgets)
    microbatches: int = 1
    # decode: shard KV-cache sequence over the TP axis + flash-combine
    decode_seq_shard: bool = True
    # serving layout: params replicate over 'data' (no ZeRO-3 gathers on
    # the token path); set automatically by the serve step builders
    serving: bool = False
    # KV-cache storage dtype: 'param' (model dtype) or 'int8' (per-slot
    # symmetric quantization — the paper's unary streaming plugin applied
    # to cache storage; beyond-paper decode-memory optimization)
    kv_cache_dtype: str = "param"
    # gradient sync through the engine's request queue: every bucket's
    # allreduce is ISSUED non-blocking (engine.itree_allreduce) before
    # any is waited, so buckets across sync groups sit in the CCLO-style
    # command queue together — small same-dtype buckets coalesce and the
    # drain overlaps independent buckets' latency (bitwise-identical to
    # the blocking path by the queue's coalescing eligibility rule).
    async_grad_sync: bool = True
