#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's paths — the collective offload engine at the
repository's own top message size (64 MiB per rank on 8 ranks, the top
of `seg_sweep` / `hier_sweep` in benchmarks/figures.py), distributed
DLRM inference (the paper's use case 2) at the full width of the paper's
Table 2 model, the offload queue with the paper's use case 1
(distributed vector-matrix multiply), and LM serving (prefill and
decode of qwen3-0.6b at full width, then of the MoE, SSM, hybrid and
audio families: qwen3-moe-30b-a3b, mamba2-1.3b, hymba-1.5b and
whisper-medium at full width) and LM training (qwen3-0.6b at full
width: the train step and the `Trainer`) — ranks stacked on the card — and
the collectives (both backends), the streaming ops, use cases 1 and 2 and
every LM family's serving and training (the `Trainer`'s elastic shrink
included) one rank per process, 8 processes on the card, and holds every
kernel on those paths against its plain PyTorch version.
Phases, one line each:

  1. device: the card (nvidia-smi) and the kernels' build time;
  2. kernels: K1 add/max/min/mul fp32+bf16, K2 (codes, scales, exact .5
     ties), K3 copy / fp32 add / bf16 add — each BITWISE against its
     plain version at the main path's segment shape; K1's indexed entry
     point (operands read in place through the executor's region index)
     BITWISE, every op, fp32 and bf16 and an fp32 -> bf16 cast, on the
     indices of real ring exchanges, one launch an exchange: 16-byte and
     unaligned units, 1 and 32 segments; K2's and K3's indexed entry
     points (a whole compressed exchange per launch) BITWISE likewise,
     every consume op, .5 ties;
  3. main path fp32: allreduce (auto), reduce_scatter, allgather, bcast,
     alltoall and a ("pod", "data") = (2, 4) two-axis allreduce on
     integer-valued inputs from --seed, each BITWISE against a torch
     oracle over the rank dim;
  4. main path int8: the same allreduce with compression="int8", within
     the codec's error bound of the oracle, and bitwise equal to the same
     call on the CPU (plain versions) at 4 MiB per rank; one K2 and one
     K3 launch per compressed exchange;
  5. times: the median of >= 10 runs after warm-up (CUDA events) per
     collective (where their device time goes is perfbench's traced
     split); per-launch times of K1-K3 (K1 also one launch per bidi_ring exchange
     of 32 segments, read through its index out of the 8 x 64 MiB stack:
     `exchange_ms` beside `exchange_bound_ms`; K2 and K3 also one
     launch per compressed exchange of the int8 allreduce: `exchange_ms`
     beside `exchange_bound_ms`, and a line with k per-segment launches
     against one exchange launch, after K2 and K3 are held BITWISE
     against their plain versions on every one of those exchanges); the
     SSD prefill scan (`ops.ssd_chunked`) at Granite-4.0-H-Small's
     per-card prefill (8 x 16384 positions, 16 heads, P 64, n 128,
     chunk 256, bf16): y and the final state within twice the plain
     version's error against the float64 recurrence (`ssd_within`), its
     device time beside the plain version's and its bound;
  6. dlrm: the full `CONFIG` (100 tables x 4,000,000 rows x 32 fp32,
     51.2 GB, drawn on the card from --seed) served by `DLRMServer` on
     the (pod, data, model) = (1, 1, 8) mesh with collective_matmul:
     K4 at the FC1 shapes within its per-element bound of the plain
     version, K5's `gather_rows` and `lookup_rows` (the lookup the path
     runs: each rank's partial vector straight into the concat layout)
     bitwise on the server's own tables and the mesh's row offsets, ids
     at every shard edge, below 0 and past the last row included; 20
     batches of 32 requests and one of 2048, each launching K4 and K1 at
     least once and K5 exactly once; the concat vector
     BITWISE equal to direct indexing of the tables and the logits
     within atol 1e-5 + rtol 1e-4 of a float64 single-copy reference;
     median latency and queries/s against the single-copy reference;
     the device time of one batch by kernel group with the idle share.
     (If the card's free memory is short of the tables, only
     rows_per_table is cut, and the phase's lines say so.)
  7. queue: use case 1, `distributed_vecmat` at the example's sizes
     512-4096 and at 32768 (a 4 GiB fp32 matrix, 512 MiB per rank, drawn
     on the card from --seed), 4 tiles, one binomial-tree `ireduce` per
     tile (exactly log2(8) = 3 K1 launches per tile), within gamma_K
     (|x| @ |w|) of the float64 single-copy product, the queue model's
     makespan below the serial cost on ACCL_CLUSTER, medians against the
     single-copy `x @ w` and the device's idle share at every size; then
     a mixed queue drained on the card (three coalescing small
     allreduces, an int8 allreduce at 4 MiB per rank, a reduce consuming
     another request, an issue_multi over a (2, 4) mesh) BITWISE equal
     to the blocking calls and, without the int8 request, to
     `simulate_drain`; one K2 and one K3 launch per compressed exchange;
     the coalesced bucket one program. Every K1 call of both runs is
     recorded with its operands and replayed BITWISE against K1's plain
     version: on the path's own operands, and through the same region
     indices on normal-valued operands of the same shapes.
  8. lm: LM serving, `get_config("qwen3-0.6b")` at full width and depth
     (28 layers, d 1024, bf16, 4.8 GB of weights stacked over the 8
     ranks), params drawn on the card from --seed, on the (pod, data,
     model) = (1, 4, 2) mesh of `launch/serve.py`. At (batch, prompt,
     gen) = (4, 16, 8): run A the `ServeSession` (prefill, handoff,
     decode), run B the launcher's teacher-forced decode loop, run C a
     prefill with sequence_parallel + collective_matmul (K4 through
     `allgather_matmul`), run D run A with the int8 KV cache (decoding
     teacher-forced on run A's tokens). Each run counted from 0; every K1
     call held BITWISE against its plain version as it runs and again on
     normal values through its indices, every K4 call within
     2 K 2^-24 (|x| @ |w|) + 2^-8 |y|; per decode step, K1 launches equal
     to the count its compiled allreduce programs imply, 59 allreduces.
     The tokens of runs A and B against a float64 single-copy forward
     (plain torch, weights unstacked): equal to its argmax wherever its
     top-1 leads its top-2 by more than 4 sqrt(2) eps rms(logits), eps =
     2^-8 sqrt(10 L + 2) (`lm_eps`), and everywhere a token whose logit
     there lies within that margin of its best; run C's token by the
     same rule and
     its caches within 4 eps of run A's; run D's tokens equal run A's on
     >= 85% of positions. Then prefill ms, the median decode step (CUDA
     events) and tokens/s at (4, 16, 8) and (32, 512, 32), with one
     step's and one prefill's device time by kernel group, idle share
     and top kernels.
  9. lm_families: LM serving for the MoE, SSM, hybrid and audio
     families at full width, params drawn on the card from --seed, each
     model built, served, checked and timed, then freed: 9a
     qwen3-moe-30b-a3b (2 of its 48 layers; 128 experts top-8 over EP
     8 on the (1, 1, 8) mesh: two engine all-to-alls per layer, KV
     replicated so the decode cache is sequence-sharded and merged by
     the flash-combine), 9b mamba2-1.3b (6 of 48 layers), 9c hymba-1.5b
     (4 of 32 layers, 25 heads padded to 26, windowed and global
     layers), 9d whisper-medium (3 of 24 encoder and 3 of 24 decoder
     layers over 1500 stub frames drawn from
     --seed, through build_prefill, convert_prefill_caches and
     build_decode_step with s_enc, as its session prefills tokens only),
     9b-9d on the (1, 4, 2) mesh, all at (4, 16, 8) with the launcher's
     moe_capacity_factor 8. Every K1 call BITWISE as it runs and
     replayed on normal values; per decode step K1 launches equal to the
     programs' count and the engine's collectives equal to the layouts'
     (`fam_step_collectives`); tokens against a single-copy forward
     through the port's own modules on the (1, 1, 1) mesh (float64;
     float32 for 9a) by phase 8's margin rule with eps = 2^-8
     sqrt(n_r), n_r counted per family (`lm_eps`); 9a's reference routes
     as the served run did (its dropped assignments reported per layer)
     and its own top-8 must equal the served choices wherever its
     8th/9th logit gap clears the margin of the roundings up to that
     layer (eps_i = `lm_eps(cfg, i + 1)`); 9b and 9c's prefill
     conv/state within 4 sqrt(2) eps_i of layer i's largest entry of the
     state teacher-forced decode reaches over the same prompt, reported
     per layer. Then the phase 8 timings per model at (4, 16, 8) and at
     a second shape whose 1024 generated tokens are held to the
     reference by the same rules: (32, 512, 32) for 9a and 9b, (32, 16,
     32) for 9c and 9d. Every SSD scan of 9b and 9c, in the serve phase
     and in that second shape's generate (9b's 512-token prefill: two
     chunks), within twice the plain version's error against the float64
     recurrence (`ssd_within`); the single-copy reference runs the plain
     scan (`fam_reference_logits`).
 10. train: qwen3-0.6b trained at full width and depth (28 layers, bf16
     params, fp32 AdamW state: 9.6 GB stacked) on `launch/train.py`'s
     (1, 4, 2) mesh (FSDP over data, TP 2), params drawn on the card from
     --seed, AdamW at lr 3e-4 under `cosine_warmup`, batches from the
     port's `SyntheticLM`, deterministic algorithms on. 10a: one step at
     (8, 64) (remat none, the queue): ce_mean within 4 sqrt(2) eps
     rms(logits) (`lm_eps`) and every synced gradient leaf within a
     relative L2 error eps_g (`train_eps`) of a single copy through the
     port's modules on the (1, 1, 1) mesh over float64 weights; the
     grads x 2, x 0.5 and one data rank's contribution each rejected by
     that bound; every K1 call BITWISE as it runs and replayed on normal
     values; the engine collectives of the forward, backward, sync and
     clip equal to the layout's (`train_layout_collectives`,
     `train_bucket_collectives`) and K1 per phase to the programs'; the
     synced replicas equal; the AdamW update within TRAIN_ADAMW_ULPS of
     the plain update on the CPU. 10b: int8 grad compression, one K2 and
     one K3 launch per compressed exchange, synced grads within the
     codec's bound of 10a's. 10c: sequence parallelism + the collective
     matmul, every K4 call within its bound, grads within eps_g of the
     reference. 10d: remat full, grads BITWISE 10a's and the forward /
     backward peak lower. 10e: the `Trainer` through `launch/train.py`'s
     code path at 4 of 28 layers (`depth_cut`; a cut for the time),
     8 steps, checkpoints every 4, a failure injected at step
     6: the ce_mean trajectory equal to an uninterrupted run's within
     1e-5. Then the median step, tokens/s, peak memory, launches, one
     step's device time by kernel group and by phase and the idle share
     at (8, 64) and (8, 512).
 11. ring_attention and dryrun: 11a the engine's `ring_attention` at
     qwen3-0.6b's attention width (16 q heads, 8 kv heads, head_dim 128,
     bf16) over prefill_32k's 32768 tokens, context-parallel over 8 ranks
     (4096 each): causal and full at segments 1, causal at segments 4,
     each within a derived bound (`ring_bound`) of a float64 exact
     attention of the same bf16 inputs computed on the card in query
     blocks and within RING_RMS_LIMIT of the rms error its bf16
     roundings give (a control with bf16 scores must break it),
     segments 4 within twice the rounding terms of segments 1, the
     trace_log entry, the peak memory (against its score tensors), and
     the median, busy time and idle share beside the port's single-copy
     `chunked_attention` over the same tokens. 11b `launch/dryrun.py`'s
     counters on 'meta' against one real step of phase 10's (8, 512)
     cell on the card, and of its SP + collective-matmul variant (K4),
     each after a warm-up step whose every K1 call is held bitwise and
     every K4 call within its bound: FLOPs equal, argument bytes equal,
     the engine's programs equal in order, K1 per phase as the meta run's
     programs imply, the meta peak within DRY_PEAK_MARGIN of the card's;
     then the production cell qwen3-0.6b train_4k on the 16 x 16 mesh on
     'meta' at 7 of 28 layers (a depth cut for the time; per-rank memory,
     fit, dominant term, host seconds). Then six more steps, once on
     'meta' and once on the card, each after a warm-up whose every K1,
     K2, K3, K5 call is held bitwise and every K4 call within its bound
     (`dry_card_cell`): (a) qwen3-0.6b's decode step at 28 layers, phase
     8's (4, 16, 8) cache; (b) a qwen3-moe-30b-a3b prefill on (1, 1, 8),
     EP 8, 2 layers (the all-to-all dispatch); (c) a mamba2-1.3b prefill
     at 9b's 6 layers; (d) whisper-medium's decode step (3 + 3 layers)
     over 1500 frames, whose encoder and cross k/v it never reads; (e)
     phase 10's (8, 64) train step with int8 buckets (K2, K3); (f) the
     DLRM forward of 32 requests on (1, 1, 8) through
     `dryrun.build_dlrm_cell` (K5, K1, K4): FLOPs, argument bytes and
     unread argument bytes equal, programs equal in order, launches as
     the meta run's entry points imply, the meta peak within the
     largest op workspace of the card's peak of requested bytes.
 12. procs: one rank per process (`core/procgroup.py`), 8 processes
     spawned on the card in one gloo group (`launch/procs.py`), every
     CUDA payload staged through pinned host memory. 12a the executor's
     grid (every GENERATORS entry at segments 1 and 4, codec None and
     int8, integer-valued and normal fp32, bf16 for the ring and
     bidi_ring allreduce) at 1 MiB per rank; 12b the 8 x --mib MiB fp32
     and int8 allreduce (the selector's pick); 12c `distributed_vecmat`
     at 4096, each process's partials reduced to rank 0; 12d phase 7b's
     mix drained BITWISE the same calls blocking. Each child's K1/K2/K3
     launches in every part equal what its rank's share of the programs
     it ran implies (`procgroup.implied_launches`); 12a and 12b are
     BITWISE the stacked executor and engine on the card (as digests),
     12c's result within gamma_K of float64 and its reduce BITWISE the
     stacked reduce of the same partials. 12e the native backend (every
     collective at 1 MiB per rank and the (2, 4) two-axis allreduce,
     `torch.distributed`'s own: BITWISE the stacked native engine and
     X.sum(0) on integer values, the sums within (n - 1) u sum|x| of
     float64 on normal ones) and `allgather_matmul` /
     `matmul_reduce_scatter` (segments 1 and 4, fp32 and bf16, K4's
     small_m32 and large_m plans: BITWISE the stacked engine, K4 n x
     segments and once per call). 12f `ring_attention` one rank per
     process (qwen3-0.6b's attention, 8192 tokens, causal and full,
     segments 1 and 4): each process's queries within `ring_bound` and
     `ring_rms` of a float64 attention of its block. 12g use case 2 at
     the full CONFIG, each process drawing its 6.4 GB table slice from
     --seed (the free memory checked first; only rows_per_table is cut
     if short): 20 batches of 32 and one of 2048 (shard-edge ids
     included) through `DLRMServer` on a `ProcessGroupEngine`, then with
     backend='native' on the same params; per batch one K5 and one K4
     launch and the K1 its programs imply, each process's concat slots
     BITWISE direct indexing of its slice and the whole vector BITWISE
     the owned rows gathered outside the engine, the logits equal on
     every process and within atol 1e-5 + rtol 1e-4 of float64; at
     reduced() size the logits BITWISE the stacked server they were
     carried from. Every K1-K5 launch of 12a-12g held against its plain
     version in the child (K4 within its bound). Per process the median
     ms, the staged bytes and ms per call, and rank 0's busy share:
     informational, host staging over gloo is no fabric.

 13. lm_procs: qwen3-0.6b one rank per process, 8 processes on the
     card in one gloo group over launch/serve.py's (1, 4, 2) mesh
     (`phase_lm_procs`). 13a serves at full width and depth, each
     process drawing its rows of the stacked init from --seed, as the
     launchers do (`ServeSession` at (4, 16, 8)): tokens by the margin
     rule against the float64 single copy of the same params, drawn in
     the parent by one stacked init. 13b one train step at (8, 64),
     FSDP 4 x TP 2, at 7 of 28 layers, and with int8 buckets and SP +
     collective_matmul at 4: rank 0's loss and every rank's ce within
     rtol 1e-5, every rank's grad norm within 1e-3 and updated params
     within 2e-4 plus one bf16 ulp of the stacked step on the same params
     and batch. 13c at 2 layers, params
     carried from a stacked init (`convert.local_params`): decode
     tokens EQUAL phase 8's stacked loop's, the train step's metrics
     within rtol 1e-5 and params within 2e-4 plus one bf16 ulp, and
     every engine collective of a decode step and a train step replayed
     on the stacked engine on the ranks' own operands, BITWISE. 13d the
     `Trainer` one rank per process at 2 layers: its checkpoint loads
     into the stacked port leaf for leaf and back into the processes bit
     for bit, and the next step from it takes the uninterrupted run's
     step bitwise. Every child holds every K1-K4
     launch against its plain version, its launches equal what its
     programs and the stacked step imply, and its collectives per step
     (the engine's trace) the stacked step's. Per process: prefill and
     decode step ms, tokens/s, train step ms, staged bytes a call, rank
     0's busy share.
 14. lm_fam_procs: in phase 13's world, after 13d (`p14_child`), full
     width, 2 layers each (a depth cut for the run's time): 14a-14e serve
     qwen3-moe-30b-a3b on (1, 1, 8), mamba2-1.3b, hymba-1.5b (layer 0
     global, 1 windowed), whisper-medium (2 + 2 layers, 1500 stub frames;
     its pieces) and internvl2-26b (256 visual prefix rows ahead of 16
     tokens; its pieces) on (1, 4, 2) at (4, 16, 8), capacity factor 8,
     each process drawing its rows of the stacked init from --seed: the
     tokens equal on every process and by the margin rule against the
     float64 (14a: float32) single copy (14a routed as the processes
     routed), the collectives of every decode step the layouts', the
     first decode step's replayed on the stacked engine BITWISE; 14f one
     train step of qwen3-moe-30b-a3b at (8, 64), routed as the stacked
     step routed each rank's tokens (`p14_routed`; a token whose own
     top-k differs must be a near-tie), int8 gradient buckets (K2/K3),
     against that step (loss and ce within 1e-5, grad norm 1e-3, params
     2e-4 plus one bf16 ulp); 14g the per-process `Trainer` on (2, 2, 2)
     of qwen3-0.6b at 2 layers with the streaming matmuls (K4), data rank 1
     dying at step 2 of 4: the processes at the dead position leave after
     the handoff, the survivors' steps, events, mesh and final checkpoint
     against the stacked `Trainer`'s shrink run (step 0 within 1e-5,
     later steps within P14_TRAJ_RTOL), K4 a step the stacked run's.
     Launches and checks as phase 13's.

Then one JSON line of the five kernels and the SSD scan with their
launches on every
path (in total and by path: collectives, dlrm, vecmat, queue, lm,
lm_families, train, dryrun, procs, procs_lm, procs_families — the
children's launches, summed),
time, plain time, bound and library time (K4 also with the tile
configuration that ran and its achieved rate; K5 also its `lookup` entry
at B = 32 and 2048, beside the device time of the sequence of PyTorch
ops and `gather_rows` it replaced, `sequence_ms`). The last line is
{"ok": true, "device": {...}}. (The SSD scan's launches are those of
phase 9's served path: it is not one of `ops.KERNELS`.) Any failure raises and exits non-zero;
without a CUDA device the script exits non-zero at once.

    python3 chip_smoke.py [--seed 0] [--mib 64] [--reps 10]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import inspect
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12      # H100 SXM data sheet, fp32 outside tensor cores
NRANKS = 8
SEG = 32768                   # elements per rank in one 128 KiB segment

REPLACES = {
    "fused_combine": "src/repro/kernels/fused_reduce.py:40",
    "quantize_blocks": "src/repro/kernels/quantize.py:38",
    "dequantize_blocks": "src/repro/kernels/quantize.py:60",
    "matmul_tiled": "src/repro/kernels/matmul.py:47",
    "gather_rows": "src/repro/kernels/embedding_gather.py:34",
    # no TPU kernel: the JAX engine's region write after a copy exchange
    "region_copy": "src/repro/core/engine.py:99",
    # no TPU kernel: the reference's SSD scan is jnp, left to XLA
    "ssd_chunked": "src/repro/models/ssm.py:76",
}
SOURCES = {
    "fused_combine": "src/repro_torch/kernels/csrc/fused_combine.cu",
    "quantize_blocks": "src/repro_torch/kernels/csrc/quantize.cu",
    "dequantize_blocks": "src/repro_torch/kernels/csrc/quantize.cu",
    "matmul_tiled": "src/repro_torch/kernels/csrc/matmul.cu",
    "gather_rows": "src/repro_torch/kernels/csrc/embedding_gather.cu",
    "region_copy": "src/repro_torch/kernels/csrc/fused_combine.cu",
    "ssd_chunked": "src/repro_torch/kernels/csrc/ssd_scan.cu",
}
#: (N, S, H, P, n, chunk): Granite-4.0-H-Small's per-card SSD prefill
#: (8 stacked ranks x one 16k prompt, 16 of 128 heads a rank)
SSD_SHAPE = (8, 16384, 16, 64, 128, 256)
DLRM_MESH = {"pod": 1, "data": 1, "model": 8}
DLRM_BATCHES, DLRM_SMALL, DLRM_LARGE = 20, 32, 2048
DLRM_HEADROOM = 10 * 2**30    # bytes the serving path needs beside the tables
DLRM_ATOL, DLRM_RTOL = 1e-5, 1e-4


#: the script's start: each phase line carries its wall seconds since
_START = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "wall_s": time.perf_counter() - _START}
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def device_time_ms(fn, n: int) -> float:
    """Device time of one call of `fn`, from `n` back-to-back calls.

    A sleep kernel holds the stream while the host enqueues the calls, so
    the events time the device work, not the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def median_ms(fn, reps: int) -> float:
    """Median time of one call on the card (the port's CUDA-event helper,
    after a warm-up call)."""
    from repro_torch.launch import median_ms as port_median_ms
    return port_median_ms(fn, reps, "cuda")


def same(name: str, got, want) -> float:
    """Fail unless bitwise equal; return the max abs difference (0)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: {tuple(got.shape)} {got.dtype} vs "
             f"{tuple(want.shape)} {want.dtype}")
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        fail(f"{name}: {bad} elements differ from the plain version")
    return float((got.double() - want.double()).abs().max())


def phase_kernels(ops, ref, gen) -> dict:
    """Phase 2: each kernel bitwise against its plain version, on the
    card, at the main path's segment shape (8 ranks x 32768)."""
    dev = "cuda"
    shape = (NRANKS, SEG)
    err = {"fused_combine": 0.0, "quantize_blocks": 0.0,
           "dequantize_blocks": 0.0}
    checked = 0
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.randn(shape, generator=gen, device=dev).to(dtype)
        b = torch.randn(shape, generator=gen, device=dev).to(dtype)
        for op in ("add", "max", "min", "mul"):
            err["fused_combine"] = max(err["fused_combine"], same(
                f"K1 {op} {dtype}", ops.fused_combine(a, b, op),
                ref.fused_combine(a, b, op)))
            checked += 1
        # fp32 -> bf16 cast output and a ragged, unaligned tail
        err["fused_combine"] = max(err["fused_combine"], same(
            f"K1 add {dtype}->bf16 tail", ops.fused_combine(
                a.reshape(-1)[1:-5], b.reshape(-1)[3:-3], "add",
                out_dtype=torch.bfloat16),
            ref.fused_combine(a.reshape(-1)[1:-5], b.reshape(-1)[3:-3],
                              "add", out_dtype=torch.bfloat16)))
        checked += 1
    # K2 on heavy-tailed values, a ragged row and exact .5 ties: a block
    # whose max is 127 * 2^e has scale 2^e, so (j + .5) * 2^e is a tie
    x = (torch.randn(shape, generator=gen, device=dev)
         * torch.exp(2 * torch.randn(shape, generator=gen, device=dev)))
    ties = torch.arange(-127, 127, device=dev, dtype=torch.float32) + 0.5
    ties = torch.cat([torch.tensor([127.0, 0.0], device=dev), ties])
    x[:, :256] = ties * 2.0 ** -3
    x[:, 256:512] = -ties * 2.0 ** 5
    for name, inp in (("fp32", x), ("bf16", x.to(torch.bfloat16)),
                      ("ragged", x[:, :SEG - 100].contiguous())):
        q, s = ops.quantize_int8(inp)
        rq, rs = ref.quantize_blocks(inp)
        err["quantize_blocks"] = max(err["quantize_blocks"],
                                     same(f"K2 codes {name}", q, rq),
                                     same(f"K2 scales {name}", s, rs))
        checked += 2
    q, s = ops.quantize_int8(x)
    odd = (q[:, 1:256].float() % 2).abs().sum()   # half-even ties land even
    if int(odd):
        fail("K2: .5 ties did not round to even")
    for dtype in (torch.float32, torch.bfloat16):
        old = torch.randn(shape, generator=gen, device=dev).to(dtype)
        for op in ("copy", "add"):
            got = ops.dequantize_int8(q, s, SEG, old=old if op != "copy"
                                      else None, op=op, out_dtype=dtype)
            want = ref.dequantize_blocks(q, s, SEG, old=old if op != "copy"
                                         else None, op=op, out_dtype=dtype)
            err["dequantize_blocks"] = max(err["dequantize_blocks"], same(
                f"K3 {op} {dtype}", got, want))
            checked += 1
    checked += phase_kernels_indexed(ops, ref, gen)
    checked += phase_codec_indexed(ops, ref, gen)
    torch.cuda.synchronize()
    emit({"phase": "kernels", "checked": checked, "bitwise": True,
          "max_abs_err": err})
    return err


@contextlib.contextmanager
def recording(ops, names, keep=(), seqs=()):
    """Record every call to the entry points `names` of ops made while the
    block runs, as (name, args, kwargs, result); for the names in `keep`
    the tensor arguments are cloned before the call and the result after
    it (else the result is None), so a replay sees what the kernel saw (an argument passed twice
    stays one tensor). For each Sequencer in `seqs`, also record every
    plan item it runs as (request ids, K1 launches of that item alone).
    The recorder itself launches nothing."""
    calls, items = [], []
    real = {name: getattr(ops, name) for name in names}
    runs = [(seq, seq._run_item) for seq in seqs]

    def recorder(name):
        def record(*args, **kwargs):
            if name not in keep:
                calls.append((name, args, kwargs, None))
                return real[name](*args, **kwargs)
            memo = {}

            def kept(v):
                if not isinstance(v, torch.Tensor):
                    return v
                if id(v) not in memo:
                    memo[id(v)] = v.clone()
                return memo[id(v)]
            kargs = tuple(kept(a) for a in args)
            kkw = {k: kept(v) for k, v in kwargs.items() if k != "out"}
            res = real[name](*args, **kwargs)
            calls.append((name, kargs, kkw, res.clone()))
            return res
        return record

    def item_recorder(run):
        def run_item(item):
            k0, n0 = ops.launch_counts()["fused_combine"], len(items)
            run(item)
            inner = sum(k for _rids, k in items[n0:])   # nested dep items
            items.append(([r.rid for r in item.requests],
                          ops.launch_counts()["fused_combine"] - k0 - inner))
        return run_item

    for name in names:
        setattr(ops, name, recorder(name))
    for seq, run in runs:
        seq._run_item = item_recorder(run)
    try:
        yield calls, items
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)
        for seq, _run in runs:
            del seq._run_item


def recorded_calls(ops, names, shape, **kw) -> list:
    """(name, args, kwargs, None) of every call to the entry points
    `names` of ops that one allreduce of a `shape` buffer (`kw` passed
    on) makes on the card."""
    from repro_torch.core import CollectiveEngine
    with recording(ops, names) as (calls, _items):
        CollectiveEngine({"x": NRANKS}, device="cuda").allreduce(
            torch.zeros(shape, device="cuda"), "x", **kw)
    return calls


K1_ARGS = ("a", "a_index", "b", "b_index", "op", "out_dtype", "in_place")


def k1_args(entry, args, kwargs) -> tuple:
    """(a, a_index, b, b_index, op, out_dtype, in_place) of a call to
    `entry`, K1's indexed entry point (`ops.fused_combine_at`)."""
    p = inspect.signature(entry).bind(*args, **kwargs)
    p.apply_defaults()
    return tuple(p.arguments[k] for k in K1_ARGS)


def k1_run(fn, a, ai, b, bi, op, od, ip):
    """K1 (`fn`: the kernel's entry or its plain version) on the operands,
    left as they are: an in-place call (`ip`) runs on a clone of a (b
    aliasing a stays aliased) and gives the whole buffer it wrote."""
    if not ip:
        return fn(a, ai, b, bi, op, od)
    c = a.clone()
    return fn(c, ai, c if b is a else b, bi, op, od, in_place=True)


def replay_k1(ops, ref, calls, gen, where: str) -> int:
    """Each recorded K1 call of a path BITWISE against K1's plain version:
    the path's own result on the operands it was given (an in-place
    call's: the whole buffer it wrote), and K1 again through the same
    region indices, in place or not as the path called it, on
    normal-valued operands of the same shapes (a path's own operands may
    be integer-valued, where every sum is exact in any order and
    precision)."""
    for i, (_n, args, kw, res) in enumerate(calls):
        a, ai, b, bi, op, od, ip = k1_args(ops.fused_combine_at, args, kw)
        same(f"{where}: K1 call {i} ({op}) on the path's operands", res,
             k1_run(ref.fused_combine_at, a, ai, b, bi, op, od, ip))
        na = torch.randn(a.shape, generator=gen, device=a.device).to(a.dtype)
        nb = na if b is a else torch.randn(
            b.shape, generator=gen, device=b.device).to(b.dtype)
        same(f"{where}: K1 call {i} ({op}) on normal values",
             k1_run(ops.fused_combine_at, na, ai, nb, bi, op, od, ip),
             k1_run(ref.fused_combine_at, na, ai, nb, bi, op, od, ip))
    return len(calls)


def exchange_indices(ops, shape, algorithm: str, segments: int) -> list:
    """(target index, payload index) of every indexed K1 call (one a
    combining exchange) one fp32 allreduce of a `shape` buffer makes on
    the card."""
    return [(a[1], a[3]) for _n, a, _kw, _r in recorded_calls(
        ops, ("fused_combine_at",), shape, algorithm=algorithm,
        segments=segments)]


def codec_exchange_indices(ops, shape, **kw) -> list:
    """(target index, payload index) of every compressed exchange of one
    int8 allreduce of a `shape` buffer on the card: the index its K2 call
    reads the payload through, and its K3 call the target."""
    calls = recorded_calls(ops, ("quantize_int8_at", "dequantize_int8_at"),
                           shape, compression="int8", **kw)
    if [c[0] for c in calls] != ["quantize_int8_at",
                                  "dequantize_int8_at"] * (len(calls) // 2):
        fail(f"int8 allreduce of {shape}: indexed K2/K3 calls do not pair")
    return [(dq[1][4], q[1][1]) for q, dq in zip(calls[::2], calls[1::2])]


def phase_kernels_indexed(ops, ref, gen) -> int:
    """K1's indexed entry point BITWISE against its plain version on the
    region indices of real ring exchanges, every segment of an exchange in
    one launch: 16-byte units (8 x 32768 and 8 x 1024 per segment) and
    unaligned ones (15 elements), 1 and 32 segments."""
    dev = "cuda"
    checked = 0
    for shape, k in (((NRANKS, NRANKS * SEG), 1),
                     ((NRANKS, NRANKS * 32 * 1024), 32),
                     ((NRANKS, NRANKS * 15), 1),
                     ((NRANKS, NRANKS * 32 * 15), 32)):
        calls = exchange_indices(ops, shape, "ring", k)
        tgt, pay = calls[0]
        if tgt[2].shape[0] != k:
            fail(f"K1 indexed: a ring exchange of {shape} has "
                 f"{tgt[2].shape[0]} segments, not {k}")
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.randn(shape, generator=gen, device=dev).to(dtype)
            b = torch.randn(shape, generator=gen, device=dev).to(dtype)
            for op in ("add", "max", "min", "mul"):
                same(f"K1 indexed {op} {dtype} {shape} k={k}",
                     ops.fused_combine_at(a, tgt, b, pay, op),
                     ref.fused_combine_at(a, tgt, b, pay, op))
                checked += 1
            same(f"K1 indexed add {dtype}->bf16 {shape}",
                 ops.fused_combine_at(a, tgt, b, pay, "add",
                                      out_dtype=torch.bfloat16),
                 ref.fused_combine_at(a, tgt, b, pay, "add",
                                      torch.bfloat16))
            checked += 1
    return checked


def phase_codec_indexed(ops, ref, gen) -> int:
    """K2's and K3's indexed entry points (a whole exchange per launch,
    operands read in place) BITWISE against their plain versions on the
    region indices of real int8 ring exchanges: 16-byte units at 1 and 32
    segments, a ragged last block (1000 elements) and unaligned units
    (15 elements, one block short); heavy-tailed values with exact .5
    ties in every other block; every consume op, fp32 and bf16."""
    dev = "cuda"
    checked = 0
    ties = torch.arange(-127, 127, device=dev, dtype=torch.float32) + 0.5
    ties = torch.cat([torch.tensor([127.0, 0.0], device=dev), ties])
    for shape, k in (((NRANKS, NRANKS * SEG), 1),
                     ((NRANKS, NRANKS * 32 * 1024), 32),
                     ((NRANKS, NRANKS * 1000), 1),
                     ((NRANKS, NRANKS * 15), 1)):
        tgt, pay = codec_exchange_indices(ops, shape, algorithm="ring",
                                          segments=k)[0]
        if pay[2].shape[0] != k:
            fail(f"K2/K3 indexed: an int8 ring exchange of {shape} has "
                 f"{pay[2].shape[0]} segments, not {k}")
        n = pay[2].shape[2] * pay[0]
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(shape, generator=gen, device=dev)
                 * torch.exp(2 * torch.randn(shape, generator=gen,
                                             device=dev)))
            if shape[1] % 256 == 0:   # block max 127 * 2^-3: scale 2^-3
                x.view(NRANKS, -1, 256)[:, ::2] = ties * 2.0 ** -3
            x = x.to(dtype)
            old = torch.randn(shape, generator=gen, device=dev).to(dtype)
            q, s = ops.quantize_int8_at(x, pay)
            rq, rs = ref.quantize_blocks_at(x, pay)
            same(f"K2 indexed codes {dtype} {shape} k={k}", q, rq)
            same(f"K2 indexed scales {dtype} {shape} k={k}", s, rs)
            checked += 2
            for op in ("copy", "add", "max", "min", "mul"):
                same(f"K3 indexed {op} {dtype} {shape} k={k}",
                     ops.dequantize_int8_at(q, s, n, old, tgt, op),
                     ref.dequantize_blocks_at(q, s, n, old, tgt, op))
                checked += 1
    return checked


def phase_main_exchanges(CollectiveEngine, ops, ref, gen, L: int) -> dict:
    """Phase 2c: every call the main path's allreduce (bidi_ring x 32, the
    selector's pick at 8 x 64 MiB) makes to K1's in-place entry and to the
    indexed copy, held BITWISE against the plain version as it runs
    (`proc_checked`: the plain version writes a clone first), on normal
    values, fp32 and bf16: at 8 x `L` (16-byte units, the vector path)
    and at 8 x 7680 (15-element units, the scalar path); 14 K1 calls and
    14 copies each, every exchange written in place; the result equal to
    the same allreduce on the CPU (the plain versions)."""
    eng = CollectiveEngine({"x": NRANKS}, device="cuda")
    cpu = CollectiveEngine({"x": NRANKS}, device="cpu")
    cases = {}
    for width, vec in ((L, True), (2 * NRANKS * 32 * 15, False)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((NRANKS, width), generator=gen,
                            device="cuda").to(dtype)
            checked = dict.fromkeys(ops.KERNELS, 0)
            with proc_checked(ops, ref, checked, on_fail=fail), \
                    recording(ops, ("fused_combine_at",)) as (calls, _i):
                got = eng.allreduce(x, "x", algorithm="bidi_ring",
                                    segments=32)
                torch.cuda.synchronize()
            name = f"2c: bidi_ring x 32 allreduce of 8 x {width} {dtype}"
            if (checked["fused_combine"], checked["region_copy"]) != (14, 14):
                fail(f"{name}: {checked['fused_combine']} K1 calls and "
                     f"{checked['region_copy']} copies held, not 14 and 14")
            if not all(kw.get("in_place") for _n, _a, kw, _r in calls):
                fail(f"{name}: an exchange was not written in place")
            unit_bytes = int(calls[0][1][1][0]) * x.element_size()
            if (unit_bytes % 16 == 0) != vec:
                fail(f"{name}: {unit_bytes}-byte units, vectors expected "
                     f"{vec}")
            if width <= 2**20:
                same(name, got.cpu(), cpu.allreduce(
                    x.cpu(), "x", algorithm="bidi_ring", segments=32))
            cases[f"{width}/{str(dtype).split('.')[-1]}"] = {
                "k1_held": checked["fused_combine"],
                "copies_held": checked["region_copy"],
                "unit_bytes": unit_bytes, "vec16": vec}
            del x, got
    torch.cuda.empty_cache()
    emit({"phase": "main_exchanges", "bitwise": True, "in_place": True,
          "cases": cases})
    return cases


def int_inputs(shape, gen, device="cuda"):
    """Integer-valued fp32 in [-8, 8]: every sum over 8 ranks is exact."""
    return torch.randint(-8, 9, shape, generator=gen, device=device,
                         dtype=torch.int32).float()


def phase_main_fp32(CollectiveEngine, X, counts, ops) -> dict:
    """Phase 3: the fp32 collectives, bitwise against torch oracles."""
    eng = CollectiveEngine({"x": NRANKS}, device="cuda")
    L = X.shape[1]
    total = X.sum(0)
    runs = {}

    def run(name, fn, check):
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts[name] = ops.launch_counts()
        check(out)
        runs[name] = fn

    run("allreduce", lambda: eng.allreduce(X, "x"),
        lambda out: same("allreduce", out, total.expand_as(X)))
    run("reduce_scatter", lambda: eng.reduce_scatter(X, "x"),
        lambda out: same("reduce_scatter", out, total.reshape(NRANKS, -1)))
    run("allgather", lambda: eng.allgather(X, "x"),
        lambda out: same("allgather", out,
                         X.reshape(1, -1).expand(NRANKS, -1)))
    run("bcast", lambda: eng.bcast(X, "x", root=3),
        lambda out: same("bcast", out, X[3:4].expand_as(X)))
    A = X.reshape(NRANKS, 4096, L // 4096)
    run("alltoall", lambda: eng.alltoall(A, "x"),
        lambda out: same("alltoall", out, A.reshape(
            NRANKS, NRANKS, -1, A.shape[2]).transpose(0, 1).reshape(A.shape)))
    eng2 = CollectiveEngine({"pod": 2, "data": 4}, device="cuda")
    X2 = X.reshape(2, 4, L)
    run("allreduce_2x4", lambda: eng2.allreduce(X2, ("pod", "data")),
        lambda out: same("allreduce_2x4", out, total.expand_as(X2)))
    picks = [list(map(str, t)) for t in eng.trace_log + eng2.trace_log]
    sched = eng.selector.choose("allreduce", L * 4, eng.comm("x"))
    emit({"phase": "main_fp32", "ranks": NRANKS, "mib_per_rank": L * 4 / 2**20,
          "bitwise": True, "allreduce_pick": [sched.algorithm, sched.segments],
          "picks": picks, "launches": counts})
    return runs


def phase_main_int8(CollectiveEngine, X, counts, ops, gen) -> dict:
    """Phase 4: int8 allreduce within the codec bound of the oracle, and
    bitwise equal to the CPU run of the plain versions at 4 MiB/rank."""
    eng = CollectiveEngine({"x": NRANKS}, device="cuda")
    exchanges = []
    real_q = ops.quantize_int8_at

    def count_exchange(src, index):      # launches nothing itself
        exchanges.append(int(index[2].shape[0]))
        return real_q(src, index)

    ops.quantize_int8_at = count_exchange
    try:
        ops.reset_launch_counts()
        out = eng.allreduce(X, "x", compression="int8")
        torch.cuda.synchronize()
        counts["allreduce_int8"] = c = ops.launch_counts()
    finally:
        ops.quantize_int8_at = real_q
    # one K2 and one K3 launch per compressed exchange, none per segment
    if not exchanges or not (c["quantize_blocks"] == c["dequantize_blocks"]
                             == len(exchanges)):
        fail(f"int8 allreduce: {c} launches for {len(exchanges)} "
             f"compressed exchanges")
    # Each of the n-1 compressed reduce-scatter hops quantizes a partial
    # sum of magnitude <= M = max_i sum_r |x_r[i]| with a block scale
    # <= M/127, so it errs by <= M/254; fp32 rounding adds <= M * 2^-23
    # per hop. Copies in the allgather phase are exact.
    M = float(X.abs().sum(0).max())
    bound = (NRANKS - 1) * M * (1.0 / 254.0 + 2.0 ** -23)
    err = float((out - X.sum(0)).abs().max())
    if not err <= bound:
        fail(f"int8 allreduce error {err} exceeds its bound {bound}")
    small = int_inputs((NRANKS, 2**20), gen)    # 4 MiB per rank
    gpu = eng.allreduce(small, "x", compression="int8")
    cpu_eng = CollectiveEngine({"x": NRANKS}, device="cpu")
    cpu = cpu_eng.allreduce(small.cpu(), "x", compression="int8")
    same("int8 allreduce card vs cpu", gpu.cpu(), cpu)
    emit({"phase": "main_int8", "max_abs_err": err, "bound": bound,
          "bitwise_vs_cpu_at_mib_per_rank": 4, "launches":
          counts["allreduce_int8"], "compressed_exchanges": len(exchanges),
          "segments_per_exchange": sorted(set(exchanges))})
    return {"allreduce_int8": lambda: eng.allreduce(X, "x",
                                                    compression="int8")}


_KERNEL_GROUPS = (("fused_combine_kernel", "K1 fused_combine"),
                  ("dequantize_kernel", "K3 dequantize_blocks"),
                  ("quantize_kernel", "K2 quantize_blocks"),
                  ("index", "gather/scatter (indexing)"))


def device_split(fn, groups, top: int = 0) -> dict:
    """Device time of one call of `fn` by kernel group (torch.profiler):
    the first (pattern, group) whose pattern the kernel's name holds;
    with `top`, also the `top` kernels that took the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, 4):  # now and then a trace holds no device event
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        split: dict = {}
        kernels = 0
        names = []
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0.0)
            key = next((g for pat, g in groups if pat in ev.key), "other")
            split[key] = split.get(key, 0.0) + us / 1e3
            kernels += ev.count
            names.append((us / 1e3, ev.count, ev.key[:90]))
        if kernels:
            break
    out = {"device_ms_by_group": split, "kernel_launches": kernels,
           "traces": attempt}
    if top:
        out["top_kernels"] = sorted(names, reverse=True)[:top]
    return out


def busy_and_idle(split: dict, median_ms: float) -> dict:
    busy = sum(split["device_ms_by_group"].values())
    seen = split["kernel_launches"] > 0
    return {"device_busy_ms": busy if seen else None, "median_ms": median_ms,
            "idle_share": (1.0 - busy / median_ms) if seen else None, **split}


def kernel_rows(ref, fr, qz, ops, X, gen, err) -> list:
    """Phase 5b: per-kernel device time at the main path's segment shape,
    cycling through 128 MiB of operands so each launch reads cold HBM;
    K1's, K2's and K3's indexed entry points, one launch per exchange:
    K1 in place as the main path runs it (`exchange_ms`; into a fresh
    tensor: `exchange_out_ms`), cycling through the 14 combine exchanges
    (32 segments each) of a bidi_ring allreduce of the stacked X
    (8 x 64 MiB), the indexed copy (its own row, a whole exchange a
    launch) through the same allreduce's 14 copy exchanges, K2 and K3
    through the compressed exchanges of the int8 allreduce of X, each
    reading its own 32 MiB region. The in-place writes go to a copy of
    X, which stays as it was."""
    dev = "cuda"
    pool = 64
    a = torch.randn((pool, NRANKS, SEG), generator=gen, device=dev)
    b = torch.randn((pool, NRANKS, SEG), generator=gen, device=dev)
    qs = [qz.quantize_blocks(b[i]) for i in range(pool)]
    it = {"i": 0}

    def cyc():
        it["i"] = (it["i"] + 1) % pool
        return it["i"]

    n = 400
    el = NRANKS * SEG
    nb = el // 256
    rows = []

    def row(name, fn, plain, library, nbytes):
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "max_abs_err": err[name],
            "ms": device_time_ms(fn, n),
            "plain_ms": device_time_ms(plain, n // 4),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": (device_time_ms(library, n)
                           if library is not None else None),
            "shape": [NRANKS, SEG]})

    def k1():
        i = cyc()
        fr.fused_combine(a[i], b[i], "add", out=a[i])

    def k1_plain():
        i = cyc()
        ref.fused_combine(a[i], b[i], "add")

    def k1_lib():
        i = cyc()
        torch.add(a[i], b[i], out=a[i])

    row("fused_combine", k1, k1_plain, k1_lib, 3 * 4 * el)
    # bidi_ring x 32: 2 x 8 chunks of 32 segments, 8 x 32768 at 64 MiB;
    # one launch an exchange covers its 32 segments
    rec = recorded_calls(ops, ("fused_combine_at", "region_copy"), X.shape,
                         algorithm="bidi_ring", segments=32)
    calls = [(a[1], a[3]) for nm, a, _kw, _r in rec
             if nm == "fused_combine_at"]
    copies = [(a[1], a[3]) for nm, a, _kw, _r in rec
              if nm == "region_copy"]                 # (payload, target)
    seg = X.shape[1] // (NRANKS * 64)
    ex_out = torch.empty((32, NRANKS, seg), device=dev)
    unit, _rows, units = calls[0][0]
    if tuple(units.shape[:2]) != (32, NRANKS) or \
            units.shape[2] * unit != seg or (len(calls), len(copies)) != \
            (14, 14):
        fail(f"K1 indexed: bidi_ring exchanges of {tuple(X.shape)} are not "
             f"14 combines and 14 copies of 32 x {NRANKS} x {seg}")
    Xw = X.clone()
    at = {"i": 0}

    def ex(pairs):
        at["i"] = (at["i"] + 1) % len(pairs)
        return pairs[at["i"]]

    def k1_at():
        tgt, pay = ex(calls)
        fr.fused_combine_at(Xw, tgt, Xw, pay, "add", in_place=True)

    def k1_at_out():
        tgt, pay = ex(calls)
        fr.fused_combine_at(X, tgt, X, pay, "add", out=ex_out)

    def copy_at(fn):
        pay, tgt = ex(copies)
        fn(Xw, pay, Xw, tgt)

    elems = ex_out.numel()
    rows[-1]["exchange_ms"] = device_time_ms(k1_at, n)
    rows[-1]["exchange_out_ms"] = device_time_ms(k1_at_out, n)
    rows[-1]["exchange_bound_ms"] = 3 * elems * 4 / HBM_BYTES_PER_S * 1e3
    rows[-1]["indexed_exchanges"] = len(calls)
    rows.append({
        "name": "region_copy", "route": "cuda",
        "source": SOURCES["region_copy"],
        "replaces": REPLACES["region_copy"], "max_abs_err": 0.0,
        "ms": device_time_ms(lambda: copy_at(fr.region_copy), n),
        "plain_ms": device_time_ms(lambda: copy_at(ref.region_copy), n // 4),
        "bound_ms": 2 * elems * 4 / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None,
        "library_why": "no library call copies region to region through "
                       "two indices; the plain version is aten's gather "
                       "and index_put_, the path it replaced",
        "shape": [32, NRANKS, seg], "indexed_exchanges": len(copies)})
    del Xw
    row("quantize_blocks", lambda: qz.quantize_blocks(b[cyc()]),
        lambda: ref.quantize_blocks(b[cyc()]), None,
        4 * el + el + 4 * nb)

    def k3():
        i = cyc()
        q, s = qs[i]
        qz.dequantize_blocks(q, s, SEG, old=a[i], op="add", out=a[i])

    def k3_plain():
        i = cyc()
        q, s = qs[i]
        ref.dequantize_blocks(q, s, SEG, old=a[i], op="add")

    row("dequantize_blocks", k3, k3_plain, None, el + 4 * nb + 2 * 4 * el)
    exchange_rows(rows, ref, qz, ops, X, gen, err)
    return rows


def ssd_row(ops, ref, ssd, gen) -> dict:
    """Phase 5b's SSD scan row at SSD_SHAPE, x, B and C in bf16 as the
    Granite cell runs them (dt log-uniform over [1e-3, 0.1], a over
    [-16, -1]: Mamba2's init ranges): the entry point's y and final
    state within twice the plain version's error against the float64
    recurrence (`ssd_within`), then its device time (`ms`) beside the
    plain version's and the bound: the larger of the bytes the scan
    needs over HBM and its causal products over fp32's peak
    (`ssd.needs`)."""
    N, S, H, P, n, chunk = SSD_SHAPE
    dev = "cuda"

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=gen,
                           device=dev).to(torch.bfloat16)

    dt = torch.exp(math.log(1e-3) + rand(N, S, H) * math.log(100.0))
    args = (randn(N, S, H, P), dt, -(1 + 15 * rand(N, H)), randn(N, S, n),
            randn(N, S, n))
    launches = ssd.ssd_chunked.launches
    res = ops.ssd_chunked(*args, chunk)
    if ssd.ssd_chunked.launches != launches + ssd.LAUNCHES:
        fail("SSD scan at Granite's shape: the kernel did not launch")
    ratio = ssd_within("SSD scan at Granite's shape", res,
                       ref.ssd_chunked(*args, chunk),
                       ref.ssd_recurrence(*args))
    del res
    torch.cuda.empty_cache()
    nbytes, flops = ssd.needs(N, S, H, P, n, chunk, 2)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return {
        "name": "ssd_chunked", "route": "cuda",
        "source": SOURCES["ssd_chunked"],
        "replaces": REPLACES["ssd_chunked"], "err_over_plain": ratio,
        "ms": device_time_ms(lambda: ops.ssd_chunked(*args, chunk), 20),
        "plain_ms": device_time_ms(lambda: ref.ssd_chunked(*args, chunk),
                                   3),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "operations" if t_ops > t_bytes else "bytes",
        "library_ms": None,
        "library_why": "no PyTorch call computes a chunked state-space "
                       "scan; the plain version is the einsum scan it "
                       "replaced",
        "shape": dict(zip(("N", "S", "H", "P", "n", "chunk"), SSD_SHAPE)),
        "dtype": "bfloat16"}


def check_exchanges(ref, qz, X, ex, seg, gen, err) -> int:
    """K2's and K3's indexed entry points BITWISE against their plain
    versions at the main path's exchange shape, on its own indices: every
    compressed exchange of the int8 allreduce of X (codes, scales, K3
    fp32 add into X's target region); on the first, heavy-tailed fp32
    and bf16 values and every consume op."""
    checked = 0
    for i, (tgt, pay) in enumerate(ex):
        q, s = qz.quantize_blocks_at(X, pay)
        rq, rs = ref.quantize_blocks_at(X, pay)
        err["quantize_blocks"] = max(
            err["quantize_blocks"], same(f"K2 exchange {i} codes", q, rq),
            same(f"K2 exchange {i} scales", s, rs))
        err["dequantize_blocks"] = max(err["dequantize_blocks"], same(
            f"K3 exchange {i} add",
            qz.dequantize_blocks_at(q, s, seg, X, tgt, "add"),
            ref.dequantize_blocks_at(q, s, seg, X, tgt, "add")))
        checked += 3
        del q, s, rq, rs
    tgt, pay = ex[0]
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn(X.shape, generator=gen, device="cuda")
             * torch.exp(2 * torch.randn(X.shape, generator=gen,
                                         device="cuda"))).to(dtype)
        q, s = qz.quantize_blocks_at(x, pay)
        rq, rs = ref.quantize_blocks_at(x, pay)
        same(f"K2 exchange 0 codes {dtype}", q, rq)
        same(f"K2 exchange 0 scales {dtype}", s, rs)
        for op in ("copy", "add", "max", "min", "mul"):
            same(f"K3 exchange 0 {op} {dtype}",
                 qz.dequantize_blocks_at(q, s, seg, x, tgt, op),
                 ref.dequantize_blocks_at(q, s, seg, x, tgt, op))
        checked += 7
        del x, q, s, rq, rs
    torch.cuda.synchronize()
    return checked


def exchange_rows(rows, ref, qz, ops, X, gen, err) -> None:
    """K2's and K3's indexed entry points, one launch per exchange, on the
    compressed exchanges of the int8 allreduce of X: first each BITWISE
    against its plain version there (`check_exchanges`), then cycling
    through them for `exchange_ms` beside `exchange_bound_ms` on the K2
    and K3 rows, and a line with the time of k per-segment launches
    against one."""
    ex = codec_exchange_indices(ops, X.shape)
    _unit, _rows, units = ex[0][1]
    k, ranks, upk = units.shape
    if any(tuple(p[2].shape) != (k, ranks, upk) or p[0] != _unit
           for _t, p in ex):
        fail("int8 allreduce: compressed exchanges of unequal shapes")
    seg = upk * _unit
    elems = k * ranks * seg
    checked = check_exchanges(ref, qz, X, ex, seg, gen, err)
    wires = [qz.quantize_blocks_at(X, pay) for _t, pay in ex]
    out = torch.empty((k, ranks, seg), device="cuda")
    it = {"i": 0}

    def cyc():
        it["i"] = (it["i"] + 1) % len(ex)
        return it["i"]

    def k2():
        qz.quantize_blocks_at(X, ex[cyc()][1])

    def k3():
        i = cyc()
        q, s = wires[i]
        qz.dequantize_blocks_at(q, s, seg, X, ex[i][0], "add", out=out)

    n = 4 * len(ex)
    index_bytes = 8 * (ranks + units.numel())
    scale_bytes = 4 * elems // 256
    bytes_of = {"quantize_blocks": 4 * elems + elems + scale_bytes,
                "dequantize_blocks": elems + scale_bytes + 2 * 4 * elems}
    line = {"phase": "exchange_vs_segments", "exchanges": len(ex),
            "segments_per_exchange": k, "shape": [k, ranks, seg],
            "bitwise_checked": checked}
    for row in rows:
        fn = {"quantize_blocks": k2, "dequantize_blocks": k3}.get(row["name"])
        if fn is None:
            continue
        row["exchange_ms"] = device_time_ms(fn, n)
        row["exchange_bound_ms"] = ((bytes_of[row["name"]] + index_bytes)
                                    / HBM_BYTES_PER_S * 1e3)
        row["exchange_elems"] = elems
        row["exchanges"] = len(ex)
        line[row["name"]] = {
            "segment_ms": row["ms"], "segments_ms": k * row["ms"],
            "exchange_ms": row["exchange_ms"],
            "segments_over_exchange": k * row["ms"] / row["exchange_ms"]}
    emit(line)


# --------------------------------------------------------------------------
# Phase 6: distributed DLRM inference at the full CONFIG width
# --------------------------------------------------------------------------

_CUBLAS = "cuBLAS (FC2/FC3/head)"
_DLRM_GROUPS = (("k5_rows_kernel", "K5 gather_rows"),
                ("matmul_tiled_kernel", "K4 matmul_tiled"),
                ("fused_combine_kernel", "K1 fused_combine"),
                ("gemm", _CUBLAS), ("xmma", _CUBLAS), ("cutlass", _CUBLAS),
                ("index", "gather/scatter (indexing)"))


def dlrm_config(CONFIG):
    """CONFIG, with rows_per_table cut only if the card's free memory is
    short of the tables plus the serving path's headroom."""
    free, total = torch.cuda.mem_get_info()
    per_row = CONFIG.n_tables * CONFIG.emb_dim * 4
    tp = DLRM_MESH["model"]
    rows = CONFIG.rows_per_table
    if rows * per_row > free - DLRM_HEADROOM:
        rows = max(tp, (free - DLRM_HEADROOM) // per_row // tp * tp)
    return dataclasses.replace(CONFIG, rows_per_table=rows), free, total


def phase_dlrm_build(DLRMServer, CONFIG, seed: int):
    """Phase 6a: the model's params drawn on the card from the seed."""
    cfg, free0, total = dlrm_config(CONFIG)
    t0 = time.perf_counter()
    server = DLRMServer(cfg, mesh_shape=DLRM_MESH, device="cuda", seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    free1, _ = torch.cuda.mem_get_info()
    tables = server.model.tables
    emit({"phase": "dlrm_build", "config": dataclasses.asdict(cfg),
          "rows_per_table_cut": (None if cfg == CONFIG
                                 else [CONFIG.rows_per_table,
                                       cfg.rows_per_table]),
          "mesh": DLRM_MESH, "collective_matmul": server.pcfg.collective_matmul,
          "stacked_tables": list(tables.shape),
          "table_bytes": tables.numel() * tables.element_size(),
          "mem_free_before": free0, "mem_free_after": free1,
          "mem_total": total, "init_seconds": init_s})
    return server


def fc1_operands(server):
    """FC1's stacked weight, (8, concat/8, fc_dims[0])."""
    w = server.model.fc0_w
    return w.reshape((-1,) + tuple(w.shape[-2:]))


def stacked_tables(server):
    """Every table of every rank, (8 * n_tables, rows_local, dim)."""
    t = server.model.tables
    return t.reshape((-1,) + tuple(t.shape[-2:]))


def lookup_ids(server, dlrm_mod, B, gen, edges=False):
    """(G, B, n_tables) ids as the path gives them to K5: one batch of
    uniform requests, a stride-0 view over the ranks (`stack_batch`).
    With `edges`, its first ids are each rank's shard edges (lo - 1, lo,
    lo + rows_l - 1, lo + rows_l), the first and last rows, -1, one past
    the last row and the int32 extremes."""
    cfg = server.cfg
    req = torch.randint(0, cfg.rows_per_table, (B, cfg.n_tables),
                        generator=gen, device="cuda", dtype=torch.int32)
    tables, lo = dlrm_mod.lookup_operands(server.model.tables,
                                          server.ctx)
    if edges:
        rows_l = tables.shape[2]
        e = [x for m in lo.tolist() for x in (m - 1, m, m + rows_l - 1,
                                              m + rows_l)]
        e += [0, cfg.rows_per_table - 1, -1, cfg.rows_per_table,
              -2**31, 2**31 - 1]
        req.view(-1)[:len(e)] = torch.tensor(e, dtype=torch.int32,
                                             device="cuda")
    G = tables.shape[0]
    return dlrm_mod.stack_batch(req, server.mesh_shape).reshape(
        (G, B, cfg.n_tables))


def phase_dlrm_kernels(server, dlrm_mod, ops, ref, gen) -> dict:
    """Phase 6b: K4 at the FC1 shapes within its per-element bound of the
    plain version (fp32 sums in two orders differ by at most
    2 K 2^-24 (|x| @ |w|)); K5 at the lookup shapes bitwise: `gather_rows`
    on the stacked tables, `lookup_rows` on the server's own tables with
    the mesh's `lo`, stride-0 ids with every shard edge."""
    w = fc1_operands(server)
    tables = stacked_tables(server)
    G, rows_l, _dim = tables.shape
    ltables, lo = dlrm_mod.lookup_operands(server.model.tables,
                                           server.ctx)
    err = {"matmul_tiled": 0.0, "gather_rows": 0.0}
    hits = {}
    for B in (DLRM_SMALL, DLRM_LARGE):
        x = torch.randn((w.shape[0], B, w.shape[1]), generator=gen,
                        device="cuda") * 0.01
        got, want = ops.matmul(x, w), ref.matmul(x, w)
        bound = 2 * w.shape[1] * 2.0 ** -24 * (x.double().abs()
                                                @ w.double().abs())
        diff = (got.double() - want.double()).abs()
        if not bool((diff <= bound).all()):
            fail(f"K4 at B={B}: {int((diff > bound).sum())} elements "
                 f"exceed the per-element bound")
        err["matmul_tiled"] = max(err["matmul_tiled"], float(diff.max()))
        idx = torch.randint(0, rows_l, (G, B), generator=gen, device="cuda",
                            dtype=torch.int32)
        err["gather_rows"] = max(err["gather_rows"], same(
            f"K5 B={B}", ops.embedding_gather(tables, idx),
            ref.gather_rows(tables, idx)))
        ids = lookup_ids(server, dlrm_mod, B, gen, edges=True)
        if ids.stride()[0] != 0:
            fail("K5 lookup: the path's ids are not a stride-0 view")
        want = ref.lookup_rows(ltables, ids, lo)
        err["gather_rows"] = max(err["gather_rows"], same(
            f"K5 lookup B={B}", ops.embedding_lookup_rows(ltables, ids, lo),
            want))
        hits[B] = lookup_hits(ids, lo, ltables.shape[2])
        # every id in [0, rows_per_table) hits one rank; 6 edge ids do not
        if hits[B] != B * ids.shape[2] - 6:
            fail(f"K5 lookup B={B}: {hits[B]} hits for {B} x "
                 f"{ids.shape[2]} ids")
        del x, got, want, diff, bound, idx, ids
    torch.cuda.synchronize()
    emit({"phase": "dlrm_kernels", "k4": "within 2 K 2^-24 (|x| @ |w|)",
          "k5": "bitwise (gather_rows, lookup_rows)",
          "batches": [DLRM_SMALL, DLRM_LARGE], "lookup_hits": hits,
          "lookup_lo": lo.tolist(), "max_abs_err": err})
    return err


def lookup_hits(ids, lo, rows_l: int) -> int:
    """(g, b, t) entries whose id lies in rank g's rows (int32 shift)."""
    local = ids - lo.to(torch.int32)[:, None, None]
    return int(((local >= 0) & (local < rows_l)).sum())


def phase_dlrm_serve(server, dlrm_mod, ops, counts, seed: int):
    """Phase 6c: 20 batches of 32 requests and one of 2048 through the
    server; each must launch K4 and K1, and K5 once; concat vector
    bitwise, logits within DLRM_ATOL + DLRM_RTOL |ref| of the float64
    reference."""
    cfg = server.cfg
    g = torch.Generator(device="cuda").manual_seed(seed + 1)

    def requests(B):
        return torch.randint(0, cfg.rows_per_table, (B, cfg.n_tables),
                             generator=g, device="cuda", dtype=torch.int32)

    small = [requests(DLRM_SMALL) for _ in range(DLRM_BATCHES)]
    large = requests(DLRM_LARGE)
    seen: dict = {}
    err = scale = 0.0
    for batch in small + [large]:
        key = f"dlrm_b{batch.shape[0]}"
        ops.reset_launch_counts()
        out = server(batch)
        torch.cuda.synchronize()
        c = ops.launch_counts()
        for name in ("gather_rows", "matmul_tiled", "fused_combine"):
            if c[name] < 1:
                fail(f"a DLRM batch of {batch.shape[0]} launched no {name}")
        if c["gather_rows"] != 1:
            fail(f"a DLRM batch of {batch.shape[0]} launched K5 "
                 f"{c['gather_rows']} times, not once")
        acc = counts.setdefault(key, dict.fromkeys(c, 0))
        for name, n in c.items():
            acc[name] += n
        seen.setdefault(key, [])
        if c not in seen[key]:
            seen[key].append(c)
        # checks, outside the counted window
        if out.shape != (batch.shape[0], cfg.out_dim) or \
                not bool(torch.isfinite(out).all()):
            fail(f"DLRM logits of shape {tuple(out.shape)} or not finite")
        with torch.inference_mode():
            vec = dlrm_mod.embedding_lookup(
                server.model.tables,
                dlrm_mod.stack_batch(batch, server.mesh_shape), server.ctx)
        same("concat vector replicas", vec, vec[:, :, :1].expand_as(vec))
        same("concat vector", vec[0, 0, 0],
             dlrm_mod.lookup_shards(server.tables_copy(), batch))
        want = server.reference(batch, dtype=torch.float64)
        diff = (out.double() - want).abs()
        if not bool((diff <= DLRM_ATOL + DLRM_RTOL * want.abs()).all()):
            fail(f"DLRM logits differ from the float64 reference by "
                 f"{float(diff.max())}")
        err = max(err, float(diff.max()))
        scale = max(scale, float(want.abs().max()))
    emit({"phase": "dlrm_serve", "batches": {"32": DLRM_BATCHES, "2048": 1},
          "launches_per_batch": seen, "concat_bitwise": True,
          "logits_max_abs_err": err, "logits_max_abs": scale,
          "tolerance": f"atol {DLRM_ATOL} + rtol {DLRM_RTOL} vs float64"})
    return small, large


def phase_dlrm_times(server, small, large, reps: int, smi: str) -> dict:
    """Phase 6d: median latency per batch and queries/s, the distributed
    path against the single-copy reference; one batch's device time by
    kernel group with the idle share."""
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % len(small)
        return small[it["i"]]

    big = max(3, reps // 4)
    t = {"b32": median_ms(lambda: server(nxt()), max(reps, DLRM_BATCHES)),
         "b32_reference": median_ms(lambda: server.reference(nxt()),
                                    max(reps, DLRM_BATCHES)),
         "b2048": median_ms(lambda: server(large), big),
         "b2048_reference": median_ms(lambda: server.reference(large), big)}
    qps = {k: (DLRM_LARGE if k.startswith("b2048") else DLRM_SMALL)
           / (ms / 1e3) for k, ms in t.items()}
    emit({"phase": "dlrm_times", "median_ms": t, "queries_per_s": qps,
          "card": smi})
    prof = {"b32": busy_and_idle(device_split(
                lambda: server(small[0]), _DLRM_GROUPS), t["b32"]),
            "b2048": busy_and_idle(device_split(
                lambda: server(large), _DLRM_GROUPS), t["b2048"])}
    emit({"phase": "dlrm_profile", **prof})
    return t


LOOKUP_NO_LIBRARY = ("none: no single PyTorch call computes a masked, "
                     "sharded gather into the concat layout")


def dlrm_kernel_rows(server, dlrm_mod, ref, mm, eg, gen, err) -> list:
    """Phase 6e: K4 and K5 device time at the DLRM shapes (B = 32, and
    B = 2048 beside it), cycling through operand pools so each launch
    reads cold HBM (four FC1 weight copies exceed the 50 MB L2). K5's
    `lookup` entry times `lookup_rows` on the path's own operands, its
    bound counting the concat vector written once, the rows the drawn ids
    hit read once and the ids read once, beside `sequence_ms`: the
    PyTorch ops around `gather_rows` that the lookup replaced."""
    pool = 4
    w = fc1_operands(server)
    ws = [w] + [w.clone() for _ in range(pool - 1)]
    tables = stacked_tables(server)
    G, rows_l, dim = tables.shape
    flat = tables.reshape(-1, dim)
    R, K, N = w.shape
    it = {"i": 0}

    def cyc():
        it["i"] = (it["i"] + 1) % pool
        return it["i"]

    def measure(fn, plain, library, nbytes, flops, n):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS_PER_S * 1e3
        return {"ms": device_time_ms(fn, n),
                "plain_ms": device_time_ms(plain, max(1, n // 4)),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": (device_time_ms(library, n)
                               if library is not None else None)}

    ltables, lo = dlrm_mod.lookup_operands(server.model.tables,
                                           server.ctx)
    T = ltables.shape[1]
    k4, k5, lk = {}, {}, {}
    for B in (DLRM_SMALL, DLRM_LARGE):
        xs = [torch.randn((R, B, K), generator=gen, device="cuda") * 0.01
              for _ in range(pool)]
        n = 200 if B == DLRM_SMALL else 10
        k4[B] = measure(lambda: mm.matmul_tiled(xs[cyc()], ws[it["i"]]),
                        lambda: ref.matmul(xs[cyc()], ws[it["i"]]),
                        lambda: torch.bmm(xs[cyc()], ws[it["i"]]),
                        4 * R * (B * K + K * N + B * N), 2 * R * B * K * N, n)
        k4[B]["shape"] = [R, B, K, N]
        k4[B]["config"] = mm.plan_name(B, K, N, w.dtype)
        k4[B]["achieved_tb_per_s"] = \
            4 * R * (B * K + K * N + B * N) / k4[B]["ms"] / 1e9
        k4[B]["achieved_tflop_per_s"] = 2 * R * B * K * N / k4[B]["ms"] / 1e9
        idxs = [torch.randint(0, rows_l, (G, B), generator=gen, device="cuda",
                              dtype=torch.int32) for _ in range(pool)]
        gids = [(torch.arange(G, device="cuda")[:, None] * rows_l
                 + ix).reshape(-1) for ix in idxs]
        k5[B] = measure(lambda: eg.gather_rows(tables, idxs[cyc()]),
                        lambda: ref.gather_rows(tables, idxs[cyc()]),
                        lambda: torch.index_select(flat, 0, gids[cyc()]),
                        2 * G * B * dim * 4 + G * B * 4, 0, n * 2)
        k5[B]["shape"] = [G, rows_l, dim, B]
        ids = [lookup_ids(server, dlrm_mod, B, gen) for _ in range(pool)]
        hits = lookup_hits(ids[0], lo, rows_l)
        lk[B] = measure(lambda: eg.lookup_rows(ltables, ids[cyc()], lo),
                        lambda: ref.lookup_rows(ltables, ids[cyc()], lo),
                        None, 4 * (lo.shape[0] * B * T * dim + hits * dim
                                   + B * T) + 8 * lo.shape[0], 0, n * 2)
        lk[B]["library_ms"] = None
        lk[B]["library_none"] = LOOKUP_NO_LIBRARY
        lk[B]["sequence_ms"] = device_time_ms(
            lambda: ref.lookup_rows(ltables, ids[cyc()], lo, gather=lambda
                                    t, i: eg.gather_rows(t, i.contiguous())),
            max(1, n // 2))
        lk[B]["shape"] = list(ltables.shape) + [B]
        lk[B]["hits"] = hits
        del xs, idxs, gids, ids
    rows = []
    for name, m in (("matmul_tiled", k4), ("gather_rows", k5)):
        rows.append({"name": name, "route": "cuda", "source": SOURCES[name],
                     "replaces": REPLACES[name], "max_abs_err": err[name],
                     **m[DLRM_SMALL],
                     "at_batch_2048": m[DLRM_LARGE]})
    rows[-1]["lookup"] = {"entry": "lookup_rows", **lk[DLRM_SMALL],
                          "at_batch_2048": lk[DLRM_LARGE]}
    return rows


# --------------------------------------------------------------------------
# Phase 7: the offload queue and use case 1, distributed vector-matrix
# --------------------------------------------------------------------------

VECMAT_SIZES = (512, 1024, 2048, 4096, 32768)
VECMAT_TILES = 4
_VECMAT_GROUPS = (("fused_combine_kernel", "K1 fused_combine"),
                  ("gemv", "cuBLAS (partials)"), ("gemm", "cuBLAS (partials)"),
                  ("xmma", "cuBLAS (partials)"),
                  ("cutlass", "cuBLAS (partials)"),
                  ("index", "gather/scatter (indexing)"))


def check_vecmat(y, x, w) -> tuple:
    """y against the float64 single-copy x @ w, column block by column
    block: any fp32 summation order of K = size products errs by at most
    gamma_K (|x| @ |w|), gamma_K = K u / (1 - K u), u = 2^-24. Returns
    (max abs error, max error / bound)."""
    K = w.shape[0]
    gamma = K * 2.0 ** -24 / (1 - K * 2.0 ** -24)
    xd = x.double()
    err = ratio = 0.0
    for c0 in range(0, w.shape[1], 4096):
        wb = w[:, c0:c0 + 4096].double()
        diff = (y[c0:c0 + 4096].double() - xd @ wb).abs()
        bound = gamma * (xd.abs() @ wb.abs())
        if not bool((diff <= bound).all()):
            fail(f"vecmat size {K}: {int((diff > bound).sum())} outputs "
                 f"exceed gamma_K (|x| @ |w|) of the float64 product")
        err = max(err, float(diff.max()))
        ratio = max(ratio, float((diff / bound.clamp_min(1e-300)).max()))
        del wb, diff, bound
    return err, ratio


def phase_vecmat(CollectiveEngine, vm, ops, ref, counts, gen, reps: int,
                 smi: str) -> None:
    """Phase 7a: use case 1 through the queue — `distributed_vecmat` at
    the example's sizes and at 32768 (a 4 GiB fp32 matrix, 512 MiB per
    rank, drawn on the card from the seed), 4 tiles: each tile one
    binomial-tree `ireduce`: exactly log2(8) = 3 K1 launches per tile
    (one per RECV_COMBINE), each call replayed BITWISE against K1's plain
    version; the result within gamma_K of the float64 single-copy
    product, the queue model's t_queue < t_serial on ACCL_CLUSTER, and
    the median time (CUDA events) against the single-copy `x @ w`, with
    the device's idle share. All ranks' partials are one batched product
    on one card, so `measured_x` is not an 8-rank cluster's speedup."""
    eng = CollectiveEngine({"x": NRANKS}, device="cuda")
    levels = NRANKS.bit_length() - 1     # binomial-tree depth
    out = []
    for size in VECMAT_SIZES:
        w = torch.randn((size, size), generator=gen, device="cuda")
        x = torch.randn((size,), generator=gen, device="cuda")
        xs, ws = x.reshape(NRANKS, -1), w.reshape(NRANKS, -1, size)

        def dist():
            return vm.distributed_vecmat(eng, xs, ws, VECMAT_TILES)

        ops.reset_launch_counts()
        with recording(ops, ("fused_combine_at",), keep=("fused_combine_at",),
                       seqs=(eng.queue,)) as (calls, items):
            y = dist()
            torch.cuda.synchronize()
        counts[f"vecmat_{size}"] = c = ops.launch_counts()
        per_tile = [k for _rids, k in items]
        if (per_tile != [levels] * VECMAT_TILES
                or c["fused_combine"] != levels * VECMAT_TILES
                or len(calls) != c["fused_combine"]):
            fail(f"vecmat size {size}: K1 launches per tile reduction "
                 f"{per_tile} ({c['fused_combine']} in all, {len(calls)} "
                 f"through the indexed entry), not {levels} for each of "
                 f"{VECMAT_TILES} tiles")
        replay_k1(ops, ref, calls, gen, f"vecmat size {size}")
        if y.shape != (size,) or not bool(torch.isfinite(y).all()):
            fail(f"vecmat size {size}: result {tuple(y.shape)} not finite")
        err, ratio = check_vecmat(y, x, w)
        m = vm.queue_model(eng, size, VECMAT_TILES)
        if not m["t_queue_s"] < m["t_serial_s"]:
            fail(f"vecmat size {size}: the queue model does not overlap "
                 f"({m['t_queue_s']} >= {m['t_serial_s']})")
        t_dist = median_ms(dist, reps)
        t_single = median_ms(lambda: x @ w, reps)
        row = {"size": size, "tiles": VECMAT_TILES,
               "matrix_bytes": w.numel() * 4, "dist_ms": t_dist,
               "single_ms": t_single, "measured_x": t_single / t_dist,
               "k1_per_tile": per_tile, "k1_replayed_bitwise": len(calls),
               "launches": c, "max_abs_err": err, "err_over_bound": ratio,
               **m, "profile": busy_and_idle(
                   device_split(dist, _VECMAT_GROUPS), t_dist)}
        out.append(row)
        del w, x, xs, ws, y
        torch.cuda.empty_cache()
    emit({"phase": "vecmat", "rows": out, "bound": "gamma_K (|x| @ |w|) "
          "vs float64", "model_comm": "ACCL_CLUSTER, 8 ranks",
          "card": smi})


def phase_queue(CollectiveEngine, Sequencer, ops, ref, counts, gen) -> None:
    """Phase 7b: an engine drain on the card. A mixed queue — three small
    same-dtype allreduces that coalesce, a compression="int8" allreduce
    at 4 MiB per rank, a binomial-tree reduce that consumes another
    request, an issue_multi over a (2, 4) mesh — drained on integer-
    valued fp32: BITWISE equal to the same calls made blocking; the non-
    int8 requests BITWISE equal to the port's `simulate_drain` of the
    same queue; one K2 and one K3 launch per compressed exchange; the
    coalesced bucket one program (`coalesced_buckets`, `trace_log`);
    every K1 call of the drain (the 72-element coalesced bucket's
    included) replayed BITWISE against K1's plain version."""
    eng = CollectiveEngine({"x": NRANKS}, device="cuda")
    eng2 = CollectiveEngine({"pod": 2, "data": 4}, device="cuda")
    small = [int_inputs((NRANKS, n), gen) for n in (40, 8, 24)]
    big = int_inputs((NRANKS, 2**20), gen)
    mid = int_inputs((NRANKS, 2**16), gen)
    X2 = int_inputs((2, 4, 2**16), gen)

    def issue(seq):
        rs = [seq.issue("allreduce", v, "x") for v in small]
        r_mid = seq.issue("allreduce", mid, "x")
        rs += [r_mid, seq.issue("reduce", r_mid, "x", root=2,
                                algorithm="binomial_tree")]
        return rs

    reqs = issue(eng.queue)
    r_int8 = eng.iallreduce(big, "x", compression="int8")
    r_multi = eng2.issue_multi(X2, ["data", "pod"])
    plan = [[r.rid for r in it.requests] for it in eng.queue.plan("x")]
    if plan[0] != [r.rid for r in reqs[:3]]:
        fail(f"queue: the small allreduces did not coalesce: plan {plan}")
    log0 = len(eng.trace_log)
    ops.reset_launch_counts()
    with recording(ops, ("fused_combine_at", "quantize_int8_at"),
                   keep=("fused_combine_at",),
                   seqs=(eng.queue, eng2.queue)) as (calls, items):
        eng.queue.drain()
        eng2.queue.drain()
        torch.cuda.synchronize()
    counts["queue"] = c = ops.launch_counts()
    k1_calls = [call for call in calls if call[0] == "fused_combine_at"]
    exchanges = [int(call[1][1][2].shape[0]) for call in calls
                 if call[0] == "quantize_int8_at"]
    if not exchanges or not (c["quantize_blocks"] == c["dequantize_blocks"]
                             == len(exchanges)):
        fail(f"queue: {c} launches for {len(exchanges)} compressed "
             f"exchanges of the int8 request")
    if c["fused_combine"] < 1 or len(k1_calls) != c["fused_combine"]:
        fail(f"queue: {c['fused_combine']} K1 launches, {len(k1_calls)} "
             f"through the indexed entry")
    stats = dict(eng.queue.stats)
    if (stats["coalesced_buckets"], stats["coalesced_requests"]) != (1, 3):
        fail(f"queue: coalescing stats {stats}")
    bucket_bytes = sum(v[0].numel() * 4 for v in small)
    drained = [t for t in eng.trace_log[log0:] if t[0] == "allreduce"]
    if [t[3] for t in drained].count(bucket_bytes) != 1 or any(
            t[3] == v[0].numel() * 4 for t in drained for v in small):
        fail(f"queue: the coalesced bucket did not run as one program: "
             f"{drained}")
    # blocking calls, outside the counted window
    blocking = [eng.allreduce(v, "x") for v in small]
    b_mid = eng.allreduce(mid, "x")
    blocking += [b_mid, eng.reduce(b_mid, "x", root=2,
                                   algorithm="binomial_tree")]
    for i, (r, want) in enumerate(zip(reqs, blocking)):
        same(f"queue request {i} vs blocking", r.result, want)
    same("queue int8 request vs blocking", r_int8.result,
         eng.allreduce(big, "x", compression="int8"))
    same("queue issue_multi vs blocking", r_multi.result,
         eng2.allreduce_multi(X2, ["data", "pod"]))
    # the same queue, minus the int8 request, through the simulator
    sim_seq = Sequencer(eng)
    sim_reqs = issue(sim_seq)
    feeds = {r: list(v.cpu().numpy())
             for r, v in zip(sim_reqs, small + [mid])}
    sim = sim_seq.simulate_drain(feeds)
    for i, (r, s) in enumerate(zip(reqs, sim_reqs)):
        got = r.result.cpu()
        want = torch.from_numpy(np.stack(sim[s]))
        same(f"queue request {i} vs simulate_drain", got, want)
    replay_k1(ops, ref, k1_calls, gen, "queue")
    emit({"phase": "queue", "plan": plan, "stats": stats,
          "launches": c, "compressed_exchanges": len(exchanges),
          "segments_per_exchange": sorted(set(exchanges)),
          "k1_per_item": items, "k1_replayed_bitwise": len(k1_calls),
          "bitwise_vs_blocking": len(reqs) + 2,
          "bitwise_vs_simulate_drain": len(sim_reqs),
          "int8_mib_per_rank": 4, "issue_multi_mesh": [2, 4]})


# --------------------------------------------------------------------------
# Phase 8: LM serving, qwen3-0.6b at full width and depth
# --------------------------------------------------------------------------

LM_ARCH = "qwen3-0.6b"
LM_MESH = {"pod": 1, "data": 4, "model": 2}   # launch/serve.py's defaults
LM_TP = 2
LM_SMALL = (4, 16, 8)       # (batch, prompt, gen): launch/serve.py's defaults
LM_LARGE = (32, 512, 32)
BF16_U = 2.0 ** -8          # bf16 unit roundoff
LM_Z = 4.0                  # standard deviations the token margin allows
LM_INT8_AGREE = 0.85        # tests/test_decode.py::test_int8_kv_cache_close_to_bf16
_LM_CUBLAS = "cuBLAS (projections)"
_LM_GROUPS = (("fused_combine_kernel", "K1 fused_combine"),
              ("matmul_tiled_kernel", "K4 matmul_tiled"),
              ("gemm", _LM_CUBLAS), ("gemv", _LM_CUBLAS),
              ("xmma", _LM_CUBLAS), ("cutlass", _LM_CUBLAS),
              ("nvjet", _LM_CUBLAS), ("CatArrayBatchedCopy", "torch.cat"),
              ("index", "gather/scatter (indexing)"),
              ("elementwise", "elementwise"), ("reduce", "reductions"))


# bf16 roundings of the residual stream per layer, by family (`lm_eps`)
LM_ROUNDINGS = {"dense": 10, "vlm": 10, "moe": 11, "ssm": 16, "hybrid": 28,
                "audio": 14}
# families whose layers carry the stream's error forward with a gain, so
# that the layers' errors add along the depth, not in quadrature (`lm_eps`)
LM_COHERENT = ("moe",)


def lm_eps(cfg, layers: int = None) -> float:
    """Relative error of the bf16 path's final hidden state against the
    float64 reference, as this script derives it: the residual stream
    takes n_r roundings to bf16, each counted at the stream's full
    magnitude and at most u = 2^-8 relative; as independent errors they
    add in quadrature: eps = u sqrt(n_r). Per layer (`LM_ROUNDINGS`):
    dense/vlm 10 — the outputs of the q, k, v and o projections, of the
    attention, of the gate, up and down projections and of the two
    residual adds; moe 11 — the experts' gate, up and down products
    where the MLP's were, and the routed combine; ssm 16 — the
    in-projection, the causal conv's 2 cw - 1 = 7 tap products and sums,
    its silu, the SSD output, the skip add, silu(z), the gate product,
    the gated norm, the out-projection and the residual add; hybrid 28 —
    the attention's 5, the SSM's 15 (no add of its own), the two branch
    norms and their mix, the MLP's 3 and two adds; audio 14 per decoder
    layer (self-attention 5, the cross-attention's q and o projections
    and attention 3, the MLP's 3, three adds) and 10 per encoder layer
    (the decoder reads the encoder's output through every cross-attention
    layer) plus 2 (the frames' positions, the encoder's norm). Plus 2 for
    the embedding rows and the final norm: 10 L + 2 = 282 (eps 0.0656)
    for qwen3-0.6b's 28 layers. With `layers` = i + 1, the error of a
    quantity inside decoder layer i (an SSM carry, a router's logits): the
    embedding's rounding and layers 0..i's, layer i counted whole (the
    encoder's too, where there is one), no final norm.

    A MoE layer (`LM_COHERENT`) carries the error it is handed forward
    with a gain: its gates are a softmax of router logits, so a relative
    error eps in the stream moves each gate, and the routed output with
    it, by about eps rms(logits). The layers' errors then add along the
    depth: eps = u (sqrt(11) L + sqrt(2)), each layer's u sqrt(11) summed
    (PERF.md section 6 has the router gap errors that show it)."""
    n = cfg.n_layers if layers is None else layers
    rest = (2 if layers is None else 1) + (
        LM_ROUNDINGS["dense"] * cfg.encoder_layers + 2
        if cfg.encoder_layers else 0)
    if cfg.family in LM_COHERENT:
        return BF16_U * (LM_ROUNDINGS[cfg.family] ** 0.5 * n + rest ** 0.5)
    return BF16_U * (LM_ROUNDINGS[cfg.family] * n + rest) ** 0.5


def lm_margins(logits, cfg):
    """Per position: (top-1 id, top-1 minus top-2, margin). A logit
    difference h . (w_a - w_b) moves by about eps sqrt(2) rms(logits)
    when h carries a relative error eps in a direction uncorrelated with
    the rows; the margin is LM_Z of those."""
    top = logits.topk(2, dim=-1).values
    rms = logits.pow(2).mean(-1).sqrt()
    return (logits.argmax(-1), top[..., 0] - top[..., 1],
            LM_Z * 2 ** 0.5 * lm_eps(cfg) * rms)


def lm_global(params, cfg, convert, stages):
    """The served params as single-copy float64 tensors on the card:
    every leaf unstacked from the serving layout (`fam_single_copy`; of
    its cuts only the vocab rows' applies at qwen3-0.6b's widths)."""
    return fam_single_copy(params, cfg, LM_MESH, LM_TP, convert, stages,
                           torch.float64, lead=False)


def lm_reference_logits(G, cfg, toks):
    """The float64 single-copy forward (plain torch on the card, one
    rank): logits (B, T, vocab) over every position of `toks` (B, T)."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    B, T = toks.shape
    f64 = dict(dtype=torch.float64, device="cuda")

    def rms(x, w):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True)
                               + cfg.norm_eps) * w

    half = hd // 2
    freqs = torch.exp(-math.log(cfg.rope_theta)
                      * torch.arange(half, **f64) / half)
    ang = torch.arange(T, **f64)[:, None] * freqs
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]

    def rope(x):
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    causal = torch.ones((T, T), dtype=torch.bool, device="cuda").tril()
    x = G["embed"][toks.long()]
    Ls = G["layers"]
    for i in range(cfg.n_layers):
        a, m = Ls["attn"], Ls["mlp"]
        h = rms(x, Ls["norm1"][i])
        q = (h @ a["wq"][i]).reshape(B, T, H, hd)
        k = (h @ a["wk"][i]).reshape(B, T, KV, hd)
        v = (h @ a["wv"][i]).reshape(B, T, KV, hd)
        if cfg.qk_norm:
            q, k = rms(q, a["q_norm"][i]), rms(k, a["k_norm"][i])
        q, k = rope(q), rope(k)
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, T, H * hd)
        x = x + o @ a["wo"][i]
        h = rms(x, Ls["norm2"][i])
        g, u = h @ m["w1"][i], h @ m["w3"][i]
        x = x + (g * torch.sigmoid(g) * u) @ m["w2"][i]
    x = rms(x, G["final_norm"])
    return (x @ G["embed"].T)[..., :cfg.vocab_size]


def lm_token_check(name, tokens, logits, cfg) -> dict:
    """tokens[b, t] must be the reference's argmax at position t wherever
    the reference's top-1 beats its top-2 by more than the margin, and
    everywhere a token whose reference logit lies within the margin of
    the reference's best (the same noise bound: the served run picked
    it, so the reference can rank it lower by no more than the gap
    error)."""
    best, gap, margin = lm_margins(logits, cfg)
    clear = gap > margin
    toks = tokens.to(best.device).long()
    bad = clear & (toks != best)
    if bool(bad.any()):
        fail(f"lm {name}: {int(bad.sum())} tokens differ from the "
             f"reference's argmax where its top-1 leads by more than the "
             f"margin")
    deficit = (logits.gather(-1, best[..., None])
               - logits.gather(-1, toks[..., None]))[..., 0] / margin
    if bool((deficit > 1).any()):
        fail(f"lm {name}: {int((deficit > 1).sum())} tokens rank more than "
             f"the margin below the reference's best")
    agree = toks == best
    return {"positions": int(gap.numel()), "compared": int(clear.sum()),
            "skipped": int((~clear).sum()),
            "agree_where_skipped": int((agree & ~clear).sum()),
            "max_deficit_over_margin": float(deficit.max()),
            "median_gap_over_margin": float((gap / margin).median())}


SSD_ERR_FACTOR = 2   # the SSD kernel's error: at most twice the plain one's


def ssd_within(name, res, plain, want) -> float:
    """Fails unless the kernel's largest error on y and on the final state
    (a share of the largest entry of the float64 recurrence `want`,
    `ref.ssd_recurrence`) is at most SSD_ERR_FACTOR times the plain
    version's; returns the larger ratio of the two errors."""
    worst = 0.0
    for part, got, p, w in zip(("y", "state"), res, plain, want):
        top = w.abs().max()
        err = float((got.double() - w).abs().max() / top)
        plain_err = float((p.double() - w).abs().max() / top)
        if err > SSD_ERR_FACTOR * plain_err:
            fail(f"{name}: {part} error {err} over {SSD_ERR_FACTOR} x the "
                 f"plain version's {plain_err}")
        worst = max(worst, err / plain_err if plain_err else 0.0)
    return worst


@contextlib.contextmanager
def ssd_checked(ops, ref, log):
    """While the block runs, hold every SSD scan (`ops.ssd_chunked`)
    within twice the plain version's error against the float64
    recurrence (`ssd_within`), right after the call; `log["ssd"]` gets
    each scan's [N, S, H, P, n], its chunks and its larger error
    ratio."""
    real = ops.ssd_chunked
    log.setdefault("ssd", [])

    def ssd(xh, dt, a_neg, b_in, c_in, chunk):
        res = real(xh, dt, a_neg, b_in, c_in, chunk)
        args = (xh, dt, a_neg, b_in, c_in)
        ratio = ssd_within(
            f"SSD scan {len(log['ssd'])} at {tuple(xh.shape)}", res,
            ref.ssd_chunked(*args, chunk), ref.ssd_recurrence(*args))
        S = xh.shape[1]
        log["ssd"].append({"shape": [*xh.shape, b_in.shape[-1]],
                           "chunks": S // min(chunk, S),
                           "err_over_plain": ratio})
        return res

    ops.ssd_chunked = ssd
    try:
        yield
    finally:
        ops.ssd_chunked = real


def ssd_summary(log) -> dict:
    """The line's account of the scans `ssd_checked` held."""
    return {"ssd_checked": len(log["ssd"]),
            "ssd_chunks": sorted({e["chunks"] for e in log["ssd"]}),
            "ssd_max_err_over_plain": max(
                (e["err_over_plain"] for e in log["ssd"]), default=None)}


@contextlib.contextmanager
def lm_checked(ops, ref, log):
    """While the block runs, hold every K1 call (`fused_combine_at`) and
    every indexed copy (`region_copy`) BITWISE against its plain version
    on the operands it was given, every K4 call (`matmul`) within
    2 K 2^-24 (|x| @ |w|) of the fp32 plain product plus one rounding to
    its output type (bf16: 2^-8 |y|), and every SSD scan as
    `ssd_checked` holds it, right after the call, before any later write
    (plain versions launch no kernel, so the counts are the path's; an
    in-place write's plain version runs first, on a clone). Log what a
    later replay on normal values needs (the indices and operand
    shapes); `log["copy"]` counts the copies held, `log["ssd"]` the
    scans."""
    real = {n: getattr(ops, n) for n in ("fused_combine_at", "matmul",
                                         "region_copy")}
    log.setdefault("copy", [])

    def k1(*args, **kwargs):
        a, ai, b, bi, op, od, ip = k1_args(real["fused_combine_at"], args,
                                           kwargs)
        want = k1_run(ref.fused_combine_at, a, ai, b, bi, op, od, ip) \
            if ip else None
        res = real["fused_combine_at"](*args, **kwargs)
        if want is None:
            want = ref.fused_combine_at(a, ai, b, bi, op, od)
        same(f"lm K1 call {len(log['k1'])} ({op})", res, want)
        log["k1"].append((a.shape, a.dtype, b.shape, b.dtype, b is a, ai,
                          bi, op, od, ip))
        return res

    def k4(x, y, out_dtype=None):
        res = real["matmul"](x, y, out_dtype)
        want = ref.matmul(x, y, torch.float32).double()
        bound = 2 * x.shape[-1] * 2.0 ** -24 * (x.double().abs()
                                                @ y.double().abs())
        if res.dtype != torch.float32:
            bound = bound + BF16_U * want.abs()
        diff = (res.double() - want).abs()
        if not bool((diff <= bound).all()):
            fail(f"lm K4 call {len(log['k4'])}: {int((diff > bound).sum())} "
                 f"elements outside the bound")
        log["k4"].append(float(diff.max()))
        return res

    def copy(src, src_index, dst, dst_index):
        d = dst.clone()
        want = ref.region_copy(d if src is dst else src, src_index, d,
                               dst_index)
        res = real["region_copy"](src, src_index, dst, dst_index)
        same(f"lm indexed copy {len(log['copy'])}", res, want)
        log["copy"].append(int(src_index[2].numel()))
        return res

    ops.fused_combine_at, ops.matmul, ops.region_copy = k1, k4, copy
    try:
        with ssd_checked(ops, ref, log):
            yield
    finally:
        for n, fn in real.items():
            setattr(ops, n, fn)


def lm_replay_normal(ops, ref, log, gen) -> int:
    """Every logged K1 call again on normal-valued operands of its shapes
    through its own region indices, BITWISE against the plain version."""
    for i, (ash, adt, bsh, bdt, same_ab, ai, bi, op, od, ip) in \
            enumerate(log["k1"]):
        a = torch.randn(ash, generator=gen, device="cuda").to(adt)
        b = a if same_ab else torch.randn(bsh, generator=gen,
                                          device="cuda").to(bdt)
        same(f"lm K1 call {i} ({op}) on normal values",
             k1_run(ops.fused_combine_at, a, ai, b, bi, op, od, ip),
             k1_run(ref.fused_combine_at, a, ai, b, bi, op, od, ip))
    return len(log["k1"])


def implied_k1(prog) -> int:
    """K1 launches the executor makes for `prog`: one for every
    uncompressed plain combining exchange, over all its segments, in
    place or not (`core/engine.py::exchange_path`), over the exchanges
    of the program's walk (`core/program.py::batches`)."""
    from repro_torch.core import engine as em
    from repro_torch.core import program as pm

    def body(b):
        if em._codec_of(em._split_wire(b[1:-1])[0]) is not None:
            fail("lm: a compressed exchange on the serving path")
        return int(em.exchange_path(None, b[-1], False) == "indexed")

    return sum(body(b) for batch in pm.batches(prog)
               if isinstance(batch, pm.Batch)
               for b, _k, _step in batch.exchanges)


def lm_counted_steps(dstep, engine, ops, steps):
    """`dstep` wrapped to log, per call, (K1 launches, the K1 launches the
    compiled programs it executed imply, the engine's collectives among
    them by name)."""
    real = engine._execute
    progs = []

    def execute(sched, rows, lay, compression=None):
        progs.append((sched, tuple(rows.shape), compression))
        return real(sched, rows, lay, compression)

    def step(*args, **kwargs):
        progs.clear()
        k0 = ops.launch_counts()["fused_combine"]
        out = dstep(*args, **kwargs)
        launched = ops.launch_counts()["fused_combine"] - k0
        implied = sum(implied_k1(s.compile(codec=c, verify=engine.verify))
                      for s, _shape, c in progs)
        colls: dict = {}
        for s, _sh, _c in progs:
            colls[s.collective] = colls.get(s.collective, 0) + 1
        steps.append((launched, implied, colls))
        return out

    engine._execute = execute
    return step


def lm_check_steps(name, steps, want: dict) -> dict:
    """Each decode step launched K1 exactly as often as its programs
    imply and ran exactly the engine collectives `want` counts."""
    for t, (launched, implied, colls) in enumerate(steps):
        if launched != implied or colls != want:
            fail(f"lm {name} step {t}: {launched} K1 launches, {implied} "
                 f"implied by its programs, collectives {colls} "
                 f"(want {want})")
    return {"steps": len(steps), "collectives_per_step": want,
            "k1_per_step": sorted({s[0] for s in steps}),
            "k1_implied_per_step": sorted({s[1] for s in steps})}


def phase_lm_build(cfg, stages, seed: int):
    """Phase 8a: the full-width model's params drawn on the card."""
    free0, total = torch.cuda.mem_get_info()
    t0 = time.perf_counter()
    params = stages.init_params(cfg, LM_MESH, LM_TP, seed=seed,
                                device="cuda", serve=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        else:
            leaves.append(t)
    walk(params)
    free1, _ = torch.cuda.mem_get_info()
    emit({"phase": "lm_build", "config": dataclasses.asdict(cfg),
          "n_params": cfg.n_params(), "mesh": LM_MESH,
          "stacked_param_bytes": sum(t.numel() * t.element_size()
                                     for t in leaves),
          "single_copy_bytes": cfg.n_params() * 2, "init_seconds": init_s,
          "mem_free_before": free0, "mem_free_after": free1,
          "mem_total": total})
    return params


def phase_lm_serve(cfg, params, mods, ops, ref, counts, gen, seed: int):
    """Phase 8b: runs A-D at (B, prompt, gen) = (4, 16, 8), each counted
    from 0, every K1 call held BITWISE and every K4 call within its bound
    as it runs, then replayed on normal values; tokens against the
    float64 reference's argmax (the margin rule), run C's prefill and run
    D's int8 tokens against run A's."""
    convert, stages, ServeSession, convert_prefill_caches, serve_launch = \
        mods
    from repro_torch.configs import ParallelConfig
    B, P, Gn = LM_SMALL
    pcfg = ParallelConfig()
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=g,
                           device="cuda", dtype=torch.int32)
    log = {"k1": [], "k4": []}
    out, steps = {}, {}

    dp = stages.dp_axes(LM_MESH, B)

    def session(name, kv, forced=None):
        """A ServeSession's generate, counted; with `forced` (B, Gn)
        tokens, each decode step is fed forced[:, i] instead of the
        session's own last token (teacher forcing)."""
        sess = ServeSession(cfg, dataclasses.replace(
            pcfg, kv_cache_dtype=kv), LM_MESH, LM_TP, B, P, P + Gn,
            device="cuda")
        seen, steps[name] = {}, []
        real_pf = sess.prefill_fn

        def pf(*a):
            seen["nxt"], seen["caches"] = res = real_pf(*a)
            return res
        sess.prefill_fn = pf
        dec = lm_counted_steps(sess.decode_fn, sess.decode_ctx.engine, ops,
                               steps[name])
        if forced is None:
            sess.decode_fn = dec
        else:
            def teacher(params, caches, tok, pos):
                i = pos - P
                return dec(params, caches, convert.stack_global(
                    forced[:, i:i + 1].to("cuda"), LM_MESH, (dp, None)), pos)
            sess.decode_fn = teacher
        ops.reset_launch_counts()
        with lm_checked(ops, ref, log):
            toks = sess.generate(params, prompt, Gn)
            torch.cuda.synchronize()
        counts[f"lm_{name}"] = ops.launch_counts()
        del sess.decode_ctx.engine._execute
        return toks, seen

    # run A: the serve session
    out["A"], seen_a = session("session", "param")
    # run B: the launcher's decode-only loop, every step's prediction kept
    dstep, dctx, _, _ = stages.build_decode_step(
        cfg, pcfg, LM_MESH, s_max=P + Gn, global_batch=B, device="cuda")
    cache = stages.init_cache(cfg, pcfg, LM_MESH, LM_TP, B, P + Gn,
                              device="cuda")
    preds, steps["loop"] = [], []
    counted = lm_counted_steps(dstep, dctx.engine, ops, steps["loop"])

    def keep(*a):
        nxt, c = counted(*a)
        preds.append(convert.unstack(nxt, LM_MESH, (dp,)))
        return nxt, c
    ops.reset_launch_counts()
    with lm_checked(ops, ref, log):
        seq_b = serve_launch.decode_loop(keep, params, cache, prompt, Gn,
                                         LM_MESH, dp)
        torch.cuda.synchronize()
    counts["lm_loop"] = ops.launch_counts()
    del dctx.engine._execute, cache
    # run C: a prefill with sequence parallelism + the collective matmul
    pf_c, _, _, bspec = stages.build_prefill(
        cfg, dataclasses.replace(pcfg, sequence_parallel=True,
                                 collective_matmul=True),
        LM_MESH, B, P, device="cuda")
    batch = {"tokens": convert.stack_global(prompt, LM_MESH,
                                            bspec["tokens"])}
    ops.reset_launch_counts()
    with lm_checked(ops, ref, log):
        nxt_c, caches_c = pf_c(params, batch)
        torch.cuda.synchronize()
    counts["lm_prefill_sp"] = c = ops.launch_counts()
    if c["matmul_tiled"] < 1:
        fail("lm run C: the SP prefill launched no K4")
    # run D: the serve session with the int8 KV cache, decoding
    # teacher-forced on run A's tokens, so each of its tokens is predicted
    # from the prefix run A's was (as the reference's int8 test compares)
    out["D"], _ = session("session_int8", "int8", forced=out["A"])
    for key in ("lm_session", "lm_loop", "lm_session_int8"):
        if counts[key]["fused_combine"] < 1:
            fail(f"lm {key}: no K1 launch")
    replayed = lm_replay_normal(ops, ref, log, gen)

    # correctness against the float64 single-copy reference
    G = lm_global(params, cfg, convert, stages)
    seq_a = torch.cat([prompt, out["A"][:, :-1].to("cuda")], dim=1)
    tok = {}
    logits_a = lm_reference_logits(G, cfg, seq_a)
    tok["A"] = lm_token_check("run A", out["A"], logits_a[:, P - 1:], cfg)
    logits_b = lm_reference_logits(G, cfg, seq_b[:, :-1])
    tok["B"] = lm_token_check("run B", torch.stack(preds, dim=1),
                              logits_b, cfg)
    # run C against run A's prefill: the token by the margin rule, the
    # caches within LM_Z eps of their largest entry
    nxt_a = convert.unstack(seen_a["nxt"], LM_MESH, (dp,))
    _best, gap, margin = lm_margins(logits_a[:, P - 1], cfg)
    nxt_c = convert.unstack(nxt_c, LM_MESH, (dp,))
    if bool(((gap > margin) & (nxt_c != nxt_a)).any()):
        fail("lm run C: the SP prefill's token differs from run A's where "
             "the reference's margin is clear")
    cache_err = 0.0
    for la, lc in zip(seen_a["caches"], caches_c):
        for i in range(la.shape[0]):
            d = float((lc[i].float() - la[i].float()).abs().max())
            top = float(la[i].float().abs().max())
            if d > LM_Z * lm_eps(cfg) * top:
                fail(f"lm run C: layer {i} cache differs from run A's by "
                     f"{d} (largest entry {top})")
            cache_err = max(cache_err, d / top)
    agree_d = float((out["D"] == out["A"]).float().mean())
    if agree_d < LM_INT8_AGREE:
        fail(f"lm run D: int8-cache tokens agree with run A's on "
             f"{agree_d:.3f} of positions")
    # the bf16 forward's logit-gap error, against the margin it is held to
    ctx = stages.make_ctx(cfg, dataclasses.replace(pcfg, serving=True),
                          LM_MESH, "cuda")
    from repro_torch.models import lm as lm_mod
    with torch.inference_mode():
        x, _ = lm_mod.forward(params, {"tokens": convert.stack_global(
            seq_a, LM_MESH, (dp, None))}, cfg, ctx)
    x = convert.unstack(x, LM_MESH, (dp, None, None)).double()
    mine = (x @ G["embed"].T)[..., :cfg.vocab_size]
    best, gap, margin = lm_margins(logits_a, cfg)
    top10 = logits_a.topk(10, dim=-1).indices
    d_gap = ((mine.gather(-1, top10) - mine.gather(-1, best[..., None]))
             - (logits_a.gather(-1, top10)
                - logits_a.gather(-1, best[..., None]))).abs().amax(-1)
    emit({"phase": "lm_serve", "shape": {"batch": B, "prompt": P,
                                         "gen": Gn},
          "runs": {"A": "ServeSession", "B": "launch/serve.py loop",
                   "C": "prefill, sequence_parallel + collective_matmul",
                   "D": "ServeSession, kv_cache_dtype=int8, decode "
                        "teacher-forced on run A's tokens"},
          "launches": {k: counts[k] for k in ("lm_session", "lm_loop",
                                              "lm_prefill_sp",
                                              "lm_session_int8")},
          # 1 + 2 L + 2 allreduces: the embedding, the attention and MLP
          # finishes of every layer, the head's max and min (KV heads
          # shard at tp 2, so no flash-combine)
          "decode_steps": {k: lm_check_steps(
              k, v, {"allreduce": 1 + 2 * cfg.n_layers + 2})
              for k, v in steps.items()},
          "k1_checked_bitwise": len(log["k1"]),
          "copy_checked_bitwise": len(log["copy"]),
          "k1_replayed_normal": replayed, "k4_checked": len(log["k4"]),
          "k4_max_abs_err": max(log["k4"]) if log["k4"] else None,
          "margin": f"{LM_Z} sqrt(2) eps rms(logits), eps = 2^-8 "
                    f"sqrt(10 L + 2) = {lm_eps(cfg):.4f}",
          "tokens": tok, "run_c_cache_rel_err": cache_err,
          "run_c_token_equal": bool((nxt_c == nxt_a).all()),
          "run_d_agreement": agree_d,
          "bf16_forward_gap_err_over_margin": float((d_gap / margin).max()),
          "generated_A": out["A"].tolist()})
    del G, logits_a, logits_b, mine, x, seen_a, caches_c
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# Phase 9: LM serving for the MoE, SSM, hybrid and audio families
# --------------------------------------------------------------------------

FAM_WIDE = (32, 16, 32)      # 1024 generated positions, short prompt
# run, arch, mesh, tp, depth (None: the config's), ParallelConfig fields,
# the single-copy reference's dtype, the second (batch, prompt, gen) that
# is timed and whose tokens are held to the reference too
FAM_RUNS = (
    # 2 of 48 layers: the full 61 GB model leaves no room for the
    # single-copy reference beside it (12 would fit), and phases 13-14
    # need the time under the run's limit (4 layers: 591 s in all)
    ("9a", "qwen3-moe-30b-a3b", {"pod": 1, "data": 1, "model": 8}, 8, 2,
     {}, torch.float32, LM_LARGE),
    # 9b-9d at an eighth of their depth (6 of 48, 4 of 32, 3 of 24
    # encoder and decoder layers), for the same reason
    ("9b", "mamba2-1.3b", LM_MESH, LM_TP, 6, {}, torch.float64, LM_LARGE),
    ("9c", "hymba-1.5b", LM_MESH, LM_TP, 4, {}, torch.float64, FAM_WIDE),
    # the reference's blocked attention needs blocks that divide S
    ("9d", "whisper-medium", LM_MESH, LM_TP, 3,
     {"attn_q_block": 500, "attn_kv_block": 1500}, torch.float64, FAM_WIDE),
)
FAM_FRAMES = 1500            # Whisper's 30 s window of encoder positions
FAM_MOE_CF = 8.0             # launch/serve.py's moe_capacity_factor
FAM_REF_TOKENS = 4096        # positions per chunk of the reference forward
_ONE = {"pod": 1, "data": 1, "model": 1}
_FAM_GROUPS = _LM_GROUPS + (("sort", "sort (routing)"),
                            ("scan", "scans (cumsum, cummax)"))


def fam_step_collectives(cfg, tp: int, s_max: int, pcfg) -> dict:
    """The engine collectives one decode step runs, from the layouts: per
    attention layer an allreduce finishing the o-projection, plus, over a
    sequence-sharded cache, the q allgather and the flash-combine's
    three allreduces (max, sum, acc); per cross-attention one allreduce;
    per SSM mixer two (the gated norm's mean-square, the out-projection);
    per MLP one; per MoE layer two all-to-alls (dispatch, return); the
    embedding one, the head's max and min two."""
    from repro_torch.models.attention import kv_layout
    from repro_torch.models.serve import layer_cache_len
    _kv_l, kv_sharded = kv_layout(cfg, tp)
    want = {"allreduce": 3}
    for layer in range(cfg.n_layers):
        n = 0
        if cfg.family in ("ssm", "hybrid"):
            n += 2
        if cfg.family != "ssm":
            length = layer_cache_len(cfg, layer, s_max)
            n += 1 + (cfg.family != "moe") + bool(cfg.encoder_layers)
            if (not kv_sharded) and pcfg.decode_seq_shard and \
                    length % tp == 0:
                n += 3
                want["allgather"] = want.get("allgather", 0) + 1
        if cfg.family == "moe":
            want["alltoall"] = want.get("alltoall", 0) + 2
        want["allreduce"] += n
    return want


def fam_single_copy(params, cfg, mesh, tp, convert, stages, dtype,
                    lead: bool = True):
    """The served params as one rank's model on the (1, 1, 1) mesh in
    `dtype`: every leaf unstacked (`convert.unstack`), then the serving
    layout's paddings cut (vocab rows, padded q heads, padded SSM
    heads). lead=False: without the (1, 1, 1) mesh dims."""
    from repro_torch.models.mlp import moe_factor
    if cfg.family == "moe" and moe_factor(cfg, tp) > 1:
        fail("a single copy of pseudo-experts would drop differently")
    specs = stages.param_specs(cfg, tp, serve=True)
    V, qd = cfg.vocab_size, cfg.n_heads * cfg.resolved_head_dim
    di, nh = cfg.ssm_d_inner, cfg.ssm_n_heads
    # (parent, leaf) -> (dim of the padded axis in the (L, ...) stack, size)
    cut = {("attn", "wq"): (2, qd), ("attn", "wo"): (1, qd),
           ("xattn", "wq"): (2, qd), ("xattn", "wo"): (1, qd),
           ("ssm", "w_z"): (2, di), ("ssm", "w_x"): (2, di),
           ("ssm", "w_dt"): (2, nh), ("ssm", "conv_x"): (2, di),
           ("ssm", "a_log"): (1, nh), ("ssm", "dt_bias"): (1, nh),
           ("ssm", "d_skip"): (1, nh), ("ssm", "norm"): (1, di),
           ("ssm", "out_proj"): (1, di)}
    one = (1, 1, 1) if lead else ()

    def walk(t, spec, layered, name="", parent=""):
        if isinstance(t, dict):
            return {k: walk(v, spec[k], layered, k, name)
                    for k, v in t.items()}
        if layered:
            g = torch.stack([convert.unstack(t[i], mesh, spec[1:])
                             for i in range(t.shape[0])])
            if (parent, name) in cut:
                dim, size = cut[parent, name]
                g = g.narrow(dim, 0, size)
            return g.to(dtype).reshape(g.shape[:1] + one + g.shape[1:])
        g = convert.unstack(t, mesh, spec)
        if name in ("embed", "head"):
            g = g[:V]
        return g.to(dtype).reshape(one + g.shape)
    return {k: walk(v, specs[k], k in ("layers", "enc_layers"), k)
            for k, v in params.items()}


@contextlib.contextmanager
def plain_ssd():
    """While the block runs, `ops.ssd_chunked` is the plain version
    (`ref.ssd_chunked`), so a reference forward shares no SSD kernel with
    the run it checks; fails if the block launches that kernel anyway."""
    from repro_torch.kernels import ops, ref, ssd_scan
    real, launches = ops.ssd_chunked, ssd_scan.ssd_chunked.launches
    ops.ssd_chunked = ref.ssd_chunked
    try:
        yield
    finally:
        ops.ssd_chunked = real
    if ssd_scan.ssd_chunked.launches != launches:
        fail("the single-copy reference launched the SSD kernel")


def fam_reference_logits(G, cfg, pcfg, stages, lm_mod, toks, frames=None,
                         start: int = 0, routes=None, routing=None,
                         vis=None):
    """The single-copy forward through the port's own modules on the
    (1, 1, 1) mesh (no collective, no kernel: the SSD scan is the plain
    version, `plain_ssd`): logits (B, T - start,
    vocab) at positions start.. of `toks` (B, T), a VLM's prefix `vis`
    (B, n_vis, d) in place of its first positions. Rows go through in
    chunks of about FAM_REF_TOKENS positions (encoder frames included);
    the causal forward of a row needs no other row. Its attention is one
    block and its SSD one chunk over T where T exceeds them (both exact
    rewrites; the served run keeps its blocks and chunks). With `routes`
    (`moe_served_routes`), each chunk's MoE layers route as the served
    run did (`moe_forced`), their routing tallies summed into
    `routing`."""
    from repro_torch.models import mlp as mlp_mod
    dtype = G["final_norm"].dtype
    B, T = toks.shape
    pcfg = dataclasses.replace(pcfg, serving=True,
                               attn_q_block=max(pcfg.attn_q_block, T),
                               attn_kv_block=max(pcfg.attn_kv_block, T))
    cfg = dataclasses.replace(cfg, ssm_chunk=max(cfg.ssm_chunk, T))
    ctx = stages.make_ctx(cfg, pcfg, _ONE, "cuda")
    w = (G["embed"] if cfg.tie_embeddings else G["head"])[0, 0, 0]
    per_row = T + (0 if frames is None else frames.shape[1])
    rows = max(1, FAM_REF_TOKENS // per_row)
    out = []
    for r0 in range(0, B, rows):
        r = slice(r0, min(B, r0 + rows))
        batch = {"tokens": toks[r][None, None, None]}
        if frames is not None:
            batch["frames"] = frames[r].to(dtype)[None, None, None]
        if vis is not None:
            batch["vis_embed"] = vis[r].to(dtype)[None, None, None]
        forced = contextlib.nullcontext() if routes is None else moe_forced(
            mlp_mod, [tuple(t[r] for t in lr) for lr in routes], cfg,
            routing)
        with torch.inference_mode(), forced, plain_ssd():
            x, _ = lm_mod.forward(G, batch, cfg, ctx)
        out.append(x[0, 0, 0, :, start:] @ w.T)
        del x
    return torch.cat(out)[..., :cfg.vocab_size]


@contextlib.contextmanager
def moe_recording(mlp_mod, rec):
    """While the block runs, log each routing of `moe_block`: its router
    probabilities and expert choices (`top_k`) and its dispatch slots
    (`_dispatch_indices`, -1 = dropped), stacked per rank."""
    real_top, real_disp = mlp_mod.top_k, mlp_mod._dispatch_indices

    def top_k(x, k):
        vals, idx = real_top(x, k)
        rec.append({"probs": x.clone(), "top_e": idx.clone()})
        return vals, idx

    def dispatch(ids, n, capacity):
        slots = real_disp(ids, n, capacity)
        rec[-1]["slots"] = slots.clone()
        return slots
    mlp_mod.top_k, mlp_mod._dispatch_indices = top_k, dispatch
    try:
        yield rec
    finally:
        mlp_mod.top_k, mlp_mod._dispatch_indices = real_top, real_disp


def moe_served_routes(rec, cfg, mesh, B, P, steps, convert, stages):
    """The served run's routing per layer in the single copy's token order:
    expert choices and kept (not dropped) assignments (B, T, k) and
    router probabilities (B, T, E) — the prefill's token-sharded
    routings put back in sequence order, then one replicated routing per
    decode step — and the dropped assignments per layer."""
    L, k = cfg.n_layers, cfg.experts_per_token
    if len(rec) != L * (1 + steps):
        fail(f"lm 9a: {len(rec)} routings logged, want {L * (1 + steps)}")
    dp = stages.dp_axes(mesh, B)
    lead = tuple(mesh.values())
    tp = mesh["model"]
    routes, dropped = [], []
    for layer in range(L):
        parts, probs = [], []
        for j in range(1 + steps):
            r = rec[j * L + layer]
            kept = (r["slots"] >= 0).reshape(r["top_e"].shape)
            s_l = (P // tp) if j == 0 else 1
            spec = (dp, "model" if j == 0 else None, None)
            both = torch.stack([r["top_e"], kept.long()], dim=-1)
            parts.append(convert.unstack(
                both.reshape(lead + (-1, s_l, k, 2)), mesh, spec + (None,)))
            probs.append(convert.unstack(
                r["probs"].reshape(lead + (-1, s_l, cfg.n_experts)), mesh,
                spec))
        g = torch.cat(parts, dim=1)                    # (B, T, k, 2)
        routes.append((g[..., 0], g[..., 1].bool(), torch.cat(probs, 1)))
        dropped.append(int((~routes[-1][1]).sum()))
    return routes, dropped


@contextlib.contextmanager
def moe_forced(mlp_mod, routes, cfg, stats):
    """While the block runs, each `moe_block` (one per layer, in order)
    routes as the served run did: the served expert choices, gated by
    this run's own probabilities, and the served run's dropped
    assignments dropped. `stats` (one dict per layer) sums, per layer,
    this run's own top-k set against the served one wherever its k-th /
    (k+1)-th logit gap clears the bf16 noise margin of the roundings up
    to that layer (`lm_eps(cfg, layer + 1)`), and keeps the largest
    error of the served run's gap between the same two experts and the
    largest gap where the sets differ, both over the margin."""
    real_top, real_disp = mlp_mod.top_k, mlp_mod._dispatch_indices
    layer = [0]
    k = cfg.experts_per_token

    def top_k(probs, kk):
        te, _keep, served = routes[layer[0]]
        te = te.reshape(tuple(probs.shape[:-1]) + (kk,))
        own_v, own_i = real_top(probs, kk + 1)
        lp = torch.log(probs.double())
        rms = (lp - lp.mean(-1, keepdim=True)).pow(2).mean(-1).sqrt()
        gap = torch.log(own_v[..., k - 1].double()) \
            - torch.log(own_v[..., k].double())
        margin = LM_Z * 2 ** 0.5 * lm_eps(cfg, layer[0] + 1) * rms
        clear = gap > margin
        same_set = (own_i[..., :k].sort(-1).values
                    == te.sort(-1).values).all(-1)
        lps = torch.log(served.reshape(probs.shape).double())
        served_gap = (lps.gather(-1, own_i[..., k - 1:k])
                      - lps.gather(-1, own_i[..., k:k + 1]))[..., 0]
        tally = stats[layer[0]]
        for key, n in (("tokens", gap.numel()), ("compared", clear.sum()),
                       ("equal_where_compared", (same_set & clear).sum()),
                       ("equal_where_skipped", (same_set & ~clear).sum())):
            tally[key] = tally.get(key, 0) + int(n)
        for key, v in (("max_gap_err_over_margin",
                        (served_gap - gap).abs() / margin),
                       ("max_unequal_gap_over_margin",
                        torch.where(same_set, 0.0, gap / margin))):
            tally[key] = max(tally.get(key, 0.0), float(v.max()))
        return torch.gather(probs, -1, te), te

    def dispatch(ids, n, capacity):
        slots = real_disp(ids, n, capacity)
        keep = routes[layer[0]][1].reshape(slots.shape)
        layer[0] += 1
        return torch.where(keep, slots, -1)
    mlp_mod.top_k, mlp_mod._dispatch_indices = top_k, dispatch
    try:
        yield
    finally:
        mlp_mod.top_k, mlp_mod._dispatch_indices = real_top, real_disp


class FamServer:
    """One family's serving entry points on the card: `ServeSession`
    (prefill, handoff, decode) for 9a-9c, and the audio family (and a
    VLM with its visual prefix) through its pieces —
    `stages.build_prefill` with frames (or `vis_embed`),
    `convert_prefill_caches(..., s_enc)` and
    `stages.build_decode_step(s_enc=...)` — since the session prefills
    tokens only (ROADMAP Queue 3). With `engine` (this process's
    `ProcessGroupEngine`) every entry point runs on local shards: the
    batch is cut to the process's rows and the tokens gathered."""

    def __init__(self, mods, cfg, pcfg, mesh, tp, B, P, Gn, frames=None,
                 vis=None, engine=None):
        convert, stages, ServeSession, convert_prefill_caches, _ = mods
        self.mods, self.cfg, self.pcfg = mods, cfg, pcfg
        self.mesh, self.tp, self.B, self.P, self.Gn = mesh, tp, B, P, Gn
        self.frames, self.vis, self.engine = frames, vis, engine
        self.s_enc = 0 if frames is None else frames.shape[1]
        self.sess = None
        if frames is None and vis is None:
            self.sess = ServeSession(cfg, pcfg, mesh, tp, B, P, P + Gn,
                                     device="cuda", engine=engine)
            self.prefill_fn = self.sess.prefill_fn
            self.decode_fn = self.sess.decode_fn
            self.decode_ctx, self.bspec = self.sess.decode_ctx, \
                self.sess.bspec
        else:
            self.prefill_fn, _, _, self.bspec = stages.build_prefill(
                cfg, pcfg, mesh, B, P, device="cuda", engine=engine)
            self.decode_fn, self.decode_ctx, _, _ = \
                stages.build_decode_step(cfg, pcfg, mesh, s_max=P + Gn,
                                         global_batch=B, s_enc=self.s_enc,
                                         device="cuda", engine=engine)

    def wrap(self, prefill=None, decode=None):
        if prefill is not None:
            self.prefill_fn = prefill(self.prefill_fn)
        if decode is not None:
            self.decode_fn = decode(self.decode_fn)
        if self.sess is not None:
            self.sess.prefill_fn = self.prefill_fn
            self.sess.decode_fn = self.decode_fn

    def batch(self, prompt):
        convert = self.mods[0]
        b = {"tokens": prompt}
        if self.frames is not None:
            b["frames"] = self.frames
        if self.vis is not None:
            b["vis_embed"] = self.vis
        if self.engine is not None:
            return {k: convert.shard_of(v, self.mesh, self.bspec[k],
                                        self.engine.coords).contiguous()
                    for k, v in b.items()}
        return {k: convert.stack_global(v, self.mesh, self.bspec[k])
                for k, v in b.items()}

    def handoff(self, pf_caches):
        return self.mods[3](pf_caches, self.cfg, self.pcfg, self.mesh,
                            self.tp, self.B, self.P, self.P + self.Gn,
                            s_enc=self.s_enc, engine=self.engine)

    def generate(self, params, prompt, n: int):
        """(B, n) greedy tokens on the CPU."""
        if self.sess is not None:
            return self.sess.generate(params, prompt, n)
        nxt, pf_caches = self.prefill_fn(params, self.batch(prompt))
        caches = self.handoff(pf_caches)
        del pf_caches
        out = [nxt]
        for i in range(n - 1):
            nxt, caches = self.decode_fn(params, caches, nxt[..., None],
                                         self.P + i)
            out.append(nxt)
        dp = self.bspec["tokens"][0]
        if self.engine is not None:
            return self.mods[0].gather_global(torch.stack(out, dim=-1),
                                              (dp, None), self.engine).cpu()
        return self.mods[0].unstack(torch.stack(out, dim=-1), self.mesh,
                                    (dp, None)).cpu()


def fam_frames(cfg, B, seed: int):
    """Stub encoder frames (B, 1500, d) in bf16, drawn on the card
    (`configs/whisper_medium.py` stubs the conv front end)."""
    g = torch.Generator(device="cuda").manual_seed(seed + 9)
    return torch.randn((B, FAM_FRAMES, cfg.d_model), generator=g,
                       device="cuda").to(torch.bfloat16)


def phase_fam_build(run, arch, mesh, tp, depth, get_config, stages,
                    seed: int):
    """Phase 9 (per model): the config, cut in depth where the row says
    so, and its params drawn on the card from --seed."""
    cfg = get_config(arch)
    if depth is not None:      # an encoder, where there is one, cut alike
        cfg = dataclasses.replace(cfg, n_layers=depth, encoder_layers=min(
            cfg.encoder_layers, depth))
    free0, total = torch.cuda.mem_get_info()
    t0 = time.perf_counter()
    params = stages.init_params(cfg, mesh, tp, seed=seed, device="cuda",
                                serve=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        else:
            leaves.append(t)
    walk(params)
    free1, _ = torch.cuda.mem_get_info()
    emit({"phase": "lm_families_build", "run": run, "arch": arch,
          "reduced": None if depth is None else
          {"n_layers": [get_config(arch).n_layers, depth],
           "encoder_layers": [get_config(arch).encoder_layers,
                              cfg.encoder_layers]},
          "config": dataclasses.asdict(cfg), "mesh": mesh, "tp": tp,
          "stacked_param_bytes": sum(t.numel() * t.element_size()
                                     for t in leaves),
          "init_seconds": init_s, "mem_free_before": free0,
          "mem_free_after": free1, "mem_total": total})
    return cfg, params


def fam_tokens(run, cfg, G, pcfg, mesh, mods, prompt, out, frames, rec,
               start: int, vis=None):
    """`out` (B, Gn), served greedily from `prompt` (B, P), held to the
    single copy `G`'s logits over prompt + out[:, :-1] from position
    `start` (<= P - 1) by the margin rule (`lm_token_check`). The MoE
    family's reference routes as the served run did (`rec`, logged by
    `moe_recording`): its dropped assignments are reported per layer, and
    its own top-k must equal the served one wherever its k-th / (k+1)-th
    gap clears the margin of the roundings up to that layer. Returns (the
    line's entries, the reference's logits)."""
    convert, stages = mods[0], mods[1]
    from repro_torch.models import lm as lm_mod
    B, P = prompt.shape
    Gn = out.shape[1]
    seq = torch.cat([prompt, out[:, :-1].to("cuda")], dim=1)
    line, routes, routing = {}, None, None
    if cfg.family == "moe":
        routes, dropped = moe_served_routes(rec, cfg, mesh, B, P, Gn - 1,
                                            convert, stages)
        # capacity = all tokens at factor E / k: the single copy drops
        # only what the served run dropped
        pcfg = dataclasses.replace(
            pcfg, moe_capacity_factor=cfg.n_experts / cfg.experts_per_token)
        routing = [{"layer": i} for i in range(cfg.n_layers)]
    logits = fam_reference_logits(G, cfg, pcfg, stages, lm_mod, seq, frames,
                                  start, routes, routing, vis)
    if routes is not None:
        bad = [r for r in routing
               if r["equal_where_compared"] != r["compared"]]
        if bad:
            fail(f"lm {run}: routing differs from the single copy's where "
                 f"its top-k gap clears the margin: {bad}")
        line["moe"] = {"dropped_per_layer": dropped,
                       "assignments_per_layer":
                           B * (P + Gn - 1) * cfg.experts_per_token,
                       "routing": routing}
    line["tokens"] = lm_token_check(f"{run} at B={B}", out,
                                    logits[:, P - 1 - start:], cfg)
    return line, logits


def phase_fam_serve(run, cfg, params, mesh, tp, pcfg, ref_dtype, mods, ops,
                    ref, counts, gen, seed: int):
    """Phase 9 (per model) at (4, 16, 8): the session (or the audio
    pieces), every K1 call held BITWISE as it runs and replayed on
    normal values, K1 launches and collectives per decode step against
    the programs and the layouts; tokens against the single-copy
    reference by the margin rule (`fam_tokens`); the SSM handoff (9b,
    9c) held as derived below."""
    convert, stages, _sess, _conv, _launch = mods
    from repro_torch.models import lm as lm_mod
    from repro_torch.models import mlp as mlp_mod
    B, P, Gn = LM_SMALL
    dp = stages.dp_axes(mesh, B)
    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=g,
                           device="cuda", dtype=torch.int32)
    frames = fam_frames(cfg, B, seed) if cfg.encoder_layers else None
    server = FamServer(mods, cfg, pcfg, mesh, tp, B, P, Gn, frames)
    log = {"k1": [], "k4": []}
    steps: dict = {"session": []}
    seen: dict = {}

    def keep_prefill(fn):
        def pf(*a):
            seen["nxt"], seen["caches"] = res = fn(*a)
            return res
        return pf
    server.wrap(prefill=keep_prefill, decode=lambda fn: lm_counted_steps(
        fn, server.decode_ctx.engine, ops, steps["session"]))
    rec: list = []
    ops.reset_launch_counts()
    with lm_checked(ops, ref, log), moe_recording(mlp_mod, rec):
        out = server.generate(params, prompt, Gn)
        torch.cuda.synchronize()
    counts[f"lm_families_{run}"] = ops.launch_counts()
    del server.decode_ctx.engine._execute
    if counts[f"lm_families_{run}"]["fused_combine"] < 1:
        fail(f"lm {run}: no K1 launch")
    if cfg.family in ("ssm", "hybrid") and not log["ssd"]:
        fail(f"lm {run}: no SSD scan held to its plain version")
    line = {"phase": "lm_families_serve", "run": run,
            "shape": {"batch": B, "prompt": P, "gen": Gn},
            "path": "ServeSession" if frames is None else
            "build_prefill(frames) + convert_prefill_caches(s_enc) + "
            "build_decode_step(s_enc)"}

    # the SSM handoff: prefill's conv/state against teacher-forced decode
    # over the same prompt from zero carries. Both paths round the same
    # stream differently from the embedding on, so layer i's carries
    # differ by the noise of the roundings up to layer i: at most
    # LM_Z sqrt(2) eps_i of the layer's largest entry, eps_i =
    # lm_eps(cfg, i + 1). What the bound would let through is measured
    # too: per layer, the carries decode held a token early and the
    # handed-off ones halved, each against the same bound.
    if cfg.family in ("ssm", "hybrid"):
        dstep, dctx, _, _ = stages.build_decode_step(
            cfg, pcfg, mesh, s_max=P + Gn, global_batch=B, device="cuda")
        cache = stages.init_cache(cfg, pcfg, mesh, tp, B, P + Gn,
                                  device="cuda")
        steps["handoff"] = []
        counted = lm_counted_steps(dstep, dctx.engine, ops, steps["handoff"])
        ops.reset_launch_counts()
        with lm_checked(ops, ref, log):
            for t in range(P):
                _nxt, cache = counted(params, cache, convert.stack_global(
                    prompt[:, t:t + 1], mesh, (dp, None)), t)
                if t == P - 2:
                    early = [{k: c[k].double() for k in ("conv", "state")}
                             for c in cache]
            torch.cuda.synchronize()
        counts[f"lm_families_{run}_handoff"] = ops.launch_counts()
        del dctx.engine._execute
        per_layer: dict = {"bound": [], "conv": [], "state": []}
        caught = {f"{name}_{m}": 0 for name in ("conv", "state")
                  for m in ("token_early", "halved")}
        for i in range(cfg.n_layers):
            bound = LM_Z * 2 ** 0.5 * lm_eps(cfg, i + 1)
            per_layer["bound"].append(bound)
            for name, stack in (("conv", seen["caches"][-2]),
                                ("state", seen["caches"][-1])):
                dec = cache[i][name].double()
                got = stack[i].double()
                d = float((got - dec).abs().max())
                top = float(dec.abs().max())
                if d > bound * top:
                    fail(f"lm {run}: layer {i} prefill {name} differs from "
                         f"teacher-forced decode's by {d} (largest entry "
                         f"{top}, bound {bound * top})")
                per_layer[name].append(d / top)
                for m, wrong in (("token_early", early[i][name]),
                                 ("halved", got / 2)):
                    caught[f"{name}_{m}"] += bool(
                        (wrong - dec).abs().max() > bound * top)
        line["ssm_handoff"] = {
            "bound": f"{LM_Z} sqrt(2) eps_i of layer i's largest entry, "
                     f"eps_i = 2^-8 sqrt({LM_ROUNDINGS[cfg.family]} (i + 1) "
                     f"+ 1)",
            "max_rel_err": {k: max(per_layer[k]) for k in ("conv", "state")},
            "max_err_over_bound": max(
                e / b for k in ("conv", "state")
                for e, b in zip(per_layer[k], per_layer["bound"])),
            "layers_that_would_reject": caught, "per_layer": per_layer}
        del cache, early
    replayed = lm_replay_normal(ops, ref, log, gen)
    want = fam_step_collectives(cfg, tp, P + Gn, pcfg)
    line["decode_steps"] = {k: lm_check_steps(f"{run} {k}", v, want)
                            for k, v in steps.items()}

    # the single-copy reference on the session's own sequence
    G = fam_single_copy(params, cfg, mesh, tp, convert, stages, ref_dtype)
    checked, logits = fam_tokens(run, cfg, G, pcfg, mesh, mods, prompt, out,
                                 frames, rec, 0)
    line.update(checked)
    if cfg.family != "moe":
        # the bf16 forward's logit-gap error, against the margin
        seq = torch.cat([prompt, out[:, :-1].to("cuda")], dim=1)
        ctx = stages.make_ctx(cfg, dataclasses.replace(pcfg, serving=True),
                              mesh, "cuda")
        batch = {"tokens": convert.stack_global(seq, mesh, (dp, None))}
        if frames is not None:
            batch["frames"] = convert.stack_global(frames, mesh,
                                                   (dp, None, None))
        with torch.inference_mode():
            x, _ = lm_mod.forward(params, batch, cfg, ctx)
        x = convert.unstack(x, mesh, (dp, None, None)).to(logits.dtype)
        w = G["embed"] if cfg.tie_embeddings else G["head"]
        mine = (x @ w[0, 0, 0].T)[..., :cfg.vocab_size]
        best, _gap, margin = lm_margins(logits, cfg)
        top10 = logits.topk(10, dim=-1).indices
        d_gap = ((mine.gather(-1, top10) - mine.gather(-1, best[..., None]))
                 - (logits.gather(-1, top10)
                    - logits.gather(-1, best[..., None]))).abs().amax(-1)
        line["bf16_forward_gap_err_over_margin"] = float(
            (d_gap / margin).max())
        del x, mine
    line.update({
        "launches": counts[f"lm_families_{run}"],
        "k1_checked_bitwise": len(log["k1"]), "k1_replayed_normal": replayed,
        "copy_checked_bitwise": len(log["copy"]),
        **ssd_summary(log),
        "margin": f"{LM_Z} sqrt(2) eps rms(logits), eps = 2^-8 sqrt(n_r) = "
                  f"{lm_eps(cfg):.4f}",
        "reference": f"the port's modules on the (1, 1, 1) mesh, "
                     f"{str(ref_dtype).split('.')[-1]} weights",
        "generated": out.tolist()})
    emit(line)
    del G, logits, seen, server
    torch.cuda.empty_cache()


def phase_fam_times(phase, run, cfg, params, mesh, tp, pcfg, shapes, mods,
                    ops, ref, reps: int, smi: str, check=None) -> None:
    """Phases 8c and 9 (per model): prefill ms, the median decode step
    (CUDA events, >= 10 steps), tokens/s = B / step and generate seconds
    at each (batch, prompt, gen) of `shapes`, through `FamServer`, with
    one decode step's and one prefill's device time by kernel group, the
    idle share and the kernel launches of each. With `check` (prompt,
    out, frames, rec) -> the row's entries, the tokens generated at
    every shape after the first are held to the reference (the first's
    were in the serve phase); a MoE model's routings are logged
    (`moe_recording`) and an SSM or hybrid model's SSD scans held to
    their plain version (`ssd_checked`) during that generate, which its
    seconds include."""
    from repro_torch.models import mlp as mlp_mod
    rows = []
    for i, (B, P, Gn) in enumerate(shapes):
        frames = fam_frames(cfg, B, B) if cfg.encoder_layers else None
        server = FamServer(mods, cfg, pcfg, mesh, tp, B, P, Gn, frames)
        g = torch.Generator(device="cuda").manual_seed(B + P)
        prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=g,
                               device="cuda", dtype=torch.int32)
        batch = server.batch(prompt)
        torch.cuda.reset_peak_memory_stats()
        pf_ms = median_ms(lambda: server.prefill_fn(params, batch),
                          max(3, reps // 2))
        nxt, pf_caches = server.prefill_fn(params, batch)
        caches = server.handoff(pf_caches)
        del pf_caches
        tok = nxt[..., None]

        def step():
            return server.decode_fn(params, caches, tok, P)
        step_ms = median_ms(step, max(reps, 10))
        k0 = ops.launch_counts()["fused_combine"]
        step()
        k1_per_step = ops.launch_counts()["fused_combine"] - k0
        checked = check is not None and i > 0
        rec: list = []
        log: dict = {}
        ssd = checked and cfg.family in ("ssm", "hybrid")
        t0 = time.perf_counter()
        with (moe_recording(mlp_mod, rec) if checked
              else contextlib.nullcontext()), \
                (ssd_checked(ops, ref, log) if ssd
                 else contextlib.nullcontext()):
            out = server.generate(params, prompt, Gn)
        gen_s = time.perf_counter() - t0
        if ssd and not log["ssd"]:
            fail(f"lm {run} at B={B}: no SSD scan held to its plain version")
        if out.shape != (B, Gn) or not bool(((out >= 0)
                                             & (out < cfg.vocab_size)).all()):
            fail(f"lm {run} at B={B}: generated tokens {tuple(out.shape)} "
                 f"out of range")
        rows.append({"batch": B, "prompt": P, "gen": Gn,
                     "prefill_ms": pf_ms, "decode_step_ms": step_ms,
                     "tokens_per_s": B / (step_ms / 1e3),
                     "generate_s": gen_s, "k1_per_step": k1_per_step,
                     "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                     "profile": busy_and_idle(device_split(
                         step, _FAM_GROUPS, top=8), step_ms),
                     "prefill_profile": busy_and_idle(device_split(
                         lambda: server.prefill_fn(params, batch),
                         _FAM_GROUPS, top=8), pf_ms)})
        del server, caches, batch, nxt, tok
        torch.cuda.empty_cache()
        if checked:
            rows[-1].update(check(prompt, out, frames, rec))
        if ssd:
            rows[-1].update(ssd_summary(log))
    emit({"phase": phase, "run": run, "arch": cfg.name, "rows": rows,
          "card": smi})


def phase_lm_families(get_config, mods, ops, ref, counts, gen, seed: int,
                      reps: int, smi: str) -> None:
    """Phase 9: each model of FAM_RUNS built, served and checked, timed
    (its second shape's tokens checked too), then freed before the
    next."""
    convert, stages = mods[0], mods[1]
    from repro_torch.configs import ParallelConfig
    for run, arch, mesh, tp, depth, extra, ref_dtype, wide in FAM_RUNS:
        t0 = time.perf_counter()
        cfg, params = phase_fam_build(run, arch, mesh, tp, depth,
                                      get_config, stages, seed)
        pcfg = ParallelConfig(moe_capacity_factor=FAM_MOE_CF, **extra)
        phase_fam_serve(run, cfg, params, mesh, tp, pcfg, ref_dtype, mods,
                        ops, ref, counts, gen, seed)

        def check(prompt, out, frames, rec):
            G = fam_single_copy(params, cfg, mesh, tp, convert, stages,
                                ref_dtype)
            line, _logits = fam_tokens(run, cfg, G, pcfg, mesh, mods,
                                       prompt, out, frames, rec,
                                       prompt.shape[1] - 1)
            del G, _logits
            torch.cuda.empty_cache()
            return line
        phase_fam_times("lm_families_times", run, cfg, params, mesh, tp,
                        pcfg, (LM_SMALL, wide), mods, ops, ref, reps, smi,
                        check)
        del params, check
        torch.cuda.empty_cache()
        emit({"phase": "lm_families_done", "run": run,
              "seconds": time.perf_counter() - t0})


# --------------------------------------------------------------------------
# Phase 10: LM training
# --------------------------------------------------------------------------

TRAIN_SMALL = (8, 64)         # launch/train.py's (batch, seq)
TRAIN_LARGE = (8, 512)
TRAIN_LR = 3e-4               # launch/train.py's --lr
TRAIN_WARMUP = 20             # launch/train.py's cosine_warmup(s, 20, steps)
TRAIN_STEPS = 8               # 10e: the Trainer's total_steps
TRAIN_TRAINER_LAYERS = 4      # 10e's depth (of 28: the run's time)
TRAIN_CKPT_EVERY = 4
TRAIN_FAIL_AT = 6
TRAIN_RECOVERY_TOL = 1e-5     # tests/test_runtime.py::test_failure_recovery_exact
TRAIN_SYNC_ROUNDINGS = 4      # bf16 roundings of a synced gradient (`train_eps`)
# master/m/v on the card vs the CPU update, in ulps of the larger of the
# old and new master: m and v come from the same grads by the same IEEE
# ops; the master's step = (m / b1c) / (sqrt(v / b2c) + eps) takes 5
# roundings, each of which a device may round differently by <= 1 ulp
# (a pow, a division by reciprocal), each carried with a gain <= 1 into
# lr * step, then 3 more (lr * step, master * (1 - lr wd), the
# difference): <= 8
TRAIN_ADAMW_ULPS = 8
_TRAIN_GROUPS = _LM_GROUPS + (("sort", "sort (deterministic scatter)"),)
_OPT_NAMES = ("master", "m", "v")


@contextlib.contextmanager
def depth_cut(module, layers: int):
    """`module.get_config` cut to each architecture's first `layers`
    layers, at full width: a depth cut for the run's time."""
    real = module.get_config
    module.get_config = lambda name: dataclasses.replace(
        real(name), n_layers=layers)
    try:
        yield
    finally:
        module.get_config = real


def train_eps(cfg) -> float:
    """eps_g, the bound on each synced gradient leaf's relative L2 error
    against the single-copy reference: the forward's bf16 roundings as
    `lm_eps` counts them (10 L + 2 for a dense model), as many again in the
    backward (each bf16 activation's cotangent is rounded to bf16 where
    the activation was), and TRAIN_SYNC_ROUNDINGS for the gradient itself
    (its bf16 output and the bf16 hops of its sync), each at most
    u = 2^-8 relative, independent, so eps_g = u sqrt(2 (10 L + 2) + 4);
    a relative L2 norm is an RMS over the leaf, so no z-factor:
    0.0931 for qwen3-0.6b's 28 layers."""
    n = 2 * (LM_ROUNDINGS[cfg.family] * cfg.n_layers + 2) \
        + TRAIN_SYNC_ROUNDINGS
    return BF16_U * n ** 0.5


def train_unstack(tree, specs, convert, mesh) -> dict:
    """{path: global tensor} of a stacked param-shaped tree (replicated
    axes read the first copy)."""
    from repro_torch.tree import flatten
    spec_of = dict(flatten(specs))
    out = {}
    for path, t in flatten(tree):
        if path[0] in ("layers", "enc_layers"):
            t = t.movedim(0, len(mesh))
        out[path] = convert.unstack(t, mesh, spec_of[path])
    return out


def train_replicas_equal(tree, specs, mesh) -> int:
    """Fail unless every synced leaf's copies along the mesh axes its
    spec does not name are bitwise equal; returns the leaves checked."""
    from repro_torch.tree import flatten
    from repro_torch.parallel.ops import spec_axes
    spec_of = dict(flatten(specs))
    n = 0
    for path, t in flatten(tree):
        lay = int(path[0] in ("layers", "enc_layers"))
        for i, (a, size) in enumerate(mesh.items()):
            if size > 1 and a not in spec_axes(spec_of[path]):
                d = lay + i
                if not torch.equal(t, t.narrow(d, 0, 1).expand_as(t)):
                    fail(f"train: synced {'/'.join(path)} differs along "
                         f"{a}")
        n += 1
    return n


def train_single_copy(G):
    """The global float64 params {path: tensor} as the one rank of the
    (1, 1, 1) mesh, each layer-stacked leaf as a list of its layers (the
    train step's own layout for the backward)."""
    from repro_torch.tree import unflatten
    from repro_torch.parallel import stages
    one = (1, 1, 1)
    pairs = []
    for path, g in G.items():
        if path[0] in ("layers", "enc_layers"):
            pairs.append((path, [t.reshape(one + t.shape).requires_grad_()
                                 for t in g.unbind(0)]))
        else:
            pairs.append((path, g.reshape(one + g.shape).requires_grad_()))
    return unflatten(pairs)


def train_reference(G, cfg, batch, rows=None):
    """The single-copy reference of one step's loss and gradient: the
    port's own modules on the (1, 1, 1) mesh over float64 params (their
    products and norms compute in fp32 where the port's modules cast to
    it; 2^-24 against eps_g). Returns (ce_mean, rms of the logits,
    {path: gradient}). With `rows`, only those batch rows enter the loss,
    still divided by the whole batch's token count: one data rank's
    contribution."""
    from repro_torch.tree import flatten
    from repro_torch.configs import ParallelConfig
    from repro_torch.models import lm as lm_mod
    from repro_torch.parallel import stages
    ctx = stages.make_ctx(cfg, ParallelConfig(remat="none"), _ONE, "cuda")
    P1 = train_single_copy(G)
    tokens = batch["tokens"] if rows is None else batch["tokens"][rows]
    labels = batch["labels"] if rows is None else batch["labels"][rows]
    t_total = batch["labels"].numel()
    b1 = {"tokens": tokens.reshape((1, 1, 1) + tokens.shape).cuda(),
          "labels": labels.reshape((1, 1, 1) + labels.shape).cuda()}
    x, _aux = lm_mod.forward(P1, b1, cfg, ctx)
    ce_sum, _ = lm_mod.lm_head_ce(P1, x, b1["labels"], cfg, ctx)
    loss = ce_sum.sum() / t_total
    leaves = [(p, l) for p, l in flatten(
        {k: v for k, v in P1.items()})]
    flat = []
    for path, l in leaves:
        flat.extend(l if isinstance(l, list) else [l])
    grads = iter(torch.autograd.grad(loss, flat))
    out = {}
    for path, l in leaves:
        if isinstance(l, list):
            out[path] = torch.stack([next(grads)[0, 0, 0] for _ in l])
        else:
            out[path] = next(grads)[0, 0, 0]
    with torch.no_grad():
        xf = x.detach()[0, 0, 0].double()
        logits = xf @ G[("embed",)].T
        rms = float(logits[..., :cfg.vocab_size].pow(2).mean().sqrt())
    return float(loss.detach()), rms, out


def train_rel_errors(got: dict, want: dict) -> dict:
    """{path: ||got - want|| / ||want||} in float64."""
    return {p: float((got[p].double() - want[p]).norm()
                     / want[p].norm().clamp_min(1e-300)) for p in want}


def train_bucket_collectives(eng, grads_pre, specs) -> dict:
    """The programs the gradient sync runs, from the layout: the sync
    groups (leaves by their set of live mesh axes missing from the spec),
    the engine's own buckets over each group, and per bucket the
    programs of one allreduce over the group's axes as the engine
    resolves it: one two-level program, or reduce_scatter, allreduce,
    allgather over the inner and outer axes."""
    from repro_torch.tree import flatten
    from repro_torch.core import engine as em
    from repro_torch.parallel.ops import spec_axes
    mesh = eng.mesh_shape
    live = [a for a in mesh if mesh[a] > 1]
    spec_of = dict(flatten(specs))
    groups: dict = {}
    for path, g in flatten(grads_pre):
        miss = tuple(a for a in live if a not in spec_axes(spec_of[path]))
        if miss:
            if path[0] in ("layers", "enc_layers"):
                g = g.movedim(0, len(mesh))
            groups.setdefault(miss, []).append(g)
    lead = tuple(mesh.values())
    want: dict = {}
    for miss, leaves in groups.items():
        order = [a for a in ("data", "model") if a in miss] + \
                [a for a in miss if a not in ("data", "model")]
        for idxs in em._bucket_leaves(leaves, eng.BUCKET_BYTES, lead):
            n = sum(em._local_numel(leaves[i], lead) for i in idxs)
            x = torch.empty((n,), dtype=leaves[idxs[0]].dtype, device="meta")
            if len(order) == 1:
                names = ("allreduce",)
            else:
                sched = eng._resolve("allreduce", x, (order[1], order[0]),
                                     "auto")
                eng.trace_log.pop()
                names = ("allreduce",) if sched.level_sizes is not None \
                    else ("reduce_scatter", "allreduce", "allgather")
            for name in names:
                want[name] = want.get(name, 0) + 1
    return want


def train_layout_collectives(cfg, mesh, pcfg) -> dict:
    """The engine collectives of one train step's forward, backward and
    clip, from the layout (a dense model, FSDP over 'data', TP over
    'model', no SP): forward, per layer the FSDP allgathers of wq, wk,
    wv, wo, w1, w3, w2 and the attention and MLP finishes' allreduces;
    the embedding's gather and allreduce; the head's gather and the CE's
    three allreduces (max, denominator, picked logit); the ce_mean
    metric's allreduce over 'data'. Backward: each gather's adjoint
    reduce-scatter and each allreduce's adjoint allreduce, but for the
    CE's max (detached) and the metric's (no gradient). Clip: one
    scalar allreduce per live mesh axis."""
    if cfg.family != "dense" or pcfg.sequence_parallel:
        fail("train: the layout count covers a dense model without SP")
    L = cfg.n_layers
    return {"forward": {"allgather": 7 * L + 2,
                        "allreduce": 2 * L + 1 + 3 + 1},
            "backward": {"reduce_scatter": 7 * L + 2,
                         "allreduce": 2 * L + 1 + 2},
            "clip": {"allreduce": sum(1 for s in mesh.values() if s > 1)}}


class TrainProbe:
    """Instruments one train step's phases: CUDA events at the forward's
    start and end (`lm.loss_fn`), the grad sync's start and end
    (`stages.grad_sync`), and the optimizer's start and end
    (`adamw.adamw_update` .. `adamw.apply_updates`); the K1 launches and
    the programs the step's engine executes in each phase (forward,
    backward, sync, clip, optimizer); the grads going into and coming out
    of the sync; the peak memory of the forward and backward (read at the
    sync's entry; `train_run` makes it relative to the memory allocated
    when the step started). Launches nothing itself."""

    PHASES = ("forward", "backward", "sync", "clip", "optimizer")

    def __init__(self, mods, ops, engine):
        self.stages, self.adamw, self.lm = mods
        self.ops, self.engine = ops, engine
        self.steps = []

    def __enter__(self):
        st, aw, lm, ops = self.stages, self.adamw, self.lm, self.ops
        self.real = (st.grad_sync, aw.adamw_update, aw.apply_updates,
                     lm.loss_fn, self.engine._execute)
        r_sync, r_upd, r_apply, r_loss, r_exec = self.real

        def mark(phase):
            cur = self.cur
            k1 = ops.launch_counts()["fused_combine"]
            if cur["phase"] is not None:
                cur["k1"][cur["phase"]] += k1 - cur["k1_mark"]
            cur["phase"], cur["k1_mark"] = phase, k1
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            cur["events"].append((phase, ev))

        def loss_fn(*a, **k):
            self.cur = {"phase": None, "events": [], "progs": [],
                        "k1": dict.fromkeys(self.PHASES + ("end",), 0)}
            self.steps.append(self.cur)
            mark("forward")
            out = r_loss(*a, **k)
            mark("backward")
            return out

        def grad_sync(grads, *a, **k):
            self.cur["peak_fwd_bwd"] = torch.cuda.max_memory_allocated()
            mark("sync")
            out = r_sync(grads, *a, **k)
            self.cur["pre"], self.cur["synced"] = grads, out[0]
            mark("clip")
            return out

        def adamw_update(*a, **k):
            mark("optimizer")
            return r_upd(*a, **k)

        def apply_updates(*a, **k):
            out = r_apply(*a, **k)
            mark("end")
            return out

        def execute(sched, rows, lay, compression=None):
            self.cur["progs"].append((self.cur["phase"], sched,
                                      tuple(rows.shape), compression))
            return r_exec(sched, rows, lay, compression)

        st.grad_sync, aw.adamw_update, aw.apply_updates = \
            grad_sync, adamw_update, apply_updates
        lm.loss_fn = loss_fn
        self.engine._execute = execute
        return self

    def __exit__(self, *exc):
        st, aw, lm = self.stages, self.adamw, self.lm
        (st.grad_sync, aw.adamw_update, aw.apply_updates, lm.loss_fn,
         _exec) = self.real
        del self.engine._execute
        return False

    def phase_ms(self, step) -> dict:
        """Device time between the step's phase boundaries."""
        torch.cuda.synchronize()
        ev = step["events"]
        return {ev[i][0]: ev[i][1].elapsed_time(ev[i + 1][1])
                for i in range(len(ev) - 1)}

    def collectives(self, step) -> dict:
        out: dict = {}
        for phase, sched, _shape, _c in step["progs"]:
            d = out.setdefault(phase, {})
            d[sched.collective] = d.get(sched.collective, 0) + 1
        return out

    def implied_k1(self, step) -> dict:
        out = dict.fromkeys(self.PHASES, 0)
        for phase, sched, _shape, c in step["progs"]:
            out[phase] += implied_k1(
                sched.compile(codec=c, verify=self.engine.verify))
        return out


def train_restore(params, opt, backup) -> None:
    """Params back to `backup` and the optimizer state to its init, in
    place."""
    from repro_torch.tree import tree_map
    tree_map(lambda p, b: p.copy_(b), params, backup)
    tree_map(lambda l, p: (l["master"].copy_(p), l["m"].zero_(),
                                 l["v"].zero_()),
                   opt["leaves"], params,
                   is_leaf=lambda x: isinstance(x, dict) and "master" in x)
    opt["count"].zero_()


def train_adamw_cpu(ts, backup, synced, gnorm, adamw, schedules,
                    step_idx: int, opt_cfg) -> tuple:
    """The plain AdamW update on the CPU for the same synced grads, on a
    sample of the state (every leaf but the embedding whole, layer 0 of
    each layer-stacked leaf, the embedding's first 4096 rows), from the
    state `adamw_init` makes of the params `backup` (count 0): the clip
    scale from the step's norm, then `adamw_update` with its clip off."""
    from repro_torch.tree import flatten, unflatten
    def sample(path, t):
        if path[0] in ("layers", "enc_layers"):
            return t[:1]
        if path[0] == "embed":
            return t[..., :4096, :]
        return t
    cfg_noclip = dataclasses.replace(opt_cfg, grad_clip=1e30)
    scale = torch.clamp(opt_cfg.grad_clip / torch.clamp_min(
        gnorm.cpu(), 1e-9), max=1.0)
    D = len(ts.ctx.mesh_shape)
    grads, leaves = [], []
    for path, g in flatten(synced):
        lay = int(path[0] in ("layers", "enc_layers"))
        s = scale.reshape((1,) * lay + scale.shape
                          + (1,) * (g.ndim - D - lay))
        grads.append((path, sample(path, g).cpu().float() * s))
    for path, p in flatten(backup):
        master = sample(path, p).cpu().float()
        leaves.append((path, {"master": master,
                              "m": torch.zeros_like(master),
                              "v": torch.zeros_like(master)}))
    state = {"leaves": unflatten(leaves),
             "count": torch.zeros((), dtype=torch.int32)}
    lr_scale = schedules.cosine_warmup(step_idx, TRAIN_WARMUP, TRAIN_STEPS)
    new, _ = adamw.adamw_update(cfg_noclip, unflatten(grads), state,
                                lr_scale=lr_scale)
    return new, sample


def train_ulps(got, want, scale=None) -> float:
    """Largest distance between two fp32 tensors in ulps of `scale`
    (default `want`): the master update subtracts lr * step from the old
    master, so where the two nearly cancel, a one-ulp difference of an
    operand is many ulps of the result; its ulps are counted at the
    larger of the old and the new master."""
    got, want = got.double(), want.double()
    ref_mag = want.abs() if scale is None else torch.maximum(
        want.abs(), scale.double().abs())
    ulp = torch.finfo(torch.float32).eps * ref_mag.clamp_min(
        torch.finfo(torch.float32).tiny) / 2
    return float(((got - want).abs() / ulp).max())


def phase_train_build(cfg, stages, adamw, seed: int):
    """Phase 10 set-up: qwen3-0.6b's params drawn on the card from
    `seed` in the FSDP layout over the (1, 4, 2) mesh, a copy of them for
    each variant's restart, and the AdamW state."""
    from repro_torch.tree import leaves, tree_map
    free0, total = torch.cuda.mem_get_info()
    t0 = time.perf_counter()
    params = stages.init_params(cfg, LM_MESH, LM_TP, seed=seed,
                                device="cuda")
    backup = tree_map(lambda t: t.clone(), params)
    opt = adamw.adamw_init(params)
    torch.cuda.synchronize()
    emit({"phase": "train_build", "mesh": LM_MESH,
          "stacked_param_bytes": sum(t.numel() * t.element_size()
                                     for t in leaves(params)),
          "opt_state_bytes": sum(t.numel() * t.element_size()
                                 for t in leaves(opt["leaves"])),
          "init_seconds": time.perf_counter() - t0,
          "mem_free_before": free0, "mem_total": total})
    return params, backup, opt


def train_batch(data_mod, cfg, B: int, S: int, seed: int, step: int = 0):
    """Rows [0, B) of the port's SyntheticLM batch at `step`, as torch."""
    src = data_mod.SyntheticLM(data_mod.DataConfig(global_batch=B,
                                                   seq_len=S, seed=seed),
                               cfg)
    return {k: torch.from_numpy(v) for k, v in src.batch_at(step, 0,
                                                            B).items()}


def train_run(ts, params, opt, batch_t, probe_mods, ops, ref, log,
              step_idx: int = 0, checked: bool = True):
    """One train step under `TrainProbe` (and, `checked`, `lm_checked`:
    every K1 call bitwise, every K4 call within its bound, as it runs);
    returns (probe, the step's record, metrics)."""
    probe = TrainProbe(probe_mods, ops, ts.ctx.engine)
    batch = ts.put_batch(batch_t)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with probe, (lm_checked(ops, ref, log) if checked
                 else contextlib.nullcontext()):
        _p, _o, metrics = ts.fn(params, opt, batch, step_idx)
        torch.cuda.synchronize()
    step = probe.steps[-1]
    # the step's own memory above what was allocated when it started
    step["peak_fwd_bwd"] -= base
    step["peak_step"] = torch.cuda.max_memory_allocated() - base
    return probe, step, {k: float(v) for k, v in metrics.items()}


def phase_train(cfg, mods, ops, ref, counts, gen, seed: int, reps: int,
                smi: str) -> None:
    """Phase 10: qwen3-0.6b trained at full width on the (1, 4, 2) mesh
    (10a-10e, then the times)."""
    from repro_torch.tree import flatten
    (convert, stages, adamw, schedules, lm_mod, data_mod,
     train_launch) = mods
    from repro_torch.configs import ParallelConfig
    t_phase = time.perf_counter()
    torch.use_deterministic_algorithms(True, warn_only=True)
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR)

    def sched(s):
        return schedules.cosine_warmup(s, TRAIN_WARMUP, TRAIN_STEPS)
    probe_mods = (stages, adamw, lm_mod)
    params, backup, opt = phase_train_build(cfg, stages, adamw, seed)
    B, S = TRAIN_SMALL
    batch = train_batch(data_mod, cfg, B, S, seed)
    specs = stages.param_specs(cfg, LM_TP)
    eps_g = train_eps(cfg)
    log = {"k1": [], "k4": []}
    out: dict = {"eps_g": eps_g, "shape": {"batch": B, "seq": S}}

    # 10a: one step, remat none, the queue
    pcfg_a = ParallelConfig(remat="none", async_grad_sync=True)
    ts = stages.build_train_step(cfg, pcfg_a, LM_MESH, opt_cfg, sched,
                                 device="cuda")
    ops.reset_launch_counts()
    probe, st_a, m_a = train_run(ts, params, opt, batch, probe_mods, ops,
                                 ref, log)
    counts["train_10a"] = ops.launch_counts()
    k1_step = counts["train_10a"]["fused_combine"]
    implied = probe.implied_k1(st_a)
    colls = probe.collectives(st_a)
    want = train_layout_collectives(cfg, LM_MESH, pcfg_a)
    want["sync"] = train_bucket_collectives(ts.ctx.engine, st_a["pre"],
                                            specs)
    want["optimizer"] = {}
    got = {p: colls.get(p, {}) for p in ("forward", "backward", "sync",
                                         "clip", "optimizer")}
    if got != want:
        fail(f"train 10a: collectives per phase {got}, the layout "
             f"implies {want}")
    if sum(implied.values()) != k1_step or any(
            st_a["k1"][p] != implied[p] for p in implied):
        fail(f"train 10a: K1 launches per phase {st_a['k1']}, the "
             f"programs imply {implied}")
    q = ts.ctx.engine.queue.stats
    replicas = train_replicas_equal(st_a["synced"], specs, LM_MESH)
    # the AdamW update on the card against the plain update on the CPU
    gnorm = torch.full(tuple(LM_MESH.values()), m_a["grad_norm"],
                       dtype=torch.float32)
    new_cpu, sample = train_adamw_cpu(ts, backup, st_a["synced"], gnorm,
                                      adamw, schedules, 0, opt_cfg)
    ulps = {n: 0.0 for n in _OPT_NAMES}
    old_master = dict(flatten(backup))
    for path, leaf in flatten(new_cpu["leaves"]):
        node = opt["leaves"]
        for k in path[:-1]:
            node = node[k]
        card = sample(path[:-1], node[path[-1]]).cpu()
        prev = sample(path[:-1], old_master[path[:-1]]).cpu().float() \
            if path[-1] == "master" else None
        ulps[path[-1]] = max(ulps[path[-1]], train_ulps(card, leaf, prev))
    if max(ulps.values()) > TRAIN_ADAMW_ULPS:
        fail(f"train 10a: AdamW on the card differs from the CPU update by "
             f"{ulps} ulps")
    del new_cpu
    # against the single-copy reference (float64 weights)
    G = {p: g.double() for p, g in train_unstack(backup, specs,
                                                 convert, LM_MESH).items()}
    ce_ref, rms_ref, g_ref = train_reference(G, cfg, batch)
    g_a = train_unstack(st_a["synced"], specs, convert, LM_MESH)
    err_a = train_rel_errors(g_a, g_ref)
    ce_bound = LM_Z * 2 ** 0.5 * lm_eps(cfg) * rms_ref
    if abs(m_a["ce_mean"] - ce_ref) > ce_bound:
        fail(f"train 10a: ce_mean {m_a['ce_mean']} vs the reference's "
             f"{ce_ref} (bound {ce_bound})")
    worst = max(err_a, key=err_a.get)
    if err_a[worst] > eps_g:
        fail(f"train 10a: {'/'.join(worst)} grad off the reference by "
             f"{err_a[worst]} (relative L2; eps_g {eps_g})")
    # the check must be able to fail: three faulted grads
    faults = {"x2 (1/tp scale missing)": {p: 2 * g for p, g in g_a.items()},
              "x0.5": {p: 0.5 * g for p, g in g_a.items()}}
    _ce0, _rms0, g_r0 = train_reference(G, cfg, batch,
                                        rows=slice(0, B // LM_MESH["data"]))
    from repro_torch.parallel.ops import spec_axes
    fsdp = [p for p, s in flatten(specs) if "data" in spec_axes(s)]
    faults["one data rank (reduce-scatter missing)"] = {
        p: g_r0[p] for p in fsdp}
    caught = {}
    for name, fg in faults.items():
        errs = train_rel_errors(fg, {p: g_ref[p] for p in fg})
        if min(errs.values()) <= eps_g:
            fail(f"train 10a: the faulted grads '{name}' pass the bound")
        caught[name] = min(errs.values())
    del g_r0, faults
    out["10a"] = {
        "ce_mean": m_a["ce_mean"], "ce_ref": ce_ref, "ce_bound": ce_bound,
        "loss": m_a["loss"], "grad_norm": m_a["grad_norm"],
        "grad_rel_err_max": err_a[worst], "grad_rel_err_worst":
        "/".join(worst), "grad_rel_err": {"/".join(p): e
                                          for p, e in err_a.items()},
        "faults_min_rel_err": caught, "collectives": got,
        "k1_per_phase": {p: st_a["k1"][p] for p in implied},
        "k1_implied": implied, "k1_per_step": k1_step,
        "k4_per_step": counts["train_10a"]["matmul_tiled"],
        "queue_issued": q["issued"], "queue_coalesced":
        q["coalesced_requests"], "replicas_checked": replicas,
        "adamw_max_ulps": ulps, "adamw_ulp_bound": TRAIN_ADAMW_ULPS,
        "peak_fwd_bwd_bytes": st_a["peak_fwd_bwd"],
        "peak_step_bytes": st_a["peak_step"],
        "device_ms_by_phase": probe.phase_ms(st_a)}
    synced_a = st_a["synced"]
    pre_a = st_a["pre"]
    del st_a, probe

    # 10b: int8 gradient compression
    train_restore(params, opt, backup)
    ts_b = stages.build_train_step(
        cfg, dataclasses.replace(pcfg_a, grad_compression="int8"), LM_MESH,
        opt_cfg, sched, device="cuda")
    calls = []
    with recording(ops, ("quantize_int8_at", "dequantize_int8_at")) as (
            rec, _items):
        ops.reset_launch_counts()
        _pb, st_b, m_b = train_run(ts_b, params, opt, batch, probe_mods,
                                   ops, ref, log)
        counts["train_10b"] = c_b = ops.launch_counts()
        calls = [r[0] for r in rec]
    if not calls or calls != ["quantize_int8_at",
                              "dequantize_int8_at"] * (len(calls) // 2):
        fail(f"train 10b: indexed K2/K3 calls do not pair: {calls[:6]}")
    n_ex = len(calls) // 2
    if not c_b["quantize_blocks"] == c_b["dequantize_blocks"] == n_ex:
        fail(f"train 10b: {c_b} launches for {n_ex} compressed exchanges")
    # per synced leaf: within the codec's bound of 10a's (phase 4's rule
    # over the leaf's sync group, plus a bf16 rounding of each side)
    from repro_torch.parallel.ops import spec_axes as _axes
    codec = {}
    for (path, g_b), (_p, g_a0), (_q, pre) in zip(
            flatten(st_b["synced"]), flatten(synced_a),
            flatten(pre_a)):
        spec = dict(flatten(specs))[path]
        lay = int(path[0] in ("layers", "enc_layers"))
        dims = tuple(lay + i for i, a in enumerate(LM_MESH)
                     if LM_MESH[a] > 1 and a not in _axes(spec))
        if not dims:
            same(f"train 10b: unsynced {'/'.join(path)}", g_b, g_a0)
            continue
        n = math.prod(pre.shape[d] for d in dims)
        M = float(pre.float().abs().sum(dims).max())
        bound = (n - 1) * M * (1.0 / 254.0 + 2 * BF16_U)
        err = float((g_b.float() - g_a0.float()).abs().max())
        if not err <= bound:
            fail(f"train 10b: {'/'.join(path)} off 10a's by {err} "
                 f"(bound {bound})")
        codec["/".join(path)] = err / bound
    out["10b"] = {"ce_mean": m_b["ce_mean"], "compressed_exchanges": n_ex,
                  "launches": c_b, "err_over_bound_max": max(codec.values()),
                  "leaves_compressed": len(codec)}
    del st_b, ts_b, pre_a, _pb

    # 10c: sequence parallelism + the collective matmul (K4)
    train_restore(params, opt, backup)
    ts_c = stages.build_train_step(
        cfg, dataclasses.replace(pcfg_a, sequence_parallel=True,
                                 collective_matmul=True), LM_MESH, opt_cfg,
        sched, device="cuda")
    n_k4 = len(log["k4"])
    ops.reset_launch_counts()
    _pc, st_c, m_c = train_run(ts_c, params, opt, batch, probe_mods, ops,
                               ref, log)
    counts["train_10c"] = c_c = ops.launch_counts()
    if c_c["matmul_tiled"] < 1:
        fail("train 10c: the SP step launched no K4")
    err_c = train_rel_errors(train_unstack(st_c["synced"], specs,
                                           convert, LM_MESH), g_ref)
    worst_c = max(err_c, key=err_c.get)
    if err_c[worst_c] > eps_g or abs(m_c["ce_mean"] - ce_ref) > ce_bound:
        fail(f"train 10c: ce {m_c['ce_mean']} (ref {ce_ref}), "
             f"{'/'.join(worst_c)} rel err {err_c[worst_c]}")
    out["10c"] = {"ce_mean": m_c["ce_mean"], "launches": c_c,
                  "k4_checked": len(log["k4"]) - n_k4,
                  "k4_max_abs_err": max(log["k4"][n_k4:]),
                  "grad_rel_err_max": err_c[worst_c]}
    del st_c, ts_c, G, g_ref, _pc

    # 10d: remat="full"
    train_restore(params, opt, backup)
    ts_d = stages.build_train_step(
        cfg, dataclasses.replace(pcfg_a, remat="full"), LM_MESH, opt_cfg,
        sched, device="cuda")
    ops.reset_launch_counts()
    _pd, st_d, m_d = train_run(ts_d, params, opt, batch, probe_mods, ops,
                               ref, log)
    counts["train_10d"] = c_d = ops.launch_counts()
    # the recomputed forward re-issues its collectives (blocking, in the
    # backward phase); the K1 count still matches the programs run
    implied_d = _pd.implied_k1(st_d)
    if sum(implied_d.values()) != c_d["fused_combine"]:
        fail(f"train 10d: {c_d['fused_combine']} K1 launches, the programs "
             f"imply {implied_d}")
    bitwise = all(torch.equal(a, b) for (_p, a), (_q, b) in zip(
        flatten(st_d["synced"]), flatten(synced_a)))
    if not bitwise:
        fail("train 10d: remat='full' grads differ from remat='none'")
    if not st_d["peak_fwd_bwd"] < out["10a"]["peak_fwd_bwd_bytes"]:
        fail(f"train 10d: peak {st_d['peak_fwd_bwd']} not below 10a's "
             f"{out['10a']['peak_fwd_bwd_bytes']}")
    out["10d"] = {"grads_bitwise_equal_10a": bitwise,
                  "peak_fwd_bwd_bytes": st_d["peak_fwd_bwd"],
                  "k1_per_step": c_d["fused_combine"],
                  "k1_implied": implied_d,
                  "collectives": _pd.collectives(st_d),
                  "ce_mean": m_d["ce_mean"]}
    del st_d, ts_d, synced_a, _pd
    replayed = lm_replay_normal(ops, ref, log, gen)
    out["k1_checked_bitwise"] = len(log["k1"])
    out["copy_checked_bitwise"] = len(log["copy"])
    out["k1_replayed_normal"] = replayed
    out["k4_checked"] = len(log["k4"])
    del params, backup, opt, ts
    torch.cuda.empty_cache()

    # 10e: the Trainer through launch/train.py's code path
    import shutil
    import tempfile
    from repro_torch import configs as configs_mod
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    trajectories, events = {}, {}
    try:
        for name, inj in (("uninterrupted", None),
                          ("fail_at_6", (TRAIN_FAIL_AT,))):
            with depth_cut(configs_mod, TRAIN_TRAINER_LAYERS):
                trainer, _args = train_launch.build([
                    "--arch", cfg.name, "--full", "--steps",
                    str(TRAIN_STEPS), "--batch", str(B), "--seq", str(S),
                    "--ckpt", f"{tmp}/{name}", "--ckpt-every",
                    str(TRAIN_CKPT_EVERY), "--seed", str(seed)])
            if inj is not None:
                from repro_torch.runtime import FailureInjector
                trainer.injector = FailureInjector(fail_at=inj)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            log_t = trainer.run()
            counts[f"train_trainer_{name}"] = ops.launch_counts()
            trajectories[name] = {r["step"]: r["ce_mean"] for r in log_t
                                  if "step" in r}
            events[name] = {"events": [r["event"] for r in log_t
                                       if "event" in r],
                            "seconds": time.perf_counter() - t0,
                            "disk_free": shutil.disk_usage(tmp).free,
                            "last": {k: v for k, v in log_t[-1].items()
                                     if k != "dt"}}
            del trainer
            shutil.rmtree(f"{tmp}/{name}", ignore_errors=True)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ref_t, rec_t = trajectories["uninterrupted"], trajectories["fail_at_6"]
    # the failed attempt's rows are lost with it (as the reference's);
    # the restart resumes after the checkpoint of step 3
    if events["fail_at_6"]["events"] != ["failure"] or \
            sorted(rec_t) != list(range(TRAIN_CKPT_EVERY, TRAIN_STEPS)):
        fail(f"train 10e: events {events}, steps {sorted(rec_t)}")
    gap = max(abs(ref_t[s] - rec_t[s]) for s in rec_t)
    if not gap <= TRAIN_RECOVERY_TOL:
        fail(f"train 10e: the recovered trajectory is off by {gap}")
    out["10e"] = {"ce_mean": ref_t, "max_gap": gap, "runs": events,
                  "deterministic_algorithms": True}
    out["seconds_checks"] = time.perf_counter() - t_phase
    emit({"phase": "train", **out})
    torch.use_deterministic_algorithms(False)
    phase_train_times(cfg, mods, ops, counts, seed, reps, smi)


def phase_train_times(cfg, mods, ops, counts, seed: int, reps: int,
                      smi: str) -> None:
    """Phase 10f: the median step (CUDA events, >= 5 steps after a
    warm-up) and tokens/s at (8, 64) and (8, 512), the peak memory, the
    launches per step, one step's device time by kernel group and by
    phase (forward, backward, grad sync, clip, optimizer) and the idle
    share."""
    (_convert, stages, adamw, schedules, lm_mod, data_mod,
     _train_launch) = mods
    from repro_torch.configs import ParallelConfig
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR)
    params = stages.init_params(cfg, LM_MESH, LM_TP, seed=seed,
                                device="cuda")
    opt = adamw.adamw_init(params)
    ts = stages.build_train_step(
        cfg, ParallelConfig(remat="none"), LM_MESH, opt_cfg,
        lambda s: schedules.cosine_warmup(s, TRAIN_WARMUP, TRAIN_STEPS),
        device="cuda")
    rows = []
    for B, S in (TRAIN_SMALL, TRAIN_LARGE):
        batch = ts.put_batch(train_batch(data_mod, cfg, B, S, seed))
        i = [0]

        def step():
            i[0] += 1
            return ts.fn(params, opt, batch, i[0])
        torch.cuda.reset_peak_memory_stats()
        ms = median_ms(step, max(reps // 2, 5))
        peak = torch.cuda.max_memory_allocated()
        probe = TrainProbe((stages, adamw, lm_mod), ops, ts.ctx.engine)
        ops.reset_launch_counts()
        with probe:
            step()
        phases = probe.phase_ms(probe.steps[-1])
        counts[f"train_times_{B}x{S}"] = c = ops.launch_counts()
        rows.append({"batch": B, "seq": S, "step_ms": ms,
                     "tokens_per_s": B * S / (ms / 1e3),
                     "peak_mem_bytes": peak, "k1_per_step":
                     c["fused_combine"], "k4_per_step": c["matmul_tiled"],
                     "device_ms_by_phase": phases,
                     "profile": busy_and_idle(device_split(
                         step, _TRAIN_GROUPS, top=8), ms)})
        del batch
        torch.cuda.empty_cache()
    emit({"phase": "train_times", "arch": cfg.name, "mesh": LM_MESH,
          "rows": rows, "card": smi})
    del params, opt, ts
    torch.cuda.empty_cache()


RING_RANKS = 8                # context-parallel ranks: 4096 tokens each
RING_TOKENS = 32768           # SHAPES["prefill_32k"].seq_len
RING_RUNS = (("causal", True, 1), ("full", False, 1),
             ("causal_seg4", True, 4))
RING_Q_BLOCK = 1024           # query rows per block of the float64 reference
# 11a's rms check: each bf16 rounding (p_j before the PV product, the
# output) a relative error of mean square u^2 / (3 m^2) at mantissa m,
# 0.18 u^2 over log-uniform mantissas, so the error's variance is
# RING_RMS_VAR u^2 (P^2 @ v^2 + out^2) per element; the measured rms over
# that model's must stay within RING_RMS_LIMIT. The port sits at 0.87-0.97
# of it on the CPU (2048-4096 tokens), a port whose q @ k is a bf16
# product at 1.50-1.88, and phase 11a holds that control above the limit.
RING_RMS_VAR = 0.18
RING_RMS_LIMIT = 1.2
# 11a's peak above the inputs: at segments 1 the score tensor, its
# shifted copy, p and p's bf16 round trip live at once (3.5 stacked fp32
# score tensors) beside the fp32 state and upcasts (~0.8 GB); at segments
# 4 every score tensor is a quarter of that, so the peak is within
# RING_SEG_PEAK_SLACK of a quarter of the segments-1 peak
RING_PEAK_TENSORS = 4.0
RING_SEG_PEAK_SLACK = 1.25
_RING_GROUPS = (("gemm", "cuBLAS"), ("xmma", "cuBLAS"),
                ("cutlass", "cuBLAS"), ("nvjet", "cuBLAS"),
                ("index", "gather"),
                ("elementwise", "elementwise"), ("reduce", "reductions"))
# 11b: the peak of live bytes the meta run counts against the card's
# allocator, both above the step's start. On 'meta' every kernel entry
# point makes its output alone, as the kernel does on the card, so both
# runs make the same storages; the caching allocator rounds each block
# up to 512 B, at most 2.6 MB over ~5000 blocks live at the peak, 9e-5 of
# the ~30 GB peak (measured on the card: within 3.2e-7).
DRY_PEAK_MARGIN = 1e-4
DRY_PROD_LAYERS = 7           # the 16 x 16 cell's depth (of 28: the time)
# 11b's cells (a)-(f) hold the meta run's peak of live bytes against the
# card's peak of requested bytes (the caching allocator's count before it
# rounds a request up to 512 B or hands out a cached block whole), within
# the workspace a library call holds while it runs and no tensor owns
# (CUB's temp storage under sort, topk and cumsum: the MoE's routing),
# which the meta run cannot see and `AllocProbe` measures in bytes
DRY_MOE_MESH = {"pod": 1, "data": 1, "model": 8}
DRY_MOE_LAYERS = 2            # (b): 9a's depth
DRY_SSM_LAYERS = 6            # (c): 9b's depth
DRY_AUDIO_LAYERS = 3          # (d): 9d's encoder and decoder depth
DRY_PREFILL = (4, 16)         # (b), (c): phase 9's prompt, LM_SMALL's
DRY_DLRM_BATCH = 32


def ring_reference(q, k, v, causal: bool, lo: int = 0, hi: int = None,
                   block: int = None) -> tuple:
    """Exact attention of the bf16 inputs in float64 on the card, in
    blocks of `block` (default RING_Q_BLOCK) queries: (out, P @ |v|,
    P^2 @ v^2), each (S, H, hd), P the float64 softmax (the scales of p's
    roundings: on every rounding at once, and on their sum in mean
    square). With `lo` / `hi`: the queries [lo, hi) alone, each
    (hi - lo, H, hd)."""
    block = block or RING_Q_BLOCK
    S, H, hd = q.shape[1:]
    hi = S if hi is None else hi
    g = H // k.shape[2]
    kh = k[0].double().permute(1, 0, 2).repeat_interleave(g, 0)
    vh = v[0].double().permute(1, 0, 2).repeat_interleave(g, 0)
    va, v2 = vh.abs(), vh.square()
    out = torch.empty((hi - lo, H, hd), dtype=torch.float64, device="cuda")
    mag, pv2 = torch.empty_like(out), torch.empty_like(out)
    for i0 in range(lo, hi, block):
        cols = i0 + block if causal else S
        rows = slice(i0 - lo, i0 - lo + block)
        qb = q[0, i0:i0 + block].double().permute(1, 0, 2)
        s = torch.bmm(qb, kh[:, :cols].transpose(1, 2)) / math.sqrt(hd)
        if causal:
            pos = torch.arange(i0, i0 + block, device="cuda")
            s.masked_fill_(torch.arange(cols, device="cuda")[None, None, :]
                           > pos[None, :, None], -math.inf)
        s -= s.amax(-1, keepdim=True)
        s.exp_()
        s /= s.sum(-1, keepdim=True)
        out[rows] = torch.bmm(s, vh[:, :cols]).permute(1, 0, 2)
        mag[rows] = torch.bmm(s, va[:, :cols]).permute(1, 0, 2)
        pv2[rows] = torch.bmm(s.square_(), v2[:, :cols]).permute(1, 0, 2)
        del s
    return out, mag, pv2


def ring_bound(ref, mag, K: int):
    """Per-element bound on |ring - exact| for bf16 ring attention over K
    keys: the output's rounding to bf16 (u |out|, u = 2^-8), p's rounding
    to bf16 before the PV product (u per p_j, so u (P @ |v|) once
    normalized), and the fp32 sums over K keys of the PV accumulator and
    of l (K 2^-24 each, on P @ |v|); the fp32 scores (hd = 128 terms) and
    rescalings add ~2^-20."""
    return BF16_U * ref.abs() + (BF16_U + 2 * K * 2.0 ** -24
                                 + 2.0 ** -20) * mag


def ring_rms(got, ref, pv2) -> float:
    """The rms of got - ref over the rms the bf16 roundings of p and of
    the output give (RING_RMS_VAR): ~0.9 for fp32 scores."""
    var = RING_RMS_VAR * BF16_U ** 2 * (pv2 + ref.square())
    return math.sqrt(float((got - ref).square().sum() / var.sum()))


@contextlib.contextmanager
def ring_bf16_scores():
    """The control of 11a's rms check: ring attention with its scores
    formed as a bf16 product of the bf16 q and k (rounded to bf16) in
    place of the fp32 product of their exact upcasts."""
    real = torch.einsum

    def einsum(eq, *operands):
        if eq == "rbqkgh,rbskh->rbkgqs":
            return real(eq, *[t.bfloat16() for t in operands]).float()
        return real(eq, *operands)

    torch.einsum = einsum
    try:
        yield
    finally:
        torch.einsum = real


def phase_ring_attention(CollectiveEngine, cfg, attn_mod, gen, reps: int,
                         smi: str) -> None:
    """Phase 11a: the engine's `ring_attention` at qwen3-0.6b's attention
    width (16 q heads, 8 kv heads, head_dim 128, bf16) over one sequence
    of 32768 tokens, context-parallel over 8 ranks; causal and full at
    segments 1, causal at segments 4. Each run against a float64 exact
    attention of the same bf16 inputs within `ring_bound` and within
    RING_RMS_LIMIT of the rms its bf16 roundings give (`ring_rms`; the
    same run with bf16 scores must break that), segments 4 against
    segments 1 within twice the rounding terms, the trace_log entry, the
    peak memory above the inputs (RING_PEAK_TENSORS score tensors at
    segments 1, about a quarter of that at segments 4), then times
    (median of >= 5 calls, device busy time and idle share) beside the
    port's
    single-copy `chunked_attention` over the same tokens (plain torch
    both: neither is a kernel's time)."""
    t_phase = time.perf_counter()
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    dtype = torch.bfloat16
    S, n = RING_TOKENS, RING_RANKS
    sl = S // n
    q, k, v = (torch.randn((1, S, h, hd), generator=gen, device="cuda")
               .to(dtype) for h in (H, KV, KV))

    def stack(t):       # (1, S, h, hd) -> (n, 1, S / n, h, hd)
        return t.reshape(1, n, sl, *t.shape[2:]).movedim(1, 0).contiguous()

    def unstack(t):
        return t.movedim(0, 1).reshape(1, S, *t.shape[3:])

    eng = CollectiveEngine({"x": n}, device="cuda")
    qs, ks, vs = stack(q), stack(k), stack(v)
    refs = {c: ring_reference(q, k, v, c) for c in (True, False)}
    score_bytes = n * H * sl * sl * 4
    out, runs = {}, {}
    for name, causal, segs in RING_RUNS:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eng.trace_log.clear()
        y = eng.ring_attention(qs, ks, vs, "x", causal=causal, segments=segs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        want_log = [("ring_attention", "ring", "x", sl * KV * hd * 2)]
        if eng.trace_log != want_log:
            fail(f"ring {name}: trace_log {eng.trace_log}, want {want_log}")
        if y.shape != qs.shape or y.dtype != dtype:
            fail(f"ring {name}: {tuple(y.shape)} {y.dtype}")
        g = unstack(y)[0].double()
        ref, mag, pv2 = refs[causal]
        err = (g - ref).abs()
        bound = ring_bound(ref, mag, S)
        if not bool(torch.isfinite(g).all()) or not bool((err <= bound).all()):
            fail(f"ring {name}: {int((err > bound).sum())} elements outside "
                 f"the float64 bound (max err {float(err.max())})")
        rms = ring_rms(g, ref, pv2)
        if rms > RING_RMS_LIMIT:
            fail(f"ring {name}: rms error {rms} x the bf16 roundings' "
                 f"(limit {RING_RMS_LIMIT})")
        if segs == 1 and peak > RING_PEAK_TENSORS * score_bytes:
            fail(f"ring {name}: peak {peak} B above the inputs, over "
                 f"{RING_PEAK_TENSORS} score tensors of {score_bytes} B")
        out[name] = y
        runs[name] = {"causal": causal, "segments": segs,
                      "max_abs_err": float(err.max()),
                      "err_over_bound_max": float((err / bound).max()),
                      "rms_err_over_model": rms,
                      "peak_bytes": peak, "score_tensor_bytes": score_bytes}
        del g, err, bound
    seg4_peak = runs["causal_seg4"]["peak_bytes"]
    if seg4_peak * 4 > RING_SEG_PEAK_SLACK * runs["causal"]["peak_bytes"]:
        fail(f"ring: the segments-4 peak {seg4_peak} is not about a quarter "
             f"of the segments-1 peak {runs['causal']['peak_bytes']}")
    # the control: bf16 scores must break the rms check
    control = {}
    for name, causal, segs in RING_RUNS[:2]:
        with ring_bf16_scores():
            y = eng.ring_attention(qs, ks, vs, "x", causal=causal,
                                   segments=segs)
        ref, _mag, pv2 = refs[causal]
        control[name] = ring_rms(unstack(y)[0].double(), ref, pv2)
        if control[name] <= RING_RMS_LIMIT:
            fail(f"ring {name}: bf16 scores give {control[name]} x the "
                 f"model's rms, within the limit: the check cannot see them")
        del y
    eng.trace_log.clear()
    # segments 4 against segments 1: the same sums split otherwise — p's
    # bf16 roundings and the fp32 sums differ, each side within its share
    ref, mag, _pv2 = refs[True]
    d = (unstack(out["causal_seg4"])[0].double()
         - unstack(out["causal"])[0].double()).abs()
    seg_bound = 2 * (BF16_U * ref.abs() + (BF16_U + 2 * S * 2.0 ** -24)
                     * mag)
    if not bool((d <= seg_bound).all()):
        fail(f"ring causal_seg4 vs seg1: {int((d > seg_bound).sum())} "
             f"elements outside the bound (max {float(d.max())})")
    runs["causal_seg4"]["vs_seg1_max_abs"] = float(d.max())
    # the single-copy attention over the same tokens (plain torch)
    single = attn_mod.chunked_attention(q, k, v, causal=True)
    err = (single[0].double() - ref).abs()
    single_ok = bool((err <= ring_bound(ref, mag, S)).all())
    if not single_ok:
        fail("ring: the single-copy chunked_attention is outside the bound")
    del out, refs, d, seg_bound, single, ref, mag, err, _pv2, pv2
    torch.cuda.empty_cache()
    times = {}
    fns = {name: (lambda c=c, s=s: eng.ring_attention(
        qs, ks, vs, "x", causal=c, segments=s))
        for name, c, s in RING_RUNS}
    fns["single_copy_chunked_causal"] = lambda: attn_mod.chunked_attention(
        q, k, v, causal=True)
    for name, fn in fns.items():
        ms = median_ms(fn, max(reps // 2, 5))
        times[name] = busy_and_idle(device_split(fn, _RING_GROUPS, top=4), ms)
        torch.cuda.empty_cache()
    emit({"phase": "ring_attention", "arch": cfg.name, "heads": H,
          "kv_heads": KV, "head_dim": hd, "tokens": S, "ranks": n,
          "dtype": "bfloat16", "runs": runs,
          "rms_limit": RING_RMS_LIMIT, "control_bf16_scores_rms": control,
          "times": times,
          "single_copy_within_bound": single_ok, "card": smi,
          "seconds": time.perf_counter() - t_phase})
    del q, k, v, qs, ks, vs, eng
    torch.cuda.empty_cache()


def dry_phase_k1(probe_step, programs) -> dict:
    """K1 launches per phase that the meta run's programs imply, each
    program given the phase the card's run of the same position had."""
    if len(programs) != len(probe_step["progs"]):
        fail(f"dryrun: the meta run executed {len(programs)} programs, the "
             f"card's step {len(probe_step['progs'])}")
    out: dict = {}
    for (phase, _s, _shape, _c), (_n, sched, _sh, codec, _ax) in zip(
            probe_step["progs"], programs):
        out[phase] = out.get(phase, 0) + implied_k1(
            sched.compile(codec=codec))
    return out


def phase_dryrun(cfg, mods, ops, ref, counts, seed: int, smi: str) -> None:
    """Phase 11b: `launch/dryrun.py`'s counters on 'meta' against the card.
    Phase 10's cell (qwen3-0.6b at full width, the (1, 4, 2) mesh, (8,
    512), remat none) runs once on 'meta' and once for real on the card
    under the same counters, after a warm-up step under `lm_checked`
    (every K1 call bitwise, every K4 call within its bound, at these
    shapes; as many checked as the counted step launches): FLOPs equal
    exactly, the argument bytes (params, AdamW state, batch) equal the card's, the
    programs the engine ran equal in order and K1's launches per phase
    equal what the meta run's programs imply; the meta run's peak of live
    bytes within DRY_PEAK_MARGIN of the card's allocator peak above the
    step's start. Then the same with SP + the collective matmul (K4's
    products counted at its wrapper on the card, as aten products on
    'meta'), and one production cell, qwen3-0.6b train_4k on the
    single-pod 16 x 16 mesh, on 'meta' alone."""
    (convert, stages, adamw, schedules, lm_mod, data_mod, _tl) = mods
    from repro_torch.configs import ParallelConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import analysis, dryrun
    t_phase = time.perf_counter()
    B, S = TRAIN_LARGE
    cell = ShapeConfig("phase10", S, B, "train")
    out: dict = {"cell": {"arch": cfg.name, "mesh": LM_MESH, "batch": B,
                          "seq": S}}
    params = stages.init_params(cfg, LM_MESH, LM_TP, seed=seed,
                                device="cuda")
    opt = adamw.adamw_init(params)
    batch_t = train_batch(data_mod, cfg, B, S, seed)
    for variant, pcfg in (
            ("base", ParallelConfig(remat="none")),
            ("sp_collective_matmul", ParallelConfig(
                remat="none", sequence_parallel=True,
                collective_matmul=True))):
        t0 = time.perf_counter()
        fn, eng_m, args_m = dryrun.build_cell(cfg, cell, LM_MESH, pcfg)
        res_m, st_m = analysis.count(fn, [eng_m])
        mem_m = analysis.memory(args_m, res_m, st_m, LM_MESH)
        meta_s = time.perf_counter() - t0
        del fn, res_m, args_m
        ts = stages.build_train_step(cfg, pcfg, LM_MESH, adamw.AdamWConfig(),
                                     device="cuda")
        batch = ts.put_batch(batch_t)
        # warm-up (cuBLAS workspaces), every kernel call checked
        log = {"k1": [], "k4": []}
        ops.reset_launch_counts()
        with lm_checked(ops, ref, log):
            ts.fn(params, opt, batch, 0)
            torch.cuda.synchronize()
        checked = {"fused_combine": len(log["k1"]),
                   "matmul_tiled": len(log["k4"]),
                   "region_copy": len(log["copy"])}
        k4_err = max(log["k4"], default=None)
        del log
        probe = TrainProbe((stages, adamw, lm_mod), ops, ts.ctx.engine)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        k4_0 = ops.kernel_flops()
        with probe, analysis.counting([ts.ctx.engine]) as st_c:
            ts.fn(params, opt, batch, 1)
            torch.cuda.synchronize()
        counts[f"dryrun_{variant}"] = c = ops.launch_counts()
        k4_flops = ops.kernel_flops() - k4_0
        peak_card = torch.cuda.max_memory_allocated() - base
        arg_card, _ = analysis.arg_bytes((params, opt, batch), LM_MESH)
        step = probe.steps[-1]
        if st_c.flops != st_m.flops:
            fail(f"dryrun {variant}: FLOPs on the card {st_c.flops}, on "
                 f"meta {st_m.flops}")
        if arg_card != mem_m["argument_bytes"]:
            fail(f"dryrun {variant}: argument bytes per rank on the card "
                 f"{arg_card}, on meta {mem_m['argument_bytes']}")
        key = [(p[0], p[2], p[3], p[4]) for p in st_m.programs]
        if key != [(p[0], p[2], p[3], p[4]) for p in st_c.programs]:
            fail(f"dryrun {variant}: the programs differ from the card's")
        implied = dry_phase_k1(step, st_m.programs)
        k1_meta = {p: implied.get(p, 0) for p in TrainProbe.PHASES}
        k1_card = {p: step["k1"][p] for p in TrainProbe.PHASES}
        if k1_meta != k1_card or sum(k1_card.values()) != c["fused_combine"]:
            fail(f"dryrun {variant}: K1 per phase on the card {k1_card}, "
                 f"the meta run's programs imply {k1_meta}")
        if variant != "base" and not c["matmul_tiled"]:
            fail("dryrun: the SP step launched no K4")
        if not checked["fused_combine"] or any(
                checked[k] != c[k] for k in checked):
            fail(f"dryrun {variant}: the warm-up checked {checked}, the "
                 f"counted step launched {c}")
        ratio = peak_card / st_m.peak_bytes
        if abs(ratio - 1) > DRY_PEAK_MARGIN:
            fail(f"dryrun {variant}: the card's peak {peak_card} is "
                 f"{ratio:.4f} x the meta run's {st_m.peak_bytes}")
        out[variant] = {
            "flops": st_m.flops, "flops_card": st_c.flops,
            "k4_flops_card": k4_flops,
            "argument_bytes_per_rank": arg_card,
            "memory_meta_per_rank": mem_m,
            "programs": len(st_m.programs),
            "coll_by_kind": st_m.coll_by_kind,
            "coll_wire_bytes_per_rank": st_m.coll_wire_bytes,
            "k1_per_phase": k1_meta, "launches": c,
            "k1_checked_bitwise": checked["fused_combine"],
            "k4_checked": checked["matmul_tiled"], "k4_max_abs_err": k4_err,
            "copy_checked_bitwise": checked["region_copy"],
            "peak_meta_bytes": st_m.peak_bytes,
            "peak_tracked_card_bytes": st_c.peak_bytes,
            "peak_allocator_card_bytes": peak_card,
            "peak_card_over_meta": ratio, "peak_margin": DRY_PEAK_MARGIN,
            "meta_seconds": meta_s}
        del ts, batch, probe, st_c, st_m
        torch.cuda.empty_cache()
    del params, opt
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with depth_cut(dryrun, DRY_PROD_LAYERS):
        prod = dryrun.run_cell(cfg.name, "train_4k", False,
                               ParallelConfig())
    if prod.get("status") != "OK":
        fail(f"dryrun train_4k: {prod.get('status')}")
    out["production_cell"] = {
        k: prod[k] for k in ("arch", "shape", "mesh", "chips", "memory",
                             "fits_hbm", "model_flops_ratio", "hw")}
    out["production_cell"].update(
        n_layers=DRY_PROD_LAYERS, dominant=prod["roofline"]["dominant"],
        coll_wire_bytes_per_device=prod["roofline"][
            "coll_wire_bytes_per_device"],
        host_seconds=time.perf_counter() - t0)
    out["seconds"] = time.perf_counter() - t_phase
    out["card"] = smi
    emit({"phase": "dryrun", **out})


class AllocProbe(TorchDispatchMode):
    """A dispatch mode over one step on the card: the most bytes one op
    requested from the caching allocator beyond its live bytes before and
    after it (a library call's workspace, which no tensor owns). It
    resets the allocator's peak statistics at every op."""

    scratch = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        stats = torch.cuda.memory_stats_as_nested_dict
        pre = stats()["requested_bytes"]["all"]["current"]
        torch.cuda.reset_peak_memory_stats()
        out = func(*args, **(kwargs or {}))
        post = stats()["requested_bytes"]["all"]
        self.scratch = max(self.scratch,
                           post["peak"] - max(pre, post["current"]))
        return out


def dry_card_cell(name: str, meta, card, mesh: dict, ops, ref, counts,
                  smi: str) -> dict:
    """One 11b cell: the step `meta` (`dryrun.build_cell` or
    `build_dlrm_cell`: thunk, engine, argument tree on 'meta') runs once
    under the dry run's counters; then `card` (thunk, engine, argument
    tree on the card, the same step) runs a warm-up under `proc_checked`
    (every K1, K2, K3, K5 call BITWISE its plain version, every K4 call
    within `k4_within`) and `AllocProbe`, and once counted. Fails unless FLOPs, argument
    bytes and the argument bytes the step never read are equal, the
    engine's programs equal in order, the card's launches of each kernel
    equal the launches the meta run's entry points imply (and the
    warm-up held as many calls), and the meta run's peak of live bytes is
    within the largest workspace one op held (`AllocProbe`) of the card's
    peak of requested bytes above the step's start (the allocated peak,
    rounded and in whole cached blocks, is reported beside it)."""
    from repro_torch.core import engine as engine_mod
    from repro_torch.launch import analysis
    fn_m, eng_m, args_m = meta
    step, eng_c, args_c = card
    shapes_m = [(tuple(t.shape), t.dtype) for t in analysis.tensors(args_m)]
    if shapes_m != [(tuple(t.shape), t.dtype)
                    for t in analysis.tensors(args_c)]:
        fail(f"dryrun {name}: the card's arguments are not the meta run's")
    # the executor caches its region indices by device: both counted runs
    # start from an empty cache, so both make their indices in the step
    t0 = time.perf_counter()
    engine_mod._INDEX_CACHE.clear()
    res_m, st_m = analysis.count(fn_m, [eng_m])
    mem_m = analysis.memory(args_m, res_m, st_m, mesh)
    meta_s = time.perf_counter() - t0
    del res_m
    t0 = time.perf_counter()
    checked = dict.fromkeys(ops.KERNELS, 0)
    ops.reset_launch_counts()
    with proc_checked(ops, ref, checked, on_fail=fail), AllocProbe() as probe:
        step()
        torch.cuda.synchronize()
    warm = ops.launch_counts()
    engine_mod._INDEX_CACHE.clear()
    base = torch.cuda.memory_stats()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    with analysis.counting([eng_c]) as st_c:
        res_c = step()
        torch.cuda.synchronize()
    step_s = time.perf_counter() - t1
    counts[f"dryrun_{name}"] = c = ops.launch_counts()
    top = torch.cuda.memory_stats()
    peak_card = top["requested_bytes.all.peak"] - base[
        "requested_bytes.all.current"]
    peak_allocated = top["allocated_bytes.all.peak"] - base[
        "allocated_bytes.all.current"]
    mem_c = analysis.memory(args_c, res_c, st_c, mesh)
    del res_c
    card_s = time.perf_counter() - t0
    launched = {k: v for k, v in c.items() if v}
    if st_c.flops != st_m.flops:
        fail(f"dryrun {name}: FLOPs on the card {st_c.flops}, on meta "
             f"{st_m.flops}")
    for key in ("argument_bytes", "unread_argument_bytes"):
        if mem_c[key] != mem_m[key]:
            fail(f"dryrun {name}: {key} per rank on the card {mem_c[key]}, "
                 f"on meta {mem_m[key]}")
    key = [(p[0], p[2], p[3], p[4]) for p in st_m.programs]
    if key != [(p[0], p[2], p[3], p[4]) for p in st_c.programs]:
        fail(f"dryrun {name}: the programs differ from the card's")
    if launched != st_m.kernel_calls or st_c.kernel_calls != launched:
        fail(f"dryrun {name}: the card launched {launched}, the meta run's "
             f"entry points imply {st_m.kernel_calls}")
    if checked != warm or warm != c:
        fail(f"dryrun {name}: the warm-up held {checked} of {warm} calls, "
             f"the counted step launched {c}")
    if abs(peak_card - st_m.peak_bytes) > probe.scratch:
        fail(f"dryrun {name}: the card's peak of requested bytes "
             f"{peak_card} is {peak_card - st_m.peak_bytes} B off the meta "
             f"run's {st_m.peak_bytes} (bound: an op's workspace, "
             f"{probe.scratch} B)")
    return {"flops": st_m.flops, "memory_meta_per_rank": mem_m,
            "programs": len(st_m.programs), "coll_by_kind": st_m.coll_by_kind,
            "coll_wire_bytes_per_rank": st_m.coll_wire_bytes,
            "coll_dcn_bytes_per_rank": st_m.coll_dcn_bytes,
            "launches": c, "checked": checked,
            "peak_meta_bytes": st_m.peak_bytes,
            "peak_requested_card_bytes": peak_card,
            "peak_tracked_card_bytes": st_c.peak_bytes,
            "op_workspace_max_bytes": probe.scratch,
            "peak_allocated_card_bytes": peak_allocated,
            "meta_seconds": meta_s, "card_seconds": card_s,
            "card_step_seconds": step_s, "card": smi}


def dry_tokens(cfg, mesh: dict, B: int, S: int, seed: int, convert,
               stages):
    """(B, S) token ids from `seed`, stacked over the batch axes."""
    g = torch.Generator(device="cuda").manual_seed(seed + 11)
    tok = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                        device="cuda", dtype=torch.int32)
    return convert.stack_global(tok, mesh, (stages.dp_axes(mesh, B), None))


def dry_lm_cell(name: str, cfg, kind: str, mesh: dict, tp: int, B: int,
                S: int, pcfg, mods, ops, ref, counts, seed: int, smi: str,
                s_enc: int = 0) -> dict:
    """An 11b cell of an LM step (`kind`: 'prefill', 'decode' or 'train'):
    the dry run's cell on 'meta' against the same step on the card, its
    params from `seed` (the serving layout, or the FSDP layout and AdamW
    state for a train step), zero caches for a decode step at position
    S - 1, token ids from `seed`."""
    (convert, stages, adamw, _schedules, _lm, data_mod, _tl) = mods
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    meta = dryrun.build_cell(cfg, ShapeConfig(name, S, B, kind), mesh, pcfg,
                             s_enc=s_enc)
    params = stages.init_params(cfg, mesh, tp, seed=seed, device="cuda",
                                serve=kind != "train")
    if kind == "train":
        ts = stages.build_train_step(cfg, pcfg, mesh, adamw.AdamWConfig(),
                                     device="cuda")
        opt = adamw.adamw_init(params)
        batch = ts.put_batch(train_batch(data_mod, cfg, B, S, seed))
        steps = iter(range(2))
        card = ((lambda: ts.fn(params, opt, batch, next(steps))),
                ts.ctx.engine, (params, opt, batch))
    elif kind == "prefill":
        pf, ctx, _, _ = stages.build_prefill(cfg, pcfg, mesh, B, S,
                                             device="cuda")
        batch = {"tokens": dry_tokens(cfg, mesh, B, S, seed, convert,
                                      stages)}
        card = (lambda: pf(params, batch)), ctx.engine, (params, batch)
    else:
        dstep, ctx, _, _ = stages.build_decode_step(
            cfg, pcfg, mesh, s_max=S, global_batch=B, s_enc=s_enc,
            device="cuda")
        caches = stages.init_cache(cfg, pcfg, mesh, tp, B, S, s_enc=s_enc,
                                   device="cuda")
        batch = {"tokens": dry_tokens(cfg, mesh, B, 1, seed, convert,
                                      stages)}
        card = ((lambda: dstep(params, caches, batch["tokens"], S - 1)),
                ctx.engine, (params, caches, batch))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    out = dry_card_cell(name, meta, card, mesh, ops, ref, counts, smi)
    out.update(arch=cfg.name, kind=kind, mesh=mesh, batch=B, seq=S,
               n_layers=cfg.n_layers, encoder_layers=cfg.encoder_layers,
               s_enc=s_enc, build_seconds=build_s)
    return out


def phase_dry_cells(get_config, mods, ops, ref, counts, seed: int, smi: str,
                    CONFIG, DLRMServer) -> None:
    """Phase 11b, cells (a)-(f): `dry_card_cell` on a decode step, the
    MoE's all-to-all dispatch, an SSM, an encoder's unread params, int8
    gradient buckets and the DLRM forward, all at full width: (a)
    qwen3-0.6b's decode step, 28 layers, phase 8's (4, 16, 8) cache on
    (1, 4, 2); (b) a qwen3-moe-30b-a3b prefill of (4, 16) on (1, 1, 8),
    EP 8, 2 layers; (c) a mamba2-1.3b prefill of (4, 16) at 9b's 6
    layers; (d) whisper-medium's decode step (3 + 3 layers, 9d's) with a
    1500-frame cross cache, whose encoder and cross k/v projections it
    never reads; (e) phase 10's (8, 64) train step with int8 buckets (K2,
    K3); (f) the DLRM forward of 32 requests on (1, 1, 8) through
    `dryrun.build_dlrm_cell` (K5's lookup, K1, K4 in FC1), the tables
    `CONFIG`'s or cut as phase 6 cuts them."""
    from repro_torch.configs import ParallelConfig
    from repro_torch.launch import dryrun
    from repro_torch.models import dlrm as dlrm_mod
    t_phase = time.perf_counter()
    out: dict = {}
    B, P, G = LM_SMALL
    base = ParallelConfig()
    lm_cells = (
        ("a", get_config(LM_ARCH), "decode", LM_MESH, LM_TP, B, P + G, base,
         0),
        ("b", dataclasses.replace(get_config("qwen3-moe-30b-a3b"),
                                  n_layers=DRY_MOE_LAYERS),
         "prefill", DRY_MOE_MESH, DRY_MOE_MESH["model"], *DRY_PREFILL,
         ParallelConfig(moe_capacity_factor=FAM_MOE_CF), 0),
        ("c", dataclasses.replace(get_config("mamba2-1.3b"),
                                  n_layers=DRY_SSM_LAYERS),
         "prefill", LM_MESH, LM_TP, *DRY_PREFILL, base, 0),
        ("d", dataclasses.replace(get_config("whisper-medium"),
                                  n_layers=DRY_AUDIO_LAYERS,
                                  encoder_layers=DRY_AUDIO_LAYERS),
         "decode", LM_MESH, LM_TP, B, P + G, base, FAM_FRAMES),
        ("e", get_config(LM_ARCH), "train", LM_MESH, LM_TP, *TRAIN_SMALL,
         ParallelConfig(remat="none", grad_compression="int8"), 0),
    )
    for name, cfg, kind, mesh, tp, b, s, pcfg, s_enc in lm_cells:
        out[name] = dry_lm_cell(name, cfg, kind, mesh, tp, b, s, pcfg, mods,
                                ops, ref, counts, seed, smi, s_enc=s_enc)
        torch.cuda.empty_cache()
    if not out["e"]["launches"]["quantize_blocks"]:
        fail("dryrun e: the int8 step launched no K2")
    if not out["d"]["memory_meta_per_rank"]["unread_argument_bytes"]:
        fail("dryrun d: whisper's decode read every param")
    # (f) the DLRM forward
    t0 = time.perf_counter()
    dcfg, free, _total = dlrm_config(CONFIG)
    server = DLRMServer(dcfg, mesh_shape=DLRM_MESH, device="cuda", seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 12)
    ids = server._stack(torch.randint(
        0, dcfg.rows_per_table, (DRY_DLRM_BATCH, dcfg.n_tables), generator=g,
        device="cuda"))
    params = server.model.params()
    meta = dryrun.build_dlrm_cell(dcfg, DLRM_MESH, server.pcfg,
                                  DRY_DLRM_BATCH)
    card = ((lambda: dlrm_mod.dlrm_forward(params, ids, server.ctx)),
            server.engine, (params, ids))
    build_s = time.perf_counter() - t0
    out["f"] = dry_card_cell("f", meta, card, DLRM_MESH, ops, ref, counts,
                             smi)
    out["f"].update(arch="dlrm", kind="serve", mesh=DLRM_MESH,
                    batch=DRY_DLRM_BATCH, build_seconds=build_s,
                    config=dataclasses.asdict(dcfg),
                    rows_per_table_cut=(None if dcfg == CONFIG else
                                        [CONFIG.rows_per_table,
                                         dcfg.rows_per_table]),
                    mem_free_before=free)
    for k in ("gather_rows", "matmul_tiled", "fused_combine"):
        if not out["f"]["launches"][k]:
            fail(f"dryrun f: the DLRM forward launched no {k}")
    del server, params, ids, meta, card
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    out["card"] = smi
    emit({"phase": "dryrun_cells", **out})


# --------------------------------------------------------------------------
# Phase 12: one rank per process
# --------------------------------------------------------------------------

PROC_RANKS = 8
PROC_GRID_MIB = 1             # 12a: MiB per rank of the executor's grid
PROC_REPS = 5                 # 12b: timed calls per collective
PROC_ROOT = 1                 # 12a: the root of rooted generators
PROC_VECMAT = 4096            # 12c: the example's top size
PROC_MESH2 = {"pod": 2, "data": 4}
_PROC_GROUPS = _KERNEL_GROUPS + (("matmul_tiled_kernel", "K4 matmul_tiled"),
                                  ("k5_rows_kernel", "K5 gather_rows"),
                                  ("gemm", "cuBLAS"), ("xmma", "cuBLAS"),
                                  ("Memcpy", "host staging copies"))
# 12e: the native backend's collectives at 1 MiB per rank, and the
# streaming matmuls: (x rows per rank, K, N) at segments 1 and 4 — rows
# 32 take K4's small_m32 plan (every segment's rows <= 32), rows 512 and
# 1024 its large_m plan
PROC_NATIVE_MIB = 1
PROC_STREAM_SHAPES = {"allgather_matmul": ((32, 256, 256), (512, 256, 512)),
                      "matmul_reduce_scatter": ((32, 256, 256),
                                                (1024, 256, 512))}
PROC_STREAM_SEGMENTS = (1, 4)
# 12f: ring attention one rank per process over 8192 tokens, 1024 a
# process; its float64 reference in blocks of 256 queries. At 32768
# tokens the 8 processes' float64 references and score tensors at once
# outgrow the card (out of memory at 78 GB in use)
PROC_RING_TOKENS = 8192
PROC_RING_Q_BLOCK = 256
PROC_RING_RUNS = (("causal", True, 1), ("full", False, 1),
                  ("causal_seg4", True, 4), ("full_seg4", False, 4))
# 12g: each process's CUDA context and working set beside its table slice
PROC_CONTEXT_BYTES = 2**30


def proc_fail(msg: str) -> None:
    """A check failed in a child: raise, so that the world fails."""
    raise RuntimeError(f"chip_smoke, one rank per process: {msg}")


def proc_digest(t) -> str:
    """sha256 of a tensor's bytes: the children send their results to the
    parent as digests, and a digest match is a bitwise match."""
    import hashlib
    return hashlib.sha256(t.contiguous().reshape(-1).view(
        torch.uint8).cpu().numpy()).hexdigest()


def proc_grid(n: int) -> list:
    """12a's cases, as `tests/test_torch_procgroup.py`'s grid: (key,
    schedule, segments, codec, inputs) of every GENERATORS entry that
    accepts n ranks, segments 1 and 4, codec None and int8, integer-valued
    and normal fp32, and bf16 for the ring and bidi_ring allreduce."""
    from repro_torch.core import algorithms
    from repro_torch.core.topology import Communicator
    comm = Communicator(axis="x", size=n)

    def sched_of(coll, algo):
        gen = algorithms.GENERATORS[(coll, algo)]
        kw = {"root": PROC_ROOT} \
            if "root" in inspect.signature(gen).parameters else {}
        return gen(comm, **kw)

    out = []
    for coll, algo in sorted(algorithms.GENERATORS):
        try:
            sched = sched_of(coll, algo)
        except ValueError:
            continue
        for segments in (1, 4):
            for codec in (None, "int8"):
                for inputs in ("int", "normal"):
                    out.append((f"{coll}-{algo}-s{segments}-{codec}-{inputs}",
                                sched, segments, codec, inputs))
    for algo in ("ring", "bidi_ring"):
        out.append((f"allreduce-{algo}-s1-bf16-normal",
                    sched_of("allreduce", algo), 1, "bf16", "normal"))
    return out


def proc_grid_input(key: str, sched, n: int, codec, inputs: str, L: int):
    """The stacked (n, L) input of a 12a case, drawn on the card from a
    seed of its key (own shard at its slot for allgather / gather)."""
    import zlib
    g = torch.Generator(device="cuda").manual_seed(zlib.crc32(key.encode()))
    if inputs == "int":
        X = torch.randint(-20, 21, (n, L), generator=g, device="cuda",
                          dtype=torch.int32).float()
    else:
        X = torch.randn((n, L), generator=g, device="cuda")
    if sched.collective in ("allgather", "gather"):
        sl, own = L // n, torch.zeros_like(X)
        for r in range(n):
            slot = r if sched.chunk_coords == "absolute" \
                else (r - PROC_ROOT) % n
            own[r, slot * sl:(slot + 1) * sl] = X[r, :sl]
        X = own
    return X.bfloat16() if codec == "bf16" else X


def proc_main_inputs(seed: int, mib: int):
    """12b's stacked (8, L) integer-valued fp32 input."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 12)
    return int_inputs((PROC_RANKS, mib * 2**20 // 4), gen)


def proc_vecmat_inputs(seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    w = torch.randn((PROC_VECMAT, PROC_VECMAT), generator=gen, device="cuda")
    x = torch.randn((PROC_VECMAT,), generator=gen, device="cuda")
    return x, w


def proc_profile(fn, profiled: bool, median: float) -> dict:
    """One more call of `fn` on every rank; on the profiled one, its
    device time by kernel group (torch.profiler sees this process's
    kernels and copies only) and the busy share of the call's median."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    if not profiled:
        fn()
        torch.cuda.synchronize()
        return {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split: dict = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        key = next((g for pat, g in _PROC_GROUPS if pat in ev.key), "other")
        split[key] = split.get(key, 0.0) + us / 1e3
    busy = sum(split.values()) if split else None
    return {"device_busy_ms": busy,
            "busy_share": busy / median if split else None,
            "device_ms_by_group": split}


# each kernel entry point of `ops` -> (its kernel, its plain version in
# `ref`, which takes the same parameters but `out`)
PROC_CHECKED = {
    "fused_combine": ("fused_combine", "fused_combine"),
    "fused_combine_at": ("fused_combine", "fused_combine_at"),
    "quantize_int8": ("quantize_blocks", "quantize_blocks"),
    "quantize_int8_at": ("quantize_blocks", "quantize_blocks_at"),
    "dequantize_int8": ("dequantize_blocks", "dequantize_blocks"),
    "dequantize_int8_at": ("dequantize_blocks", "dequantize_blocks_at"),
    "matmul": ("matmul_tiled", "matmul"),
    "embedding_gather": ("gather_rows", "gather_rows"),
    "embedding_lookup_rows": ("gather_rows", "lookup_rows"),
    "region_copy": ("region_copy", "region_copy"),
}
#: the entry points that may write an operand in place -> that operand (K1
#: only with `in_place`)
PROC_IN_PLACE = {"fused_combine_at": "a", "region_copy": "dst"}


def k4_within(x, y, got, want) -> bool:
    """K4 against its plain version: two fp32 sums of K products in two
    orders differ by at most 2 K 2^-24 (|x| @ |w|) per element; a bf16
    output adds each side's rounding, 2^-8 of its magnitude."""
    bound = 2 * x.shape[-1] * 2.0 ** -24 * (x.double().abs()
                                             @ y.double().abs())
    if got.dtype != torch.float32:
        bound += BF16_U * (got.double().abs() + want.double().abs())
    return bool(((got.double() - want.double()).abs() <= bound).all())


@contextlib.contextmanager
def proc_checked(ops, ref, checked: dict, on_fail=None):
    """While the block runs, hold every K1, K2, K3 and K5 call on the card
    BITWISE against its plain version on the operands it was given, and
    every K4 call within its per-element bound (`k4_within`; the plain
    version runs first: `out` may alias an operand, and it launches no
    kernel, so the counts are the path's); `checked[kernel]` counts the
    calls held, a call that differs goes to `on_fail` (default
    `proc_fail`). Calls on 'meta' (receive buffers shaped by the codec)
    launch nothing and are not held."""
    on_fail = on_fail or proc_fail
    real = {n: getattr(ops, n) for n in PROC_CHECKED}

    def held(name):
        kernel, plain = PROC_CHECKED[name]
        sig = inspect.signature(real[name])

        def call(*args, **kwargs):
            if args[0].device.type == "meta":
                return real[name](*args, **kwargs)
            p = sig.bind(*args, **kwargs)
            p.apply_defaults()
            p.arguments.pop("out", None)
            plain_args = dict(p.arguments)
            written = PROC_IN_PLACE.get(name)
            if written and (name != "fused_combine_at"
                            or plain_args["in_place"]):
                # an in-place call: the plain version writes a clone
                t = plain_args[written]
                c = t.clone()
                plain_args = {k: (c if v is t else v)
                              for k, v in plain_args.items()}
            want = getattr(ref, plain)(**plain_args)
            res = real[name](*args, **kwargs)
            for i, (g, w) in enumerate(zip(
                    res if isinstance(res, tuple) else (res,),
                    want if isinstance(want, tuple) else (want,))):
                if g.shape != w.shape or g.dtype != w.dtype or not (
                        k4_within(p.arguments["x"], p.arguments["y"], g, w)
                        if name == "matmul"
                        else torch.equal(g, w)):
                    on_fail(f"{name} call {checked[kernel]} output {i} "
                            f"differs from the plain version")
            checked[kernel] += 1
            return res
        return call

    for n in PROC_CHECKED:
        setattr(ops, n, held(n))
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(ops, n, fn)


def proc_seeded(seed: int, part: int):
    return torch.Generator(device="cuda").manual_seed(seed + part)


#: 12e's native calls on {"x": 8}: (name, call, whether it adds)
PROC_NATIVE_CALLS = (
    ("allreduce", lambda e, v: e.allreduce(v, "x"), True),
    ("allreduce_max", lambda e, v: e.allreduce(v, "x", op="max"), False),
    ("allreduce_min", lambda e, v: e.allreduce(v, "x", op="min"), False),
    ("reduce_scatter", lambda e, v: e.reduce_scatter(v, "x"), True),
    ("allgather", lambda e, v: e.allgather(v, "x"), False),
    ("bcast", lambda e, v: e.bcast(v, "x", root=PROC_ROOT), False),
    ("reduce", lambda e, v: e.reduce(v, "x", root=2), True),
    ("gather", lambda e, v: e.gather(v, "x", root=3), False),
    ("alltoall", lambda e, v: e.alltoall(v, "x"), False),
)


def proc_native(rank: int, world: int, seed: int, counted) -> dict:
    """12e, the native backend (`torch.distributed`'s collectives on the
    axis groups, staged through pinned host memory on gloo): every
    collective at PROC_NATIVE_MIB MiB per rank and the (2, 4) two-axis
    allreduce, on integer-valued and normal fp32 drawn (whole, on every
    process) from the seed. Each result BITWISE the stacked native
    engine's row on the card where every order of sums is exact
    (integer values; max, min and the moves on any values), the sums on
    integer values BITWISE X.sum(0) as well, and the sums on normal
    values within (n - 1) u sum_r |x_r| (u = 2^-24) of the float64 sum.
    No kernel launches: the native backend runs no program."""
    from repro_torch.core import CollectiveEngine
    from repro_torch.core.procgroup import ProcessGroupEngine
    L = PROC_NATIVE_MIB * 2**20 // 4
    eng = ProcessGroupEngine({"x": world}, backend="native")
    eng2 = ProcessGroupEngine(PROC_MESH2, backend="native")
    seng = CollectiveEngine({"x": world}, backend="native", device="cuda")
    seng2 = CollectiveEngine(PROC_MESH2, backend="native", device="cuda")
    pos = np.unravel_index(rank, tuple(PROC_MESH2.values()))
    gen = proc_seeded(seed, 15)
    worst, t0 = 0.0, time.perf_counter()
    s0 = dict(eng.transport_stats())
    calls = [(name, call, adds, eng, seng, (world,), rank)
             for name, call, adds in PROC_NATIVE_CALLS]
    calls.append(("allreduce_2x4", lambda e, v: e.allreduce(
        v, ("pod", "data")), True, eng2, seng2,
        tuple(PROC_MESH2.values()), pos))
    for kind in ("int", "normal"):
        for name, call, adds, e, se, lead, at in calls:
            X = int_inputs(lead + (L,), gen) if kind == "int" else \
                torch.randn(lead + (L,), generator=gen, device="cuda")
            got = counted(f"native_{name}_{kind}",
                          lambda: call(e, X[at].clone()), extra={})
            want = call(se, X)[at]
            if kind == "int" or not adds:
                if got.shape != want.shape or not torch.equal(got, want):
                    proc_fail(f"12e native {name} ({kind}): rank {rank} "
                              f"differs from the stacked native engine")
                continue
            exact = call(se, X.double())[at]
            mag = call(se, X.double().abs())[at]
            n = math.prod(lead)
            err = (got.double() - exact).abs()
            if not bool((err <= (n - 1) * 2.0 ** -24 * mag).all()):
                proc_fail(f"12e native {name}: rank {rank} outside "
                          f"(n - 1) u sum|x| of the float64 sum")
            worst = max(worst, float((err / ((n - 1) * 2.0 ** -24 * mag)
                                      .clamp_min(1e-300)).max()))
        # integer-valued sums against X.sum(0) itself
        if kind == "int":
            X = int_inputs((world, L), gen)
            for name in ("allreduce", "reduce"):
                call = dict((c[0], c[1]) for c in PROC_NATIVE_CALLS)[name]
                if not torch.equal(call(eng, X[rank].clone()), X.sum(0)):
                    proc_fail(f"12e native {name}: rank {rank} differs "
                              f"from X.sum(0)")
            del X
    s1 = dict(eng.transport_stats())
    return {"mib_per_rank": PROC_NATIVE_MIB,
            "calls": 2 * len(calls), "seconds": time.perf_counter() - t0,
            "normal_sum_err_over_bound_max": worst,
            "collectives": s1["collectives"] - s0["collectives"],
            "staged_bytes": s1["staged_bytes"] - s0["staged_bytes"],
            "staged_ms": s1["staged_ms"] - s0["staged_ms"]}


def proc_streams(rank: int, world: int, seed: int, counted) -> dict:
    """12e, the streaming matmuls one rank per process: `allgather_matmul`
    and `matmul_reduce_scatter` at PROC_STREAM_SHAPES, segments 1 and 4,
    fp32 and bf16, on normal operands drawn (whole) from the seed. Each
    result BITWISE the stacked engine's row on the card (the same K4
    plan: one rank's launch and the stacked launch have the same M, K
    and N, and the operands are 16-byte aligned either way), and K4
    launched n x segments times per `allgather_matmul` and once per
    `matmul_reduce_scatter`, as the stacked engine launches it per call;
    every launch within its bound of the plain version."""
    from repro_torch.core import CollectiveEngine
    from repro_torch.core.procgroup import ProcessGroupEngine
    from repro_torch.kernels import matmul as mm
    eng = ProcessGroupEngine({"x": world})
    seng = CollectiveEngine({"x": world}, device="cuda")
    gen = proc_seeded(seed, 16)
    plans, t0 = {}, time.perf_counter()
    s0 = dict(eng.transport_stats())
    for op, shapes in PROC_STREAM_SHAPES.items():
        for m, k, p in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                X = torch.randn((world, m, k), generator=gen,
                                device="cuda").to(dtype)
                W = torch.randn((world, k, p), generator=gen,
                                device="cuda").to(dtype)
                for segs in PROC_STREAM_SEGMENTS:
                    key = f"{op}_{m}x{k}x{p}_{str(dtype)[6:]}_s{segs}"
                    k4 = world * segs if op == "allgather_matmul" else 1
                    got = counted(key, lambda: getattr(eng, op)(
                        X[rank], W[rank], "x", segments=segs),
                        extra={"matmul_tiled": k4})
                    want = getattr(seng, op)(X, W, "x", segments=segs)[rank]
                    if got.shape != want.shape or not torch.equal(got, want):
                        proc_fail(f"12e {key}: rank {rank} differs from the "
                                  f"stacked engine")
                    sub = (m // segs if op == "allgather_matmul" else m)
                    plans[key] = mm.plan_name(sub, k, p, dtype)
    s1 = dict(eng.transport_stats())
    return {"cases": len(plans), "plans": sorted(set(plans.values())),
            "seconds": time.perf_counter() - t0,
            "exchanges": s1["exchanges"] - s0["exchanges"],
            "staged_bytes": s1["staged_bytes"] - s0["staged_bytes"],
            "staged_ms": s1["staged_ms"] - s0["staged_ms"]}


def proc_ring(rank: int, world: int, seed: int, reps: int) -> dict:
    """12f, `ring_attention` one rank per process at qwen3-0.6b's
    attention width (16 q heads, 8 kv heads, head_dim 128, bf16), B = 1,
    PROC_RING_TOKENS tokens over the world: causal and full at segments 1
    and 4. Every process draws the whole q, k, v from the seed, takes its
    own block and holds its own queries' output within `ring_bound` of a
    float64 exact attention of its query block (computed on the card)
    and within RING_RMS_LIMIT of the rms its bf16 roundings give
    (`ring_rms`); then its median ms and the bytes it staged per call."""
    from repro_torch.core.procgroup import ProcessGroupEngine
    H, KV, hd, S = 16, 8, 128, PROC_RING_TOKENS
    sl = S // world
    gen = proc_seeded(seed, 17)
    q, k, v = (torch.randn((1, S, h, hd), generator=gen, device="cuda")
               .to(torch.bfloat16) for h in (H, KV, KV))
    mine = [t[:, rank * sl:(rank + 1) * sl].contiguous() for t in (q, k, v)]
    eng = ProcessGroupEngine({"x": world})
    refs = {c: ring_reference(q, k, v, c, rank * sl, (rank + 1) * sl,
                              PROC_RING_Q_BLOCK) for c in (True, False)}
    torch.cuda.empty_cache()
    out = {}
    for name, causal, segs in PROC_RING_RUNS:
        def fn(c=causal, s=segs):
            return eng.ring_attention(*mine, "x", causal=c, segments=s)
        y = fn()
        torch.cuda.synchronize()
        if y.shape != mine[0].shape or y.dtype != torch.bfloat16:
            proc_fail(f"12f ring {name}: {tuple(y.shape)} {y.dtype}")
        g = y[0].double()
        ref, mag, pv2 = refs[causal]
        err = (g - ref).abs()
        bound = ring_bound(ref, mag, S)
        if not bool(torch.isfinite(g).all()) or not bool((err <= bound)
                                                          .all()):
            proc_fail(f"12f ring {name}: rank {rank}: "
                      f"{int((err > bound).sum())} elements outside the "
                      f"float64 bound")
        rms = ring_rms(g, ref, pv2)
        if rms > RING_RMS_LIMIT:
            proc_fail(f"12f ring {name}: rank {rank}: rms error {rms} x "
                      f"the bf16 roundings' (limit {RING_RMS_LIMIT})")
        s0 = dict(eng.transport_stats())
        ms = median_ms(fn, reps)
        s1 = dict(eng.transport_stats())
        out[name] = {"median_ms": ms, "err_over_bound_max":
                     float((err / bound).max()), "rms_err_over_model": rms,
                     "staged_bytes_per_call": (s1["staged_bytes"]
                                               - s0["staged_bytes"])
                     / (reps + 1),
                     "staged_ms_per_call": (s1["staged_ms"] - s0["staged_ms"])
                     / (reps + 1)}
        del y, g, err, bound
    return out


def proc_dlrm_requests(cfg, B: int, gen, edges: bool):
    """B uniform requests drawn on the card (the same on every process);
    with `edges`, their first ids are every rank's shard edges, the
    first and last rows, -1, one past the last row and the int32
    extremes, as phase 6 puts them."""
    req = torch.randint(0, cfg.rows_per_table, (B, cfg.n_tables),
                        generator=gen, device="cuda", dtype=torch.int32)
    if edges:
        tp = DLRM_MESH["model"]
        rows_l = -(-cfg.rows_per_table // tp)
        e = [x for m in range(tp) for x in (m * rows_l - 1, m * rows_l,
                                            (m + 1) * rows_l - 1,
                                            (m + 1) * rows_l)]
        e += [0, cfg.rows_per_table - 1, -1, cfg.rows_per_table,
              -2**31, 2**31 - 1]
        req.view(-1)[:len(e)] = torch.tensor(e, dtype=torch.int32,
                                             device="cuda")
    return req


def proc_dlrm_serve(server, name: str, batches, counted, rank: int) -> dict:
    """Serve `batches` through a per-process `DLRMServer`, each counted:
    exactly one K5 and one K4 launch and the K1 launches its programs
    imply, every launch held against its plain version. Then, outside
    the counted window: this process's slots of the concat vector
    BITWISE direct indexing of its own table slice, the whole vector
    BITWISE the owned rows of every rank gathered outside the engine,
    the logits equal on every process and within DLRM_ATOL + DLRM_RTOL
    |ref| of a float64 reference from the gathered FC weights and that
    vector."""
    import torch.distributed as dist
    from repro_torch.models import dlrm as dlrm_mod
    fc64 = server.global_fc(torch.float64)
    err = 0.0
    for i, batch in enumerate(batches):
        out = counted(f"{name}_b{batch.shape[0]}", lambda: server(batch),
                      extra={"gather_rows": 1, "matmul_tiled": 1})
        if out.shape != (batch.shape[0], server.cfg.out_dim) or \
                not bool(torch.isfinite(out).all()):
            proc_fail(f"12g {name}: logits {tuple(out.shape)} or not finite")
        vec = server.lookup(batch)
        own = server.own_rows(batch)
        rows_l = server.model.tables.shape[-2]
        lo = server.ctx.own_tp_rank() * rows_l
        held = ((batch.long() >= lo) & (batch.long() < lo + rows_l)
                ).repeat_interleave(server.cfg.emb_dim, dim=1)
        if not torch.equal(vec[held], own[held]) or bool(own[~held].any()):
            proc_fail(f"12g {name} batch {i}: rank {rank}'s slots differ "
                      f"from direct indexing of its table slice")
        full = server.assembled_rows(batch)
        if not torch.equal(vec, full):
            proc_fail(f"12g {name} batch {i}: the concat vector differs "
                      f"from the owned rows gathered outside the engine")
        logits = [None] * dist.get_world_size()
        dist.all_gather_object(logits, out.cpu())
        if not all(torch.equal(t, logits[0]) for t in logits):
            proc_fail(f"12g {name} batch {i}: the logits differ between "
                      f"processes")
        want = dlrm_mod.mlp_reference(fc64, full.double())
        diff = (out.double() - want).abs()
        if not bool((diff <= DLRM_ATOL + DLRM_RTOL * want.abs()).all()):
            proc_fail(f"12g {name} batch {i}: logits differ from the "
                      f"float64 reference by {float(diff.max())}")
        err = max(err, float(diff.max()))
    return {"batches": len(batches), "logits_max_abs_err": err,
            "concat_bitwise": True, "logits_equal_across_processes": True}


def proc_dlrm(rank: int, world: int, seed: int, rows: int, counted,
              reps: int) -> dict:
    """12g, use case 2 one rank per process: the `CONFIG` DLRM (rows per
    table `rows`, cut only if the card was short) served by `DLRMServer`
    on a `ProcessGroupEngine` over the (1, 1, 8) mesh with
    collective_matmul, each process's params (its 6.4 GB table slice)
    drawn on the card from the seed by the per-process `Builder`; 20
    batches of 32 requests and one of 2048 (shard-edge ids in the first
    small batch and in the large one), then the same with
    backend='native' on the same params (`proc_dlrm_serve`'s checks both
    times). At `reduced()` size the logits BITWISE a stacked
    `DLRMServer` on the card whose params this process's were carried
    from (`convert.local_params`). Then each backend's median latency and
    q/s at 32 and 2048, the staged bytes and ms per batch and rank 0's
    busy share (informational: gloo over the host is no fabric)."""
    import dataclasses as dc
    from repro_torch import convert
    from repro_torch.configs import ParallelConfig
    from repro_torch.configs.dlrm import CONFIG, reduced
    from repro_torch.core.procgroup import ProcessGroupEngine
    from repro_torch.launch.dlrm_serve import DLRMServer
    t0 = time.perf_counter()
    # reduced size: bitwise the stacked server it was carried from
    small = reduced()
    rgen = proc_seeded(seed, 18)
    stacked = DLRMServer(small, mesh_shape=DLRM_MESH, device="cuda",
                         seed=seed)
    eng = ProcessGroupEngine(DLRM_MESH)
    local = DLRMServer(small, engine=eng, params=convert.local_params(
        stacked.model.params(), DLRM_MESH, eng.coords))
    for i in range(3):
        batch = proc_dlrm_requests(small, DLRM_SMALL, rgen, edges=i == 0)
        if not torch.equal(local(batch), stacked(batch)):
            proc_fail(f"12g reduced: rank {rank}'s logits differ from the "
                      f"stacked server's")
    del stacked, local
    torch.cuda.empty_cache()
    # the full CONFIG, params drawn per process
    cfg = dc.replace(CONFIG, rows_per_table=rows)
    t1 = time.perf_counter()
    server = DLRMServer(cfg, engine=eng, seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t1
    gen = proc_seeded(seed, 19)
    batches = [proc_dlrm_requests(cfg, DLRM_SMALL, gen, edges=i == 0)
               for i in range(DLRM_BATCHES)]
    large = proc_dlrm_requests(cfg, DLRM_LARGE, gen, edges=True)
    res = {"rows_per_table": rows, "init_seconds": init_s,
           "table_bytes": server.model.tables.numel() * 4,
           "reduced_bitwise_vs_stacked": 3}
    neng = ProcessGroupEngine(DLRM_MESH, backend="native")
    native = DLRMServer(cfg, engine=neng, params=server.model.params(),
                        pcfg=ParallelConfig(collective_matmul=True,
                                            backend="native"))
    for name, srv in (("microcode", server), ("native", native)):
        res[name] = proc_dlrm_serve(srv, name, batches + [large], counted,
                                    rank)
        it = {"i": 0}

        def nxt():
            it["i"] = (it["i"] + 1) % len(batches)
            return batches[it["i"]]

        e = srv.engine
        s0 = dict(e.transport_stats())
        t32 = median_ms(lambda: srv(nxt()), max(reps, DLRM_BATCHES))
        s1 = dict(e.transport_stats())
        t2k = median_ms(lambda: srv(large), max(3, reps // 4))
        calls = max(reps, DLRM_BATCHES) + 1
        res[name].update({
            "median_ms": {"b32": t32, "b2048": t2k},
            "queries_per_s": {"b32": DLRM_SMALL / (t32 / 1e3),
                              "b2048": DLRM_LARGE / (t2k / 1e3)},
            "b32_staged_bytes_per_batch": (s1["staged_bytes"]
                                           - s0["staged_bytes"]) / calls,
            "b32_staged_ms_per_batch": (s1["staged_ms"] - s0["staged_ms"])
            / calls,
            "b32_profile": proc_profile(lambda: srv(batches[0]), rank == 0,
                                        t32)})
    res["seconds"] = time.perf_counter() - t0
    del server, native
    torch.cuda.empty_cache()
    return res


def phase12_child(rank: int, world: int, tmp: str, seed: int, mib: int,
                  reps: int, dlrm_rows: int) -> None:
    """One process of phase 12 (12a-12g), one rank on the card. Every
    program this process runs is recorded; each part's launches, counted
    from 0, must equal what this rank's share of those programs implies
    (`procgroup.implied_launches`) plus the K4 and K5 launches the part
    makes outside programs, and each of them is held against its plain
    version (`proc_checked`: bitwise, K4 within its bound). Results of
    12a-12d go to the parent as digests (`proc_digest`), the vecmat
    partials as tensors; 12e-12g hold their own results in the child
    (each process has the whole seeded input) and report numbers."""
    import torch.distributed as dist
    from repro_torch.core import procgroup
    from repro_torch.core.procgroup import ProcessGroupEngine, Transport
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import distributed_vecmat as vm
    ran = []
    real = procgroup.execute_program_local

    def recorded(prog, buf, r, transport):
        ran.append((prog, r, tuple(buf.shape)))
        return real(prog, buf, r, transport)

    procgroup.execute_program_local = recorded
    total = dict.fromkeys(ops.KERNELS, 0)
    checked_total = dict.fromkeys(ops.KERNELS, 0)

    def counted(name, fn, extra=None):
        """Run `fn` with every launch held (`proc_checked`); its launches
        must be what the programs it ran imply, plus `extra` (K4's and
        K5's, which no program implies; given, the part may run no
        program)."""
        ran.clear()
        checked = dict.fromkeys(ops.KERNELS, 0)
        ops.reset_launch_counts()
        with proc_checked(ops, ref, checked):
            out = fn()
        torch.cuda.synchronize()
        got = ops.launch_counts()
        want = dict.fromkeys(ops.KERNELS, 0)
        for prog, r, shape in ran:
            for k, v in procgroup.implied_launches(prog, r, shape).items():
                want[k] += v
        for k, v in (extra or {}).items():
            want[k] += v
        if got != want or not (ran or extra is not None):
            proc_fail(f"{name}: rank {rank} launched {got}; its "
                      f"{len(ran)} programs imply {want}")
        if checked != got:
            proc_fail(f"{name}: rank {rank} launched {got} but held "
                      f"{checked} against the plain versions")
        for k in total:
            total[k] += got[k]
            checked_total[k] += checked[k]
        return out

    res = {"digests": {}, "timing": {}}
    # 12a: the executor's grid, one program at a time
    transport = Transport(dist.group.WORLD, range(world))
    L = PROC_GRID_MIB * 2**20 // 4
    t0 = time.perf_counter()
    for key, sched, segments, codec, inputs in proc_grid(world):
        prog = sched.compile(segments=segments, codec=codec)
        X = proc_grid_input(key, sched, world, codec, inputs, L)
        out = counted(key, lambda: procgroup.execute_program_local(
            prog, X[rank], rank, transport))
        res["digests"][key] = proc_digest(out)
    res["grid_s"] = time.perf_counter() - t0
    res["grid_transport"] = dict(transport.stats)
    # 12b: the main-path cell, the selector's pick
    X = proc_main_inputs(seed, mib)
    eng = ProcessGroupEngine({"x": world})
    mine = X[rank].clone()
    del X
    torch.cuda.empty_cache()
    for name, fn in (
            ("allreduce", lambda: eng.allreduce(mine, "x")),
            ("allreduce_int8", lambda: eng.allreduce(mine, "x",
                                                      compression="int8"))):
        res["digests"][name] = proc_digest(counted(name, fn))
        s0 = dict(eng.transport_stats())
        ms = median_ms(fn, reps)
        s1 = dict(eng.transport_stats())
        calls = reps + 1                      # median_ms warms up once
        res["timing"][name] = {
            "median_ms": ms, "staged_bytes_per_call":
                (s1["staged_bytes"] - s0["staged_bytes"]) / calls,
            "staged_ms_per_call": (s1["staged_ms"] - s0["staged_ms"]) / calls,
            "messages_per_call": (s1["messages"] - s0["messages"]) / calls,
            **proc_profile(fn, rank == 0, ms)}
    res["picks"] = sorted({(t[0], t[1]) for t in eng.trace_log})
    del mine
    # 12c: use case 1, this process's partials reduced to rank 0
    x, w = proc_vecmat_inputs(seed)
    xs = x.reshape(world, -1)[rank].clone()
    ws = w.reshape(world, -1, PROC_VECMAT)[rank].clone()
    del x, w
    y = counted("vecmat", lambda: vm.distributed_vecmat(eng, xs, ws,
                                                         VECMAT_TILES))
    tile = PROC_VECMAT // VECMAT_TILES
    parts = torch.stack([torch.matmul(
        xs.unsqueeze(-2), ws[..., t * tile:(t + 1) * tile]).squeeze(-2)
        for t in range(VECMAT_TILES)])
    res["timing"]["vecmat"] = {"median_ms": median_ms(
        lambda: vm.distributed_vecmat(eng, xs, ws, VECMAT_TILES), reps)}
    torch.save({"partials": parts.cpu(), "y": y.cpu()},
               f"{tmp}/vecmat{rank}.pt")
    # 12d: phase 7b's mix, drained, against the same calls blocking
    qg = torch.Generator(device="cuda").manual_seed(seed + 14)
    small = [int_inputs((world, m), qg)[rank] for m in (40, 8, 24)]
    big = int_inputs((world, 2**20), qg)[rank]
    mid = int_inputs((world, 2**16), qg)[rank]
    pos = np.unravel_index(rank, tuple(PROC_MESH2.values()))
    X2 = int_inputs(tuple(PROC_MESH2.values()) + (2**16,), qg)[pos]
    qeng = ProcessGroupEngine({"x": world})
    eng2 = ProcessGroupEngine(PROC_MESH2)
    reqs = [qeng.iallreduce(v, "x") for v in small]
    r_mid = qeng.iallreduce(mid, "x")
    reqs += [r_mid, qeng.ireduce(r_mid, "x", root=2,
                                 algorithm="binomial_tree"),
             qeng.iallreduce(big, "x", compression="int8"),
             eng2.issue_multi(X2, ["data", "pod"])]
    counted("queue", lambda: (qeng.queue.drain(), eng2.queue.drain()))
    stats = dict(qeng.queue.stats)
    if (stats["coalesced_buckets"], stats["coalesced_requests"]) != (1, 3):
        proc_fail(f"queue: rank {rank} coalescing stats {stats}")
    b_mid = qeng.allreduce(mid, "x")
    blocking = [qeng.allreduce(v, "x") for v in small] + [
        b_mid, qeng.reduce(b_mid, "x", root=2, algorithm="binomial_tree"),
        qeng.allreduce(big, "x", compression="int8"),
        eng2.allreduce_multi(X2, ["data", "pod"])]
    for i, (r, want) in enumerate(zip(reqs, blocking)):
        if not torch.equal(r.result, want):
            proc_fail(f"queue: rank {rank} request {i} differs from the "
                      f"blocking call")
    res["queue"] = {"stats": stats, "bitwise_vs_blocking": len(reqs)}
    del qeng, eng2, reqs, blocking, small, big, mid, X2
    torch.cuda.empty_cache()
    res["launches_12a_12d"] = dict(total)
    res["native"] = proc_native(rank, world, seed, counted)         # 12e
    res["streams"] = proc_streams(rank, world, seed, counted)
    res["ring"] = proc_ring(rank, world, seed, reps)                # 12f
    torch.cuda.empty_cache()
    res["dlrm"] = proc_dlrm(rank, world, seed, dlrm_rows, counted,  # 12g
                            reps)
    res["launches"] = total
    res["checked"] = checked_total
    res["transport"] = eng.transport_stats()
    with open(f"{tmp}/rank{rank}.json", "w") as f:
        json.dump(res, f)


def proc_dlrm_config(CONFIG):
    """12g's CONFIG: rows_per_table cut only if the card's free memory is
    short of the tables plus PROC_RANKS processes' contexts and the
    serving path's headroom (phase 6's rule, `dlrm_config`)."""
    free, total = torch.cuda.mem_get_info()
    per_row = CONFIG.n_tables * CONFIG.emb_dim * 4
    tp = DLRM_MESH["model"]
    avail = free - PROC_RANKS * PROC_CONTEXT_BYTES - DLRM_HEADROOM
    rows = CONFIG.rows_per_table
    if rows * per_row > avail:
        rows = max(tp, avail // per_row // tp * tp)
    return rows, free, total


def phase_procs(CollectiveEngine, procs, ops, counts, seed: int, mib: int,
                reps: int, smi: str, CONFIG) -> None:
    """Phase 12: one rank per process — 8 processes on the card, one
    gloo group, CUDA payloads staged through pinned host memory. 12a the
    executor's grid at 1 MiB per rank, 12b the 8 x `mib` MiB fp32 and
    int8 allreduce (the selector's pick), 12c use case 1 at 4096, 12d
    phase 7b's mix; 12e the native backend and the streaming matmuls
    (`proc_native`, `proc_streams`), 12f ring attention (`proc_ring`),
    12g use case 2 at the full CONFIG, 6.4 GB of tables per process
    (`proc_dlrm`), each checked in the child; each child's launches exact
    per part and each launch held against its plain version (`counted`,
    `proc_checked`). Here the parent checks the card's free memory for
    12g's tables first (`proc_dlrm_config`), then fails unless K1-K5
    were each held at least once, holds 12a and 12b BITWISE against the
    stacked executor and engine on the card and their integer-valued
    uncompressed allreduces
    against X.sum(0), 12c's root result within gamma_K of float64 and its
    reduce BITWISE the stacked reduce of the children's partials on the
    CPU (the plain versions). Times are informational: host staging over
    gloo is no fabric."""
    import tempfile
    from repro_torch.core.engine import execute_program
    t0 = time.perf_counter()
    rows, free, total_mem = proc_dlrm_config(CONFIG)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_procs_") as tmp:
        procs.spawn(phase12_child, PROC_RANKS, backend="gloo",
                    device="cuda", args=(tmp, seed, mib,
                                         min(reps, PROC_REPS), rows))
        spawn_s = time.perf_counter() - t0
        res = []
        for r in range(PROC_RANKS):
            with open(f"{tmp}/rank{r}.json") as f:
                res.append(json.load(f))
        vec = [torch.load(f"{tmp}/vecmat{r}.pt") for r in range(PROC_RANKS)]
    # every K1/K2/K3 launch of the children held against its plain version
    checked = dict.fromkeys(ops.KERNELS, 0)
    for r in res:
        for k, v in r["checked"].items():
            checked[k] += v
    for k in ops.KERNELS:
        # the per-process data plane copies through its transport: the
        # stacked indexed copy need not run here
        if not checked[k] and k != "region_copy":
            fail(f"12: no {k} call was held against its plain version")
    # 12a: every case bitwise the stacked executor's row, and the
    # integer-valued uncompressed allreduces bitwise X.sum(0) on every rank
    L = PROC_GRID_MIB * 2**20 // 4
    cases = proc_grid(PROC_RANKS)
    oracles = 0
    for key, sched, segments, codec, inputs in cases:
        prog = sched.compile(segments=segments, codec=codec)
        X = proc_grid_input(key, sched, PROC_RANKS, codec, inputs, L)
        want = execute_program(prog, X)
        exact = sched.collective == "allreduce" and codec is None and \
            inputs == "int"
        sum_digest = proc_digest(X.sum(0)) if exact else None
        oracles += exact
        for r in range(PROC_RANKS):
            if res[r]["digests"][key] != proc_digest(want[r]):
                fail(f"12a {key}: rank {r} differs from the stacked "
                     f"executor")
            if exact and res[r]["digests"][key] != sum_digest:
                fail(f"12a {key}: rank {r} differs from X.sum(0)")
        del want, X
    if not oracles:
        fail("12a: no allreduce held against X.sum(0)")
    # 12b: bitwise the stacked engine on the same inputs, the fp32 one
    # bitwise X.sum(0) too (integer-valued: every order of sums is exact)
    X = proc_main_inputs(seed, mib)
    eng = CollectiveEngine({"x": PROC_RANKS}, device="cuda")
    sum_digest = proc_digest(X.sum(0))
    for name, kw in (("allreduce", {}), ("allreduce_int8",
                                         {"compression": "int8"})):
        want = eng.allreduce(X, "x", **kw)
        for r in range(PROC_RANKS):
            if res[r]["digests"][name] != proc_digest(want[r]):
                fail(f"12b {name}: rank {r} differs from the stacked "
                     f"engine")
            if name == "allreduce" and res[r]["digests"][name] != sum_digest:
                fail(f"12b {name}: rank {r} differs from X.sum(0)")
        del want
    stacked_pick = sorted({(t[0], t[1]) for t in eng.trace_log})
    for r in range(PROC_RANKS):
        if [tuple(p) for p in res[r]["picks"]] != stacked_pick:
            fail(f"12b: rank {r} picked {res[r]['picks']}, the stacked "
                 f"engine {stacked_pick}")
    choice = eng.selector.choose("allreduce", X.shape[1] * 4, eng.comm("x"))
    del X, eng
    torch.cuda.empty_cache()
    # 12c: root's y against float64, its reduce against the stacked one
    # of the same partials on the CPU, where every combine is K1's plain
    # version
    x, w = proc_vecmat_inputs(seed)
    y = vec[0]["y"].cuda()
    err, ratio = check_vecmat(y, x, w)
    parts = torch.stack([v["partials"] for v in vec])          # (8, T, t)
    veng = CollectiveEngine({"x": PROC_RANKS}, device="cpu")
    want = torch.cat([veng.reduce(parts[:, t], "x",
                                  algorithm="binomial_tree")[0]
                      for t in range(VECMAT_TILES)])
    same("12c vecmat reduce vs the plain stacked reduce of the same "
         "partials", y.cpu(), want)
    del x, w, y, parts, want
    torch.cuda.empty_cache()
    total = dict.fromkeys(ops.KERNELS, 0)
    for r in res:
        for k, v in r["launches"].items():
            total[k] += v
    counts["procs"] = total
    emit({"phase": "procs", "ranks": PROC_RANKS, "backend": "gloo",
          "card": smi, "seconds": time.perf_counter() - t0,
          "spawn_and_children_s": spawn_s,
          "checked_vs_plain": checked,
          "grid": {"cases": len(cases), "mib_per_rank": PROC_GRID_MIB,
                   "bitwise_vs_stacked": len(cases) * PROC_RANKS,
                   "bitwise_vs_sum": oracles * PROC_RANKS,
                   "seconds_rank0": res[0]["grid_s"],
                   "transport_rank0": res[0]["grid_transport"]},
          "main": {"mib_per_rank": mib, "bitwise_vs_stacked": True,
                   "fp32_bitwise_vs_sum": True,
                   "pick": [choice.algorithm, choice.segments],
                   "per_rank": [r["timing"] for r in res]},
          "vecmat": {"size": PROC_VECMAT, "max_abs_err": err,
                     "err_over_bound": ratio,
                     "reduce_bitwise_vs_plain_stacked": True},
          "queue": res[0]["queue"],
          "native": [r["native"] for r in res],
          "streams": [r["streams"] for r in res],
          "ring": {"tokens": PROC_RING_TOKENS, "heads": 16, "kv_heads": 8,
                   "head_dim": 128, "per_rank": [r["ring"] for r in res]},
          "dlrm": {"config": dataclasses.asdict(CONFIG),
                   "rows_per_table_cut": (None if rows == CONFIG.rows_per_table
                                          else [CONFIG.rows_per_table, rows]),
                   "mem_free_before_spawn": free, "mem_total": total_mem,
                   "per_rank": [r["dlrm"] for r in res]},
          "launches_12a_12d": {k: sum(r["launches_12a_12d"][k] for r in res)
                               for k in ops.KERNELS},
          "launches_per_rank": [r["launches"] for r in res],
          "launches": total,
          "transport_per_rank": [r["transport"] for r in res]})


# --------------------------------------------------------------------------
# Phase 13: LM serving and training one rank per process
# --------------------------------------------------------------------------

# 13b's depth per variant (full width; the time of the run's 600 s cuts
# the base to a quarter of 28 layers and the int8 and SP variants to 4)
P13_TRAIN_LAYERS = {"base": 7, "int8": 4, "sp": 4}
P13_PARITY_LAYERS = 2        # 13c and 13d: full width, cut
P13_REPS = 3                 # timed prefills and decode steps per process
P13_TRAIN_REPS = 2           # timed train steps per process
P13_TRAIN = (("base", {}), ("int8", {"grad_compression": "int8"}),
             ("sp", {"sequence_parallel": True, "collective_matmul": True}))
P13_TRAINER_STEPS = 3        # 13d: the uninterrupted run's steps
P13_CKPT_EVERY = 2           # 13d: a checkpoint after step 1, then step 2
P13_PARAM_ATOL = 2e-4        # tests/_torch_train_cases.py::PARAM_ATOL
P13_LOSS_RTOL = 1e-5         # tests/_torch_train_cases.py::METRIC_TOL
P13_GNORM_RTOL = 1e-3        # 13b's grad norm at depth (1.24e-4 measured)
P13_RECORDED = ("allreduce", "allgather", "reduce_scatter", "alltoall",
                "allgather_matmul", "matmul_reduce_scatter",
                "tree_allreduce", "itree_allreduce")


def p13_variant_cfg(cfg, key: str):
    """13b's config of a variant: cut to P13_TRAIN_LAYERS[key] layers."""
    return dataclasses.replace(cfg, n_layers=P13_TRAIN_LAYERS[key])


def p13_pcfg(**kw):
    """Phase 10a's train configuration (remat none, the queue)."""
    from repro_torch.configs import ParallelConfig
    return ParallelConfig(remat="none", async_grad_sync=True, **kw)


def p13_prompt(cfg, seed: int):
    B, P, _Gn = LM_SMALL
    g = torch.Generator(device="cuda").manual_seed(seed + 13)
    return torch.randint(0, cfg.vocab_size, (B, P), generator=g,
                         device="cuda", dtype=torch.int32)


def p13_sched(schedules):
    return lambda s: schedules.cosine_warmup(s, TRAIN_WARMUP, TRAIN_STEPS)


def p13_digests(tree) -> dict:
    """{path: digest} of every leaf of a tree of dicts (hashed on host
    threads: sha256 releases the GIL)."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.tree import flatten
    pairs = flatten(tree)
    with ThreadPoolExecutor(8) as pool:
        digests = list(pool.map(proc_digest, [t for _p, t in pairs]))
    return {"/".join(map(str, p)): d for (p, _t), d in zip(pairs, digests)}


def p13_record(engine, log: list) -> dict:
    """Wrap the engine's collectives (on the instance) so that, while
    `state["active"]`, each outermost call appends (name, its operands on
    the host, the digests of its results) to `log`; returns `state`."""
    depth, state = [0], {"active": False}

    def host(x):
        if isinstance(x, torch.Tensor):       # a copy: the step writes
            return x.detach().to("cpu", copy=True)   # params in place
        if isinstance(x, (list, tuple)):
            return type(x)(host(v) for v in x)
        return x

    def digests(out):
        return [proc_digest(t) for t in
                (out if isinstance(out, (list, tuple)) else [out])]

    class Ticket:
        def __init__(self, ticket, entry):
            self.ticket, self.entry = ticket, entry

        def wait(self):
            out = self.ticket.wait()
            self.entry["out"] = digests(out)
            return out

    def wrap(name, fn):
        def call(*args, **kwargs):
            top = depth[0] == 0 and state["active"]
            depth[0] += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                depth[0] -= 1
            if not top:
                return out
            entry = {"name": name, "args": host(args),
                     "kwargs": host(kwargs)}
            log.append(entry)
            if name == "itree_allreduce":
                return Ticket(out, entry)
            entry["out"] = digests(out)
            return out
        return call

    for name in P13_RECORDED:
        setattr(engine, name, wrap(name, getattr(engine, name)))
    return state


def p13_unrecord(engine) -> None:
    for name in P13_RECORDED:
        engine.__dict__.pop(name, None)


def p13_replay(name: str, logs: list, CollectiveEngine,
               mesh: dict = None) -> int:
    """Replay each recorded collective (the ranks' logs, global rank
    order) on the stacked engine on the card over `mesh` (LM_MESH) with
    every rank's own operands; fail unless each rank's results are
    BITWISE the stacked rows. Returns the calls replayed."""
    mesh = dict(LM_MESH if mesh is None else mesh)
    lead = tuple(mesh.values())
    eng = CollectiveEngine(mesh, device="cuda")

    def stacked(vals):
        if isinstance(vals[0], torch.Tensor):
            return torch.stack(vals).reshape(lead + tuple(
                vals[0].shape)).cuda()
        if isinstance(vals[0], (list, tuple)):
            return type(vals[0])(stacked(list(v)) for v in zip(*vals))
        if any(v != vals[0] for v in vals[1:]):
            fail(f"{name}: the ranks called with different {vals}")
        return vals[0]

    if any(len(g) != len(logs[0]) for g in logs):
        fail(f"{name}: the ranks recorded {[len(g) for g in logs]} "
             f"collectives")
    for i, calls in enumerate(zip(*logs)):
        op = calls[0]["name"]
        args = stacked([c["args"] for c in calls])
        kwargs = {k: stacked([c["kwargs"][k] for c in calls])
                  for k in calls[0]["kwargs"]}
        want = getattr(eng, "tree_allreduce" if op == "itree_allreduce"
                       else op)(*args, **kwargs)
        want = want if isinstance(want, (list, tuple)) else [want]
        for j, w in enumerate(want):
            rows = w.reshape((-1,) + tuple(w.shape[len(lead):]))
            for r, c in enumerate(calls):
                if c["out"][j] != proc_digest(rows[r]):
                    fail(f"{name}: collective {i} ({op}) result {j} "
                         f"on rank {r} differs from the stacked engine's")
        del args, kwargs, want
    torch.cuda.empty_cache()
    return len(logs[0])


def phase13_child(rank: int, world: int, tmp: str, seed: int,
                  reps: int) -> None:
    """One process of phase 13 (13a-13d), one rank of qwen3-0.6b on the
    card. Every part runs `counted`: each launch held against its plain
    version (`proc_checked`), the K1/K2/K3 launches what this rank's
    share of the programs it ran implies, K4's the stacked step's, and
    the engine's collectives (its trace) the stacked step's where the
    parent measured them. Results go to the parent as tokens, metrics,
    digests and recorded operands."""
    import shutil
    import torch.distributed as dist
    from repro_torch import convert
    from repro_torch import data as data_mod
    from repro_torch.configs import ParallelConfig, get_config
    from repro_torch.core import procgroup
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve as serve_launch
    from repro_torch.optim import adamw, schedules
    from repro_torch.parallel import stages
    from repro_torch.runtime import ServeSession, Trainer, TrainerConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    refs = torch.load(f"{tmp}/refs.pt", weights_only=False)
    cfg = get_config(LM_ARCH)
    c2 = dataclasses.replace(cfg, n_layers=P13_PARITY_LAYERS)
    eng = stages.process_engine(LM_MESH, "microcode", "cuda")
    coords = eng.coords
    ran = []
    real = procgroup.execute_program_local

    def recorded(prog, buf, r, transport):
        ran.append((prog, r, tuple(buf.shape)))
        return real(prog, buf, r, transport)

    procgroup.execute_program_local = recorded
    total = dict.fromkeys(ops.KERNELS, 0)
    checked_total = dict.fromkeys(ops.KERNELS, 0)

    def counted(name, fn, engine=eng, trace=None, k4=0):
        """Run `fn` with every launch held; its launches must be what its
        programs imply plus `k4` K4 launches (or `k4(out)`), and its
        collectives (the engine's trace) `trace` where given. Returns
        (out, trace)."""
        ran.clear()
        checked = dict.fromkeys(ops.KERNELS, 0)
        ops.reset_launch_counts()
        t0 = len(engine.trace_log)
        with proc_checked(ops, ref, checked):
            out = fn()
        torch.cuda.synchronize()
        got = ops.launch_counts()
        want = dict.fromkeys(ops.KERNELS, 0)
        for prog, r, shape in ran:
            for k, v in procgroup.implied_launches(prog, r, shape).items():
                want[k] += v
        want["matmul_tiled"] += k4(out) if callable(k4) else k4
        if got != want:
            proc_fail(f"13 {name}: rank {rank} launched {got}; its "
                      f"{len(ran)} programs and the stacked step imply "
                      f"{want}")
        if checked != got:
            proc_fail(f"13 {name}: rank {rank} launched {got} but held "
                      f"{checked} against the plain versions")
        colls = [tuple(e) for e in engine.trace_log[t0:]]
        if trace is not None and colls != [tuple(e) for e in trace]:
            proc_fail(f"13 {name}: rank {rank} ran {len(colls)} "
                      f"collectives, not the stacked step's {len(trace)}")
        for k in total:
            total[k] += got[k]
            checked_total[k] += checked[k]
        return out, colls

    def timed(fn, profiled=False, n=reps):
        """`p14_timed` on this engine, and (rank 0) the busy share."""
        out = p14_timed(eng, fn, n)
        if profiled:
            out.update(proc_profile(fn, rank == 0, out["median_ms"]))
        return out

    res = {"coords": coords, "timing": {}, "part_s": {}}
    t_part = [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        res["part_s"][name] = now - t_part[0]
        t_part[0] = now
    B, P, Gn = LM_SMALL
    pcfg = ParallelConfig()
    prompt = p13_prompt(cfg, seed)
    # 13a: full width and depth, each process drawing its rows of the
    # stacked init from the seed, as the launchers do
    params = stages.init_params(cfg, LM_MESH, LM_TP, seed=seed,
                                device=eng.device, serve=True,
                                coords=coords)
    res["13a_params"] = p13_digests(params)
    sess = ServeSession(cfg, pcfg, LM_MESH, LM_TP, B, P, P + Gn,
                        device=eng.device, engine=eng)
    want_step = fam_step_collectives(cfg, LM_TP, P + Gn, pcfg)
    real_dec, step_colls = sess.decode_fn, []

    def dec(*a):
        t0 = len(eng.trace_log)
        out = real_dec(*a)
        names: dict = {}
        for e in eng.trace_log[t0:]:
            names[e[0]] = names.get(e[0], 0) + 1
        step_colls.append(names)
        return out
    sess.decode_fn = dec
    toks, _ = counted("13a", lambda: sess.generate(params, prompt, Gn))
    if any(c != want_step for c in step_colls) or len(step_colls) != Gn - 1:
        proc_fail(f"13a: rank {rank} decode steps ran {step_colls}, the "
                  f"stacked step {want_step}")
    res["13a_tokens"] = toks
    sess.decode_fn = real_dec
    batch = sess.stack_batch({"tokens": prompt})
    res["timing"]["prefill"] = timed(lambda: sess.prefill_fn(params, batch))
    nxt, pf = sess.prefill_fn(params, batch)
    from repro_torch.runtime import convert_prefill_caches
    caches = convert_prefill_caches(pf, cfg, pcfg, LM_MESH, LM_TP, B, P,
                                    P + Gn, engine=eng)
    del pf
    res["timing"]["decode_step"] = step = timed(
        lambda: sess.decode_fn(params, caches, nxt[..., None], P), True)
    step["tokens_per_s"] = B / (step["median_ms"] / 1e3)
    del params, caches, sess, batch
    torch.cuda.empty_cache()
    part("13a")
    # 13b: the train step at (8, 64), FSDP 4 x TP 2
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR)
    tbatch = train_batch(data_mod, cfg, *TRAIN_SMALL, seed)
    res["13b"] = {}
    for key, kw in P13_TRAIN:
        c = p13_variant_cfg(cfg, key)
        params = stages.init_params(c, LM_MESH, LM_TP, seed=seed,
                                    device=eng.device, coords=coords)
        opt = adamw.adamw_init(params)
        ts = stages.build_train_step(c, p13_pcfg(**kw), LM_MESH, opt_cfg,
                                     p13_sched(schedules), engine=eng)
        want = refs["13b"][key]
        b = ts.put_batch(tbatch)
        (_p, _o, m), _ = counted(f"13b {key}", lambda: ts.fn(
            params, opt, b, 0), trace=want["trace"], k4=want["k4"])
        res["13b"][key] = {k: float(v) for k, v in m.items()}
        torch.save({p: t.cpu() for p, t in _flat(params).items()},
                   f"{tmp}/b13_{key}_{rank}.pt")
        if key == "base":
            res["timing"]["train_step"] = timed(
                lambda: ts.fn(params, opt, b, 1), True, P13_TRAIN_REPS)
        del params, opt, ts, b
        torch.cuda.empty_cache()
        part(f"13b {key}")
    # 13c: parity with the stacked run, params carried from a stacked init
    full = stages.init_params(c2, LM_MESH, LM_TP, seed=seed,
                              device=eng.device, serve=True)
    params = convert.local_params(full, LM_MESH, coords)
    del full
    dp = stages.dp_axes(LM_MESH, B)
    dstep, _, _, _ = stages.build_decode_step(c2, pcfg, LM_MESH,
                                              s_max=P + Gn, global_batch=B,
                                              engine=eng)
    cache = stages.init_cache(c2, pcfg, LM_MESH, LM_TP, B, P + Gn,
                              device=eng.device, coords=coords)
    dlog = []
    rec = p13_record(eng, dlog)

    def keep(prm, cch, tok, pos):
        rec["active"] = pos == P
        return dstep(prm, cch, tok, pos)
    seq, _ = counted("13c decode", lambda: serve_launch.decode_loop(
        keep, params, cache, prompt, Gn, LM_MESH, dp, engine=eng))
    p13_unrecord(eng)
    res["13c_seq"] = seq.cpu()
    del params, cache
    full = stages.init_params(c2, LM_MESH, LM_TP, seed=seed,
                              device=eng.device)
    params = convert.local_params(full, LM_MESH, coords)
    del full
    opt = adamw.adamw_init(params)
    ts = stages.build_train_step(c2, p13_pcfg(), LM_MESH, opt_cfg,
                                 p13_sched(schedules), engine=eng)
    tlog = []
    rec = p13_record(eng, tlog)
    b = ts.put_batch(tbatch)
    rec["active"] = True
    (_p, _o, m), _ = counted("13c train", lambda: ts.fn(params, opt, b, 0),
                             trace=refs["13c"]["trace"],
                             k4=refs["13c"]["k4"])
    p13_unrecord(eng)
    res["13c_metrics"] = {k: float(v) for k, v in m.items()}
    torch.save({"decode": dlog, "train": tlog,
                "params": {p: t.cpu() for p, t in
                           _flat(params).items()}},
               f"{tmp}/c13_{rank}.pt")
    del params, opt, ts, b, dlog, tlog
    torch.cuda.empty_cache()
    dist.barrier()               # every rank's records written
    part("13c")
    # 13d: the Trainer, a checkpoint written by the world, resumed
    ckpt = f"{tmp}/ckpt13"

    def trainer():
        return Trainer(c2, p13_pcfg(), LM_MESH, opt_cfg,
                       data_mod.DataConfig(global_batch=TRAIN_SMALL[0],
                                           seq_len=TRAIN_SMALL[1],
                                           seed=seed),
                       TrainerConfig(total_steps=P13_TRAINER_STEPS,
                                     ckpt_dir=ckpt,
                                     ckpt_every=P13_CKPT_EVERY, seed=seed),
                       lr_schedule=p13_sched(schedules), device="cuda",
                       engine=eng)
    ta = trainer()
    saved = {}
    real_save = ta.ckpt.save

    def save(step, tree, *a, **k):
        if step == P13_CKPT_EVERY - 1:
            saved.update(p13_digests(tree))
        return real_save(step, tree, *a, **k)
    ta.ckpt.save = save
    log_a, _ = counted("13d run", ta.run, engine=ta.ts.ctx.engine)
    if rank == 0:
        shutil.rmtree(f"{ckpt}/step_{P13_TRAINER_STEPS - 1:09d}")
    dist.barrier()
    # resume: the Trainer's restore, then its next step on the loader's
    # rows (`_run_once` without the final checkpoint)
    tb = trainer()

    def resume():
        params, opt, start = tb.restore_or_init()
        if p13_digests({"params": params, "opt": opt}) != saved:
            proc_fail(f"13d: rank {rank} restored another state than it "
                      f"saved")
        index, count = tb.ts.data_shard()
        loader = data_mod.make_loader(tb.data_cfg, tb.arch, start, index,
                                      count)
        try:
            out = []
            for step, batch in loader:
                if step >= P13_TRAINER_STEPS:
                    break
                _p, _o, m = tb.ts.fn(params, opt, tb.ts.put_rows(batch),
                                     step)
                out.append({"step": step,
                            **{k: float(v) for k, v in m.items()}})
            return out
        finally:
            loader.close()
    log_b, _ = counted("13d resume", resume, engine=tb.ts.ctx.engine)
    keys = ("ce_mean", "grad_norm", "loss")
    a = [[r[k] for k in keys] for r in log_a if r["step"] >= P13_CKPT_EVERY]
    b_ = [[r[k] for k in keys] for r in log_b]
    if [r["step"] for r in log_b] != list(range(P13_CKPT_EVERY,
                                                P13_TRAINER_STEPS)) \
            or a != b_:
        proc_fail(f"13d: rank {rank} resumed {b_}, the uninterrupted run "
                  f"{a}")
    res["13d"] = {"digests": saved, "log": log_a, "resumed": log_b}
    part("13d")
    res["launches"] = total
    res["checked"] = checked_total
    res["transport"] = eng.transport_stats()
    torch.save(res, f"{tmp}/p13_{rank}.pt")
    # phase 14 in the same world, its launches counted anew
    for k in total:
        total[k] = checked_total[k] = 0
    res = p14_child(rank, tmp, seed, counted, eng)
    res["launches"], res["checked"] = dict(total), dict(checked_total)
    torch.save(res, f"{tmp}/p14_{rank}.pt")


def _flat(tree) -> dict:
    from repro_torch.tree import flatten
    return {"/".join(map(str, p)): t for p, t in flatten(tree)}


def p13_param_gap(name: str, rank: int, at: tuple, got: dict,
                  want: dict) -> float:
    """The largest |got - want| over a rank's updated params (`got`,
    {path: local leaf}) against the stacked step's (`want`) at its mesh
    position `at`; fails unless each is within P13_PARAM_ATOL plus one
    bf16 ulp of the stacked step's (compared on the card)."""
    worst = 0.0
    for path, t in got.items():
        w = want[path]
        w = w[(slice(None),) + at] if path.startswith("layers") else w[at]
        w = w.to("cuda").double()
        d = (t.to("cuda").double() - w).abs()
        bound = P13_PARAM_ATOL + 2.0 ** -7 * w.abs()
        if bool((d > bound).any()):
            fail(f"{name}: rank {rank} updated {path} off the stacked "
                 f"step's by {float(d.max())}")
        worst = max(worst, float(d.max()))
    return worst


def p13_stacked_refs(cfg, mods, ops, seed: int, tmp: str) -> dict:
    """The stacked port's runs phase 13 holds the processes against, on
    the card before the spawn: 13b each variant's train step from the
    same init (metrics, the engine's trace, K4 launches); 13c the decode
    tokens of phase 8's loop and the train step's metrics, trace, K4
    launches and updated params at P13_PARITY_LAYERS. Returns (refs,
    {part: the stacked step's updated params on the host})."""
    (convert, stages, adamw, schedules, lm_mod, data_mod,
     serve_launch) = mods
    from repro_torch.configs import ParallelConfig
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR)
    tbatch = train_batch(data_mod, cfg, *TRAIN_SMALL, seed)
    refs: dict = {"13b": {}, "13c": {}}

    def step(c, pcfg):
        params = stages.init_params(c, LM_MESH, LM_TP, seed=seed,
                                    device="cuda")
        opt = adamw.adamw_init(params)
        ts = stages.build_train_step(c, pcfg, LM_MESH, opt_cfg,
                                     p13_sched(schedules), device="cuda")
        ops.reset_launch_counts()
        _p, _o, m = ts.fn(params, opt, ts.put_batch(tbatch), 0)
        torch.cuda.synchronize()
        out = {"metrics": {k: float(v) for k, v in m.items()},
               "trace": [tuple(e) for e in ts.ctx.engine.trace_log],
               "k4": ops.launch_counts()["matmul_tiled"]}
        return out, params

    new_params = {}
    for key, kw in P13_TRAIN:
        refs["13b"][key], params = step(p13_variant_cfg(cfg, key),
                                        p13_pcfg(**kw))
        new_params[key] = {p: t.cpu() for p, t in _flat(params).items()}
        del params
        torch.cuda.empty_cache()
    c2 = dataclasses.replace(cfg, n_layers=P13_PARITY_LAYERS)
    refs["13c"], params = step(c2, p13_pcfg())
    new_params["13c"] = {p: t.cpu() for p, t in _flat(params).items()}
    del params
    B, P, Gn = LM_SMALL
    pcfg = ParallelConfig()
    params = stages.init_params(c2, LM_MESH, LM_TP, seed=seed,
                                device="cuda", serve=True)
    dstep, _, _, _ = stages.build_decode_step(c2, pcfg, LM_MESH,
                                              s_max=P + Gn, global_batch=B,
                                              device="cuda")
    cache = stages.init_cache(c2, pcfg, LM_MESH, LM_TP, B, P + Gn,
                              device="cuda")
    refs["13c"]["seq"] = serve_launch.decode_loop(
        dstep, params, cache, p13_prompt(cfg, seed), Gn, LM_MESH,
        stages.dp_axes(LM_MESH, B)).cpu()
    del params, cache
    torch.cuda.empty_cache()
    torch.save(refs, f"{tmp}/refs.pt")
    return refs, new_params


def phase_lm_procs(cfg, mods, procs, CollectiveEngine, ops, counts,
                   seed: int, smi: str, get_config) -> None:
    """Phase 13: qwen3-0.6b one rank per process, 8 processes on the card
    in one gloo group (`phase13_child`), on launch/serve.py's (1, 4, 2)
    mesh. 13a serves at full width and depth (params drawn per process
    from --seed as the launchers draw them; `ServeSession` at (4, 16,
    8)): the tokens on the margin rule against the float64 single-copy
    forward of the same params, drawn here by one stacked init (the
    children's digests its rows'). 13b one train step at (8, 64), FSDP 4 x
    TP 2: the base, int8 buckets and SP + collective_matmul, each cut in
    depth (P13_TRAIN_LAYERS); rank 0's loss (a rank's own) and every
    rank's ce within rtol P13_LOSS_RTOL, every rank's grad norm within
    P13_GNORM_RTOL and its updated params within P13_PARAM_ATOL plus one bf16 ulp of the stacked step on
    the same params and batch. 13c at
    P13_PARITY_LAYERS, full width, params carried from a stacked init
    (`convert.local_params`): the decode tokens EQUAL phase 8's stacked
    loop's, the train step's loss and grad norm within rtol 1e-5 and every
    updated param within P13_PARAM_ATOL plus one bf16 ulp of the stacked
    step's, and every engine collective of a decode step and of the train
    step replayed on the stacked engine on the ranks' own operands:
    BITWISE. 13d the `Trainer` one rank per process at P13_PARITY_LAYERS:
    P13_TRAINER_STEPS steps with a checkpoint after step 1 written by the
    world, which loads into the stacked port with every leaf equal to the
    processes' (digests), and back into the processes (`restore_or_init`,
    each leaf its saved bits) whose next step takes the uninterrupted
    run's step 2 bitwise. Every child holds every K1-K4
    launch against its plain version, its launches equal what its
    programs and the stacked step imply, and its collectives per step
    the stacked step's (trace)."""
    import tempfile
    (convert, stages, adamw, schedules, lm_mod, data_mod,
     serve_launch) = mods
    from repro_torch.checkpoint import load_checkpoint
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_procs_") as tmp:
        refs, new_params = p13_stacked_refs(cfg, mods, ops, seed, tmp)
        refs_s = time.perf_counter() - t0
        t14 = time.perf_counter()
        refs14, params14 = p14_stacked_refs(get_config, mods, ops, seed, tmp)
        refs14_s = time.perf_counter() - t14
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        procs.spawn(phase13_child, PROC_RANKS, backend="gloo",
                    device="cuda", args=(tmp, seed, P13_REPS))
        spawn_s = time.perf_counter() - t1
        res = [torch.load(f"{tmp}/p13_{r}.pt", weights_only=False)
               for r in range(PROC_RANKS)]
        checked = dict.fromkeys(ops.KERNELS, 0)
        total = dict.fromkeys(ops.KERNELS, 0)
        for r in res:
            for k in ops.KERNELS:
                checked[k] += r["checked"][k]
                total[k] += r["launches"][k]
        for k in ("fused_combine", "quantize_blocks", "dequantize_blocks",
                  "matmul_tiled"):
            if not checked[k]:
                fail(f"13: no {k} call was held against its plain version")
        coords = [r["coords"] for r in res]
        # 13a: the tokens against the float64 reference of the same params
        B, P, Gn = LM_SMALL
        toks = res[0]["13a_tokens"]
        for r in res[1:]:
            if not torch.equal(r["13a_tokens"], toks):
                fail("13a: the processes generated different tokens")
        stacked = stages.init_params(cfg, LM_MESH, LM_TP, seed=seed,
                                     device="cuda", serve=True)
        for r, c in enumerate(coords):
            if p13_digests(convert.local_params(stacked, LM_MESH, c)) != \
                    res[r]["13a_params"]:
                fail(f"13a: rank {r}'s params are not the stacked init's "
                     f"rows")
        G = lm_global(stacked, cfg, convert, stages)
        del stacked
        prompt = p13_prompt(cfg, seed)
        seq = torch.cat([prompt, toks[:, :-1].cuda()], dim=1)
        tok_a = lm_token_check("13a", toks, lm_reference_logits(
            G, cfg, seq)[:, P - 1:], cfg)
        del G
        torch.cuda.empty_cache()
        # 13b: the metrics (the loss is each rank's own, the reference's
        # one device's copy: rank 0's; ce and grad norm every rank's) and
        # every rank's updated params against the stacked step's
        rtol = {"loss": P13_LOSS_RTOL, "ce_mean": P13_LOSS_RTOL,
                "grad_norm": P13_GNORM_RTOL}
        out_b = {}
        for key, _kw in P13_TRAIN:
            want = refs["13b"][key]["metrics"]
            rel = dict.fromkeys(rtol, 0.0)
            gap = 0.0
            for r, c in enumerate(coords):
                got = res[r]["13b"][key]
                for k in rtol if r == 0 else ("ce_mean", "grad_norm"):
                    rel[k] = max(rel[k], abs(got[k] - want[k]) / abs(want[k]))
                gap = max(gap, p13_param_gap(
                    f"13b {key}", r, tuple(c[a] for a in LM_MESH),
                    torch.load(f"{tmp}/b13_{key}_{r}.pt"), new_params[key]))
            if any(rel[k] > rtol[k] for k in rtol):
                fail(f"13b {key}: {rel} relative off the stacked step's "
                     f"{want}, beyond {rtol}")
            out_b[key] = {"metrics": res[0]["13b"][key], "stacked": want,
                          "rel_max_over_ranks": rel, "rtol": rtol,
                          "param_max_abs_diff": gap,
                          "layers": p13_variant_cfg(cfg, key).n_layers,
                          "collectives_per_step": len(
                              refs["13b"][key]["trace"]),
                          "k4_per_step": refs["13b"][key]["k4"]}
        # 13c: tokens, metrics, params and every collective
        for r in res:
            if not torch.equal(r["13c_seq"], refs["13c"]["seq"]):
                fail("13c: the decode tokens differ from the stacked "
                     "loop's")
        want = refs["13c"]["metrics"]
        got = res[0]["13c_metrics"]
        for k in ("loss", "grad_norm", "ce_mean"):
            if abs(got[k] - want[k]) > P13_LOSS_RTOL * abs(want[k]):
                fail(f"13c: {k} {got[k]} vs the stacked step's {want[k]}")
        logs = {"decode": [], "train": []}
        worst = 0.0
        for r, c in enumerate(coords):
            c13 = torch.load(f"{tmp}/c13_{r}.pt", weights_only=False)
            worst = max(worst, p13_param_gap(
                "13c", r, tuple(c[a] for a in LM_MESH), c13["params"],
                new_params["13c"]))
            for k in logs:
                logs[k].append(c13[k])
            del c13
        del new_params
        replayed = {k: p13_replay(f"13c {k}", v, CollectiveEngine)
                    for k, v in logs.items()}
        del logs
        # 13d: the world's checkpoint in the stacked port
        from repro_torch.runtime import Trainer, TrainerConfig
        c2 = dataclasses.replace(cfg, n_layers=P13_PARITY_LAYERS)
        st = Trainer(c2, p13_pcfg(), LM_MESH,
                     adamw.AdamWConfig(lr=TRAIN_LR),
                     data_mod.DataConfig(global_batch=TRAIN_SMALL[0],
                                         seq_len=TRAIN_SMALL[1]),
                     TrainerConfig(ckpt_dir=f"{tmp}/ckpt13"),
                     device="cuda")
        tree, _m = load_checkpoint(f"{tmp}/ckpt13", P13_CKPT_EVERY - 1,
                                   st._shape_tree(), st._state_specs(),
                                   LM_MESH, "cuda")
        for r, c in enumerate(coords):
            if p13_digests(convert.local_params(tree, LM_MESH, c)) != \
                    res[r]["13d"]["digests"]:
                fail(f"13d: the stacked load of the world's checkpoint "
                     f"differs from rank {r}'s state")
        del tree, st
        torch.cuda.empty_cache()
        counts["procs_lm"] = total
        emit({"phase": "lm_procs", "ranks": PROC_RANKS, "backend": "gloo",
              "mesh": LM_MESH, "card": smi,
              "seconds": time.perf_counter() - t0,
              "stacked_refs_s": refs_s, "spawn_and_children_s": spawn_s,
              "checked_vs_plain": checked,
              "13a": {"shape": list(LM_SMALL), "layers": cfg.n_layers,
                      "tokens": tok_a},
              "13b": out_b,
              "13c": {"layers": P13_PARITY_LAYERS, "metrics": got,
                      "stacked": want, "param_max_abs_diff": worst,
                      "collectives_bitwise": replayed},
              "13d": {"layers": P13_PARITY_LAYERS,
                      "steps": P13_TRAINER_STEPS,
                      "checkpoint_step": P13_CKPT_EVERY - 1,
                      "resumed_bitwise": True,
                      "log_rank0": res[0]["13d"]["log"]},
              "per_rank": [r["timing"] for r in res],
              "part_s_rank0": res[0]["part_s"],
              "launches_per_rank": [r["launches"] for r in res],
              "launches": total,
              "transport_per_rank": [r["transport"] for r in res]})
        # phase 14: the other families and the shrink, in the same world
        del res
        p14_check(get_config, mods, CollectiveEngine, ops, refs14, params14,
                  tmp, seed, refs14_s, smi, counts)


# --------------------------------------------------------------------------
# Phase 14: the other LM families and the elastic shrink one rank per
# process (in phase 13's spawned world)
# --------------------------------------------------------------------------

P14_LAYERS = 2               # every model of 14a-14g at full width (the time)
P14_EP_MESH = {"pod": 1, "data": 1, "model": 8}
# run, arch, mesh, tp, ParallelConfig fields, the single copy's dtype
P14_RUNS = (
    ("14a", "qwen3-moe-30b-a3b", P14_EP_MESH, 8, {}, torch.float32),
    ("14b", "mamba2-1.3b", LM_MESH, LM_TP, {}, torch.float64),
    ("14c", "hymba-1.5b", LM_MESH, LM_TP, {}, torch.float64),
    ("14d", "whisper-medium", LM_MESH, LM_TP,
     {"attn_q_block": 500, "attn_kv_block": 1500}, torch.float64),
    ("14e", "internvl2-26b", LM_MESH, LM_TP, {}, torch.float64),
)
P14_SHRINK_MESH = {"pod": 2, "data": 2, "model": 2}
P14_SHRINK_STEPS = 4         # 14g: the Trainer's total_steps
P14_FAIL = (2, 1)            # 14g: data rank 1 dies at step 2
# 14f's train configuration: int8 gradient buckets (K2/K3 in the
# allreduces over 'model' of the leaves the experts do not shard)
P14_MOE_PCFG = {"grad_compression": "int8"}
# 14g's: the streaming matmuls (K4) on the shrink's path. Not int8: its
# allreduce leaves a leaf's replicas apart by a few ulps (each rank adds
# its own exact value to its partners' dequantized ones), and the
# stacked handoff re-cuts a leaf sharded along the failed axis from the
# first replica where the per-process one keeps each process's own
P14_TRAINER_PCFG = {"sequence_parallel": True, "collective_matmul": True}
# 14f's loss and ce, relative: P13_LOSS_RTOL. Routed alike (`p14_routed`),
# the two steps still differ where a product of the MoE path sums in
# another order (8.7e-6 measured on an NVIDIA H100 80GB HBM3 at 700 W)
P14_MOE_RTOL = P13_LOSS_RTOL
# 14f: a token may route otherwise than the stacked step routed it only
# where its own k-th and (k+1)-th router probabilities lie within one bf16
# ulp (2^-8, relative) of each other: a near-tie that a product summed in
# another order breaks apart
P14_NEAR_TIE = 2.0 ** -8
# 14g's ce and loss after the first update, relative: the two runs' params
# then differ by up to a bf16 ulp where an update rounds to the other
# neighbour (13b: 3.05e-5 apart after one step), which the next forward
# carries into the metrics; at P13_LOSS_RTOL (1e-5) the check failed at
# 3.7e-5 (steps 1-3, 3.8e-5 in later runs, on an NVIDIA H100 80GB HBM3 at
# 700 W); step 0 stays within P13_LOSS_RTOL
P14_TRAJ_RTOL = 1e-4


def p14_cfg(get_config, arch: str):
    """A phase-14 config: full width, P14_LAYERS layers (an encoder's too;
    hymba's layer 0 global, layer 1 windowed)."""
    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=P14_LAYERS, encoder_layers=min(
        cfg.encoder_layers, P14_LAYERS))


def p14_shape(cfg) -> tuple:
    """(batch, prompt, gen): LM_SMALL, a VLM's prompt behind its visual
    prefix (the prefix takes the prompt's first n_vis positions)."""
    B, P, Gn = LM_SMALL
    return B, P + (cfg.n_vis_tokens if cfg.family == "vlm" else 0), Gn


def p14_inputs(cfg, seed: int):
    """The prompt, the audio family's stub frames and a VLM's prefix,
    drawn on the card from --seed (the same on every process)."""
    B, P, _Gn = p14_shape(cfg)
    g = torch.Generator(device="cuda").manual_seed(seed + 14)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=g,
                           device="cuda", dtype=torch.int32)
    frames = fam_frames(cfg, B, seed) if cfg.encoder_layers else None
    vis = None
    if cfg.family == "vlm":
        vis = torch.randn((B, cfg.n_vis_tokens, cfg.d_model), generator=g,
                          device="cuda").to(torch.bfloat16)
    return prompt, frames, vis


def p14_timed(engine, fn, reps: int) -> dict:
    """Median ms of `fn` over `reps` calls (after a warm-up call) and the
    bytes (and host ms) it stages per call through `engine`."""
    s0 = engine.transport_stats()
    ms = median_ms(fn, reps)
    s1 = engine.transport_stats()
    return {"median_ms": ms,
            "staged_bytes_per_call": (s1["staged_bytes"]
                                      - s0["staged_bytes"]) / (reps + 1),
            "staged_ms_per_call": (s1["staged_ms"]
                                   - s0["staged_ms"]) / (reps + 1)}


def p14_serve(run, cfg, pcfg, mesh, tp, eng, mods, counted, seed: int,
              tmp: str, rank: int) -> dict:
    """One model of 14a-14e on this process: params drawn as the stacked
    init's rows, served at (4, 16, 8) under `counted` (the session, or
    the pieces with frames or the visual prefix), the collectives of
    every decode step against the layouts', the first decode step's
    recorded for the parent's replay (`c14_{run}_{rank}.pt`), a MoE's
    routings logged; then the prefill and a decode step timed."""
    from repro_torch.models import mlp as mlp_mod
    stages = mods[1]
    B, P, Gn = p14_shape(cfg)
    params = stages.init_params(cfg, mesh, tp, seed=seed, device=eng.device,
                                serve=True, coords=eng.coords)
    prompt, frames, vis = p14_inputs(cfg, seed)
    server = FamServer(mods, cfg, pcfg, mesh, tp, B, P, Gn, frames, vis,
                       engine=eng)
    log, step_colls = [], []
    state = p13_record(eng, log)

    def per_step(fn):
        def dec(prm, cch, tok, pos):
            state["active"] = pos == P
            t0 = len(eng.trace_log)
            out = fn(prm, cch, tok, pos)
            state["active"] = False
            names: dict = {}
            for e in eng.trace_log[t0:]:
                names[e[0]] = names.get(e[0], 0) + 1
            step_colls.append(names)
            return out
        return dec
    server.wrap(decode=per_step)
    rec: list = []
    with (moe_recording(mlp_mod, rec) if cfg.family == "moe"
          else contextlib.nullcontext()):
        toks, _ = counted(f"14 {run}", lambda: server.generate(
            params, prompt, Gn), engine=eng)
    p13_unrecord(eng)
    want = fam_step_collectives(cfg, tp, P + Gn, pcfg)
    if len(step_colls) != Gn - 1 or any(c != want for c in step_colls):
        proc_fail(f"14 {run}: rank {rank} decode steps ran {step_colls}, "
                  f"the layouts {want}")
    torch.save(log, f"{tmp}/c14_{run}_{rank}.pt")
    out = {"tokens": toks, "step_collectives": want,
           "rec": [{k: v.cpu() for k, v in r.items()} for r in rec]}
    batch = server.batch(prompt)
    out["prefill"] = p14_timed(eng, lambda: server.prefill_fn(params, batch),
                               P13_REPS)
    nxt, pf = server.prefill_fn(params, batch)
    caches = server.handoff(pf)
    del pf
    out["decode_step"] = step = p14_timed(eng, lambda: server.decode_fn(
        params, caches, nxt[..., None], P), P13_REPS)
    step["tokens_per_s"] = B / (step["median_ms"] / 1e3)
    del params, server, caches, batch, nxt
    torch.cuda.empty_cache()
    return out


def p14_trainer(cfg, mods, mesh, seed: int, ckpt: str, engine=None):
    """14g's Trainer: P14_SHRINK_STEPS steps at TRAIN_SMALL on `mesh`, data
    rank P14_FAIL[1] failing at step P14_FAIL[0], no checkpoint but the
    final one; stacked on the card, or on `engine`."""
    (_convert, _stages, adamw, schedules, _lm, data_mod, _launch) = mods
    from repro_torch.runtime import FailureInjector, Trainer, TrainerConfig
    return Trainer(cfg, p13_pcfg(**P14_TRAINER_PCFG), mesh,
                   adamw.AdamWConfig(lr=TRAIN_LR),
                   data_mod.DataConfig(global_batch=TRAIN_SMALL[0],
                                       seq_len=TRAIN_SMALL[1], seed=seed),
                   TrainerConfig(total_steps=P14_SHRINK_STEPS,
                                 ckpt_dir=ckpt, ckpt_every=1000, seed=seed),
                   injector=FailureInjector(rank_fail_at=(P14_FAIL,)),
                   lr_schedule=p13_sched(schedules), device="cuda",
                   engine=engine)


@contextlib.contextmanager
def p14_routed(mlp_mod, routes, stats: dict):
    """While the block runs, each `moe_block` (one per layer, in order)
    routes its tokens to the experts `routes[layer]` names (the stacked
    step's choices on this rank's tokens), gated by this run's own
    probabilities; the capacity dispatch then keeps what the stacked
    step kept. `stats` counts the tokens whose own top-k set differs,
    the near-ties (own k-th and (k+1)-th probabilities within
    P14_NEAR_TIE, relative) and the largest such gap of a token that
    differs."""
    real_top = mlp_mod.top_k
    layer = [0]

    def top_k(probs, k):
        te = routes[layer[0]].to(probs.device)
        own = real_top(probs, k)[1]
        differ = (own.sort(-1).values != te.sort(-1).values).any(-1)
        p = probs.detach().float().sort(-1, descending=True).values
        gap = (p[..., k - 1] - p[..., k]) / p[..., k - 1]
        stats["tokens"] = stats.get("tokens", 0) + int(differ.numel())
        stats["differ"] = stats.get("differ", 0) + int(differ.sum())
        stats["near_ties"] = stats.get("near_ties", 0) + int(
            (gap <= P14_NEAR_TIE).sum())
        stats["differ_gap"] = max(stats.get("differ_gap", 0.0), float(
            gap[differ].max()) if bool(differ.any()) else 0.0)
        layer[0] += 1
        return torch.gather(probs, -1, te), te
    mlp_mod.top_k = top_k
    try:
        yield
    finally:
        mlp_mod.top_k = real_top


def p14_child(rank: int, tmp: str, seed: int, counted, lm_engine) -> dict:
    """Phase 14 in one process of phase 13's world (after 13d; its
    LM_MESH engine `lm_engine`): 14a-14e serve (`p14_serve`), 14f one
    train step of qwen3-moe-30b-a3b against the stacked step's trace and
    K4 count, 14g the per-process `Trainer` through a shrink (last: the
    processes at the dead position leave it)."""
    from repro_torch import convert
    from repro_torch import data as data_mod
    from repro_torch.configs import ParallelConfig, get_config
    from repro_torch.launch import serve as serve_launch
    from repro_torch.models import lm as lm_mod
    from repro_torch.optim import adamw, schedules
    from repro_torch.parallel import stages
    from repro_torch.runtime import ServeSession, convert_prefill_caches
    refs = torch.load(f"{tmp}/refs14.pt", weights_only=False)
    mods = (convert, stages, ServeSession, convert_prefill_caches,
            serve_launch)
    res = {"runs": {}, "part_s": {}}
    engines = {tuple(LM_MESH.items()): lm_engine}
    for run, arch, mesh, tp, extra, _dtype in P14_RUNS:
        t0 = time.perf_counter()
        key = tuple(mesh.items())
        if key not in engines:
            engines[key] = stages.process_engine(mesh, "microcode", "cuda")
        cfg = p14_cfg(get_config, arch)
        pcfg = ParallelConfig(moe_capacity_factor=FAM_MOE_CF, **extra)
        res["runs"][run] = p14_serve(run, cfg, pcfg, mesh, tp, engines[key],
                                     mods, counted, seed, tmp, rank)
        res["part_s"][run] = time.perf_counter() - t0
    # 14f: one train step of the MoE on the EP mesh
    t0 = time.perf_counter()
    eng = engines[tuple(P14_EP_MESH.items())]
    cfg = p14_cfg(get_config, "qwen3-moe-30b-a3b")
    params = stages.init_params(cfg, P14_EP_MESH, 8, seed=seed,
                                device=eng.device, coords=eng.coords)
    opt = adamw.adamw_init(params)
    ts = stages.build_train_step(cfg, p13_pcfg(**P14_MOE_PCFG), P14_EP_MESH,
                                 adamw.AdamWConfig(lr=TRAIN_LR),
                                 p13_sched(schedules), engine=eng)
    b = ts.put_batch(train_batch(data_mod, cfg, *TRAIN_SMALL, seed))
    # routed as the stacked step routed this rank's tokens: the top-k is
    # discontinuous, and the products sum in another order per process
    from repro_torch.models import mlp as mlp_mod
    routing: dict = {}
    with p14_routed(mlp_mod, refs["14f"]["routes"][rank], routing):
        (_p, _o, m), _ = counted("14f", lambda: ts.fn(params, opt, b, 0),
                                 engine=eng, trace=refs["14f"]["trace"],
                                 k4=refs["14f"]["k4"])
    res["14f"] = {k: float(v) for k, v in m.items()}
    res["14f_routing"] = routing
    res["coords_ep"] = dict(eng.coords)
    torch.save({p: t.cpu() for p, t in _flat(params).items()},
               f"{tmp}/f14_{rank}.pt")
    del params, opt, ts, b
    torch.cuda.empty_cache()
    res["part_s"]["14f"] = time.perf_counter() - t0
    # 14g: the Trainer through a shrink of the data axis
    t0 = time.perf_counter()
    c2 = dataclasses.replace(get_config(LM_ARCH), n_layers=P14_LAYERS)
    eng = stages.process_engine(P14_SHRINK_MESH, "microcode", "cuda")
    trainer = p14_trainer(c2, (convert, stages, adamw, schedules, lm_mod,
                               data_mod, serve_launch), P14_SHRINK_MESH,
                          seed, f"{tmp}/ckpt14", engine=eng)
    k4 = refs["14g"]["k4"]          # the stacked run's K4 a step
    log, _ = counted("14g", trainer.run, engine=eng, k4=lambda log: sum(
        k4[:P14_FAIL[0]] if log[-1].get("event") == "left" else k4))
    now = trainer.ts.ctx.engine
    res["14g"] = {"log": log, "mesh": dict(trainer.mesh),
                  "members": list(now.members), "coords": dict(now.coords),
                  "left": log[-1].get("event") == "left"}
    res["part_s"]["14g"] = time.perf_counter() - t0
    return res


def p14_stacked_refs(get_config, mods, ops, seed: int, tmp: str) -> tuple:
    """The stacked port's runs phase 14 holds the processes against, on
    the card before the spawn: 14f the MoE's train step from the same
    init (metrics, the engine's trace, K4 launches, the updated params
    on the host), 14g the stacked `Trainer`'s shrink run (its log, its
    final checkpoint under `tmp`)."""
    (convert, stages, adamw, schedules, lm_mod, data_mod,
     serve_launch) = mods
    from repro_torch.models import mlp as mlp_mod
    cfg = p14_cfg(get_config, "qwen3-moe-30b-a3b")
    params = stages.init_params(cfg, P14_EP_MESH, 8, seed=seed,
                                device="cuda")
    opt = adamw.adamw_init(params)
    ts = stages.build_train_step(cfg, p13_pcfg(**P14_MOE_PCFG), P14_EP_MESH,
                                 adamw.AdamWConfig(lr=TRAIN_LR),
                                 p13_sched(schedules), device="cuda")
    ops.reset_launch_counts()
    rec: list = []
    with moe_recording(mlp_mod, rec):
        _p, _o, m = ts.fn(params, opt, ts.put_batch(train_batch(
            data_mod, cfg, *TRAIN_SMALL, seed)), 0)
    torch.cuda.synchronize()
    lead = tuple(P14_EP_MESH.values())
    # each rank's expert choices per layer, for the processes' step
    routes = [[r["top_e"].reshape((-1,) + tuple(r["top_e"].shape[
        len(lead):]))[i].cpu() for r in rec] for i in range(PROC_RANKS)]
    refs = {"14f": {"metrics": {k: float(v) for k, v in m.items()},
                    "trace": [tuple(e) for e in ts.ctx.engine.trace_log],
                    "k4": ops.launch_counts()["matmul_tiled"],
                    "routes": routes}}
    del rec
    new_params = {p: t.cpu() for p, t in _flat(params).items()}
    del params, opt, ts
    torch.cuda.empty_cache()
    c2 = dataclasses.replace(get_config(LM_ARCH), n_layers=P14_LAYERS)
    k4: list = []
    real_build = stages.build_train_step

    def build(*a, **kw):
        # each step's K4 launches, on the mesh before and after the shrink
        ts = real_build(*a, **kw)
        fn = ts.fn

        def step(*args):
            n = ops.launch_counts()["matmul_tiled"]
            out = fn(*args)
            k4.append(ops.launch_counts()["matmul_tiled"] - n)
            return out
        ts.fn = step
        return ts
    stages.build_train_step = build
    try:
        st = p14_trainer(c2, mods, P14_SHRINK_MESH, seed,
                         f"{tmp}/ckpt14_stacked")
        refs["14g"] = {"log": st.run(), "mesh": dict(st.mesh), "k4": k4}
    finally:
        stages.build_train_step = real_build
    del st
    torch.cuda.empty_cache()
    torch.save(refs, f"{tmp}/refs14.pt")
    return refs, new_params


def p14_ckpt_params(directory: str, cfg, mesh, stages, adamw) -> dict:
    """{path: stacked leaf} of the params of the latest checkpoint under
    `directory`, loaded onto `mesh` on the card."""
    from repro_torch.checkpoint import latest_step, load_checkpoint
    from repro_torch.tree import tree_map
    tp = mesh["model"]
    specs = stages.param_specs(cfg, tp)
    shapes = stages.param_shapes(cfg, mesh, tp)
    like = {"params": shapes, "opt": {
        "leaves": tree_map(lambda p: {n: p.float() for n in _OPT_NAMES},
                           shapes),
        "count": torch.empty((), dtype=torch.int32, device="meta")}}
    step = latest_step(directory)
    tree, _m = load_checkpoint(directory, step, like, {
        "params": specs, "opt": adamw.opt_specs(specs)}, mesh, "cuda")
    return step, _flat(tree["params"])


def p14_check(get_config, mods, CollectiveEngine, ops, refs, new_params,
              tmp: str, seed: int, refs_s: float, smi: str, counts) -> None:
    """Phase 14's checks in the parent, on the children's results
    (`p14_{rank}.pt`): 14a-14e the tokens, equal on every process, by the
    margin rule against the float64 (14a: float32) single copy of the
    same params (a stacked init of --seed; the MoE routed as the
    processes routed, their routings stacked) and every collective of the
    first decode step replayed BITWISE on the stacked engine; 14f rank
    0's loss and every rank's ce and grad norm against the stacked step,
    every rank's updated params within P13_PARAM_ATOL plus one bf16 ulp;
    14g the survivors' steps against the stacked `Trainer`'s shrink run
    (ce and loss within P13_LOSS_RTOL, the grad norm P13_GNORM_RTOL),
    the same event rows, survivors and shrunk mesh, the processes at the
    dead position gone with a 'left' row, and the world's final
    checkpoint (written by the survivors' rank 0) the stacked run's
    within the 14f params bound."""
    t0 = time.perf_counter()
    (convert, stages, adamw, schedules, lm_mod, data_mod,
     serve_launch) = mods
    from repro_torch.configs import ParallelConfig
    from repro_torch.runtime import ServeSession, convert_prefill_caches
    smods = (convert, stages, ServeSession, convert_prefill_caches,
             serve_launch)
    res = [torch.load(f"{tmp}/p14_{r}.pt", weights_only=False)
           for r in range(PROC_RANKS)]
    checked = dict.fromkeys(ops.KERNELS, 0)
    total = dict.fromkeys(ops.KERNELS, 0)
    for r in res:
        for k in ops.KERNELS:
            checked[k] += r["checked"][k]
            total[k] += r["launches"][k]
    if not checked["fused_combine"]:
        fail("14: no fused_combine call was held against its plain version")
    runs = {}
    for run, arch, mesh, tp, extra, ref_dtype in P14_RUNS:
        cfg = p14_cfg(get_config, arch)
        pcfg = ParallelConfig(moe_capacity_factor=FAM_MOE_CF, **extra)
        B, P, Gn = p14_shape(cfg)
        out = res[0]["runs"][run]["tokens"]
        if any(not torch.equal(r["runs"][run]["tokens"], out)
               for r in res[1:]):
            fail(f"14 {run}: the processes generated different tokens")
        rec = None
        if cfg.family == "moe":
            lead = tuple(mesh.values())
            rec = [{k: torch.stack([r["runs"][run]["rec"][i][k]
                                    for r in res]).reshape(
                lead + tuple(res[0]["runs"][run]["rec"][i][k].shape)).cuda()
                for k in res[0]["runs"][run]["rec"][i]}
                for i in range(len(res[0]["runs"][run]["rec"]))]
        params = stages.init_params(cfg, mesh, tp, seed=seed, device="cuda",
                                    serve=True)
        G = fam_single_copy(params, cfg, mesh, tp, convert, stages,
                            ref_dtype)
        del params
        torch.cuda.empty_cache()
        prompt, frames, vis = p14_inputs(cfg, seed)
        line, _logits = fam_tokens(f"14 {run}", cfg, G, pcfg, mesh, smods,
                                   prompt, out, frames, rec, P - 1, vis)
        del G, _logits, rec
        torch.cuda.empty_cache()
        logs = [torch.load(f"{tmp}/c14_{run}_{r}.pt", weights_only=False)
                for r in range(PROC_RANKS)]
        line["collectives_bitwise"] = p13_replay(f"14 {run}", logs,
                                                 CollectiveEngine, mesh)
        del logs
        line.update({"arch": arch, "mesh": mesh,
                     "shape": [B, P, Gn],
                     "collectives_per_step": res[0]["runs"][run]
                     ["step_collectives"],
                     "per_rank": [{k: r["runs"][run][k] for k in
                                   ("prefill", "decode_step")}
                                  for r in res]})
        runs[run] = line
    parts = {"14a-14e": time.perf_counter() - t0}
    # 14f: the MoE's train step against the stacked step
    want = refs["14f"]["metrics"]
    ftol = {"loss": P14_MOE_RTOL, "ce_mean": P14_MOE_RTOL,
            "grad_norm": P13_GNORM_RTOL}
    rtol = {"loss": P13_LOSS_RTOL, "ce_mean": P13_LOSS_RTOL,
            "grad_norm": P13_GNORM_RTOL}
    rel = dict.fromkeys(rtol, 0.0)
    gap = 0.0
    for r, got in enumerate(res):
        for k in rtol if r == 0 else ("ce_mean", "grad_norm"):
            rel[k] = max(rel[k], abs(got["14f"][k] - want[k]) / abs(want[k]))
        gap = max(gap, p13_param_gap(
            "14f", r, tuple(got["coords_ep"][a] for a in P14_EP_MESH),
            torch.load(f"{tmp}/f14_{r}.pt"), new_params))
    if any(rel[k] > ftol[k] for k in ftol):
        fail(f"14f: {rel} relative off the stacked step's {want}, beyond "
             f"{ftol}")
    for r, got in enumerate(res):
        routing = got["14f_routing"]
        if routing["differ_gap"] > P14_NEAR_TIE:
            fail(f"14f: rank {r}'s own top-k differs from the stacked "
                 f"step's on {routing['differ']} tokens, one with its k-th "
                 f"and (k+1)-th probabilities {routing['differ_gap']} apart"
                 f" (relative), beyond a near-tie ({P14_NEAR_TIE})")
    parts["14f"] = time.perf_counter() - t0 - sum(parts.values())
    # 14g: the shrink against the stacked Trainer's
    slog, smesh = refs["14g"]["log"], refs["14g"]["mesh"]
    fail_step, dead = P14_FAIL
    names = list(P14_SHRINK_MESH)

    def data_of(r):
        return int(np.unravel_index(r, tuple(P14_SHRINK_MESH.values()))[
            names.index("data")])

    def steps(log):
        return [x for x in log if "event" not in x]

    def events(log):
        return [x for x in log if "event" in x]
    leavers = [r for r in range(PROC_RANKS) if res[r]["14g"]["left"]]
    if leavers != [r for r in range(PROC_RANKS) if data_of(r) == dead]:
        fail(f"14g: ranks {leavers} left, not the dead data position's")
    grel = dict.fromkeys(rtol, 0.0)
    per_step: dict = {}
    for r, got in enumerate(res):
        g = got["14g"]
        if r in leavers:
            if events(g["log"])[:-1] != events(slog) or \
                    [x["step"] for x in steps(g["log"])] != \
                    list(range(fail_step)):
                fail(f"14g: leaving rank {r} logged {g['log']}")
            continue
        if events(g["log"]) != events(slog) or g["mesh"] != smesh or \
                g["members"] != [q for q in range(PROC_RANKS)
                                 if data_of(q) != dead]:
            fail(f"14g: rank {r} shrank to {g['mesh']} over {g['members']} "
                 f"with {events(g['log'])}; the stacked run to {smesh} "
                 f"with {events(slog)}")
        if [x["step"] for x in steps(g["log"])] != \
                [x["step"] for x in steps(slog)]:
            fail(f"14g: rank {r} ran steps {steps(g['log'])}")
        for a, b in zip(steps(g["log"]), steps(slog)):
            # the loss is the process's own rows' (the stacked run's is
            # mesh position 0's): rank 0's, as in 13b
            tol = dict(rtol) if a["step"] == 0 else {
                "loss": P14_TRAJ_RTOL, "ce_mean": P14_TRAJ_RTOL,
                "grad_norm": P13_GNORM_RTOL}
            for k in rtol if r == 0 else ("ce_mean", "grad_norm"):
                d = abs(a[k] - b[k]) / abs(b[k])
                grel[k] = max(grel[k], d)
                row = per_step.setdefault(a["step"], {})
                row[k] = max(row.get(k, 0.0), d)
                if d > tol[k]:
                    fail(f"14g: rank {r}'s step {a['step']} {k} {a[k]} is "
                         f"{d} relative off the stacked shrink run's {b[k]}"
                         f", beyond {tol[k]}")
    c2 = dataclasses.replace(get_config(LM_ARCH), n_layers=P14_LAYERS)
    step_p, got = p14_ckpt_params(f"{tmp}/ckpt14", c2, smesh, stages, adamw)
    step_s, ref_p = p14_ckpt_params(f"{tmp}/ckpt14_stacked", c2, smesh,
                                    stages, adamw)
    if step_p != step_s or step_p != P14_SHRINK_STEPS - 1:
        fail(f"14g: the world's final checkpoint is step {step_p}, the "
             f"stacked run's {step_s}")
    ck_gap = 0.0
    for path, t in got.items():
        d = (t.double() - ref_p[path].double()).abs()
        if bool((d > P13_PARAM_ATOL + 2.0 ** -7
                 * ref_p[path].double().abs()).any()):
            fail(f"14g: the world's checkpoint {path} is off the stacked "
                 f"run's by {float(d.max())}")
        ck_gap = max(ck_gap, float(d.max()))
    del got, ref_p
    torch.cuda.empty_cache()
    parts["14g"] = time.perf_counter() - t0 - sum(parts.values())
    counts["procs_families"] = total
    emit({"phase": "lm_fam_procs", "ranks": PROC_RANKS, "backend": "gloo",
          "card": smi, "stacked_refs_s": refs_s,
          "children_s_rank0": sum(res[0]["part_s"].values()),
          "check_s": time.perf_counter() - t0, "check_parts_s": parts,
          "layers": P14_LAYERS, "checked_vs_plain": checked,
          "runs": runs,
          "14f": {"metrics": res[0]["14f"], "stacked": want,
                  "routing_differs": [r["14f_routing"] for r in res],
                  "near_tie": P14_NEAR_TIE,
                  "rel_max_over_ranks": rel, "rtol": ftol,
                  "param_max_abs_diff": gap,
                  "collectives_per_step": len(refs["14f"]["trace"]),
                  "k4_per_step": refs["14f"]["k4"]},
          "14g": {"mesh": P14_SHRINK_MESH, "shrunk": smesh,
                  "fail": {"step": fail_step, "data_rank": dead},
                  "leavers": leavers, "rel_max": grel,
                  "rel_max_per_step": per_step,
                  "traj_rtol": P14_TRAJ_RTOL,
                  "pcfg": P14_TRAINER_PCFG, "k4_per_step": refs["14g"]["k4"],
                  "checkpoint_step": step_p,
                  "checkpoint_param_max_abs_diff": ck_gap,
                  "log_rank0": res[0]["14g"]["log"]},
          "part_s_rank0": res[0]["part_s"],
          "launches_per_rank": [r["launches"] for r in res],
          "launches": total})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mib", type=int, default=64,
                    help="MiB per rank on the main path")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card "
              "only", file=sys.stderr)
        return 2
    # the plain fp32 products are IEEE fp32, as K4's are (never TF32), and
    # bf16 products accumulate in fp32, as the reference's do
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import convert
    from repro_torch.configs import ParallelConfig, get_config
    from repro_torch.configs.dlrm import CONFIG
    from repro_torch.core import CollectiveEngine, Sequencer
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import embedding_gather as eg
    from repro_torch.kernels import fused_reduce as fr
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch import distributed_vecmat as vm
    from repro_torch.launch import procs
    from repro_torch.launch import serve as serve_launch
    from repro_torch import data as data_mod
    from repro_torch.launch import train as train_launch
    from repro_torch.launch.dlrm_serve import DLRMServer
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import dlrm as dlrm_mod
    from repro_torch.models import lm as lm_mod
    from repro_torch.optim import adamw, schedules
    from repro_torch.parallel import stages
    from repro_torch.runtime import ServeSession, convert_prefill_caches

    # phase 1: the card and the build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_seconds": build_s,
          "built_now": _build.BUILD_SECONDS is not None})
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    mods = (convert, stages, ServeSession, convert_prefill_caches,
            serve_launch)
    counts: dict = {}

    err = phase_kernels(ops, ref, gen)                      # phase 2
    L = args.mib * 2**20 // 4
    phase_main_exchanges(CollectiveEngine, ops, ref, gen, L)   # phase 2c
    X = int_inputs((NRANKS, L), gen)
    runs = phase_main_fp32(CollectiveEngine, X, counts, ops)   # phase 3
    runs.update(phase_main_int8(CollectiveEngine, X, counts, ops, gen))

    # phase 5: times
    times = {name: median_ms(fn, args.reps) for name, fn in runs.items()}
    emit({"phase": "times", "median_ms": times, "reps": args.reps,
          "mib_per_rank": args.mib, "card": smi})
    rows = kernel_rows(ref, fr, qz, ops, X, gen, err)
    torch.cuda.synchronize()
    del runs, X
    torch.cuda.empty_cache()
    ssd_kernel = ssd_row(ops, ref, ssd, gen)
    torch.cuda.empty_cache()

    # phase 6: DLRM inference
    server = phase_dlrm_build(DLRMServer, CONFIG, args.seed)
    err.update(phase_dlrm_kernels(server, dlrm_mod, ops, ref, gen))
    small, large = phase_dlrm_serve(server, dlrm_mod, ops, counts, args.seed)
    phase_dlrm_times(server, small, large, args.reps, smi)
    rows += dlrm_kernel_rows(server, dlrm_mod, ref, mm, eg, gen, err)
    torch.cuda.synchronize()
    del server
    torch.cuda.empty_cache()

    # phase 7: the offload queue and use case 1
    phase_vecmat(CollectiveEngine, vm, ops, ref, counts, gen, args.reps, smi)
    phase_queue(CollectiveEngine, Sequencer, ops, ref, counts, gen)

    # phase 8: LM serving, qwen3-0.6b at full width
    torch.cuda.empty_cache()
    lm_cfg = get_config(LM_ARCH)
    params = phase_lm_build(lm_cfg, stages, args.seed)
    phase_lm_serve(lm_cfg, params, mods, ops, ref, counts, gen, args.seed)
    phase_fam_times("lm_times", "8", lm_cfg, params, LM_MESH, LM_TP,
                    ParallelConfig(), (LM_SMALL, LM_LARGE), mods, ops, ref,
                    args.reps, smi)
    del params
    torch.cuda.empty_cache()

    # phase 9: LM serving for the MoE, SSM, hybrid and audio families
    ssd0 = ssd.ssd_chunked.launches
    phase_lm_families(get_config, mods, ops, ref, counts, gen, args.seed,
                      args.reps, smi)
    ssd_kernel["launches"] = ssd.ssd_chunked.launches - ssd0
    ssd_kernel["launches_by_path"] = {"lm_families": ssd_kernel["launches"]}
    if not ssd_kernel["launches"]:
        fail("the main path launched no ssd_chunked")

    # phase 10: LM training, qwen3-0.6b at full width
    torch.cuda.empty_cache()
    phase_train(lm_cfg, (convert, stages, adamw, schedules, lm_mod,
                         data_mod, train_launch), ops, ref, counts, gen,
                args.seed, args.reps, smi)

    # phase 11: ring attention at full width, the dry run against the card
    torch.cuda.empty_cache()
    phase_ring_attention(CollectiveEngine, lm_cfg, attn_mod, gen, args.reps,
                         smi)
    phase_dryrun(lm_cfg, (convert, stages, adamw, schedules, lm_mod,
                          data_mod, train_launch), ops, ref, counts,
                 args.seed, smi)
    phase_dry_cells(get_config, (convert, stages, adamw, schedules, lm_mod,
                                 data_mod, train_launch), ops, ref, counts,
                    args.seed, smi, CONFIG, DLRMServer)

    # phase 12: one rank per process, 8 processes on the card
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    phase_procs(CollectiveEngine, procs, ops, counts, args.seed, args.mib,
                args.reps, smi, CONFIG)

    # phase 13: LM serving and training one rank per process
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # phase 14: the other LM families and the elastic shrink one rank per
    # process, in phase 13's world
    phase_lm_procs(lm_cfg, (convert, stages, adamw, schedules, lm_mod,
                            data_mod, serve_launch), procs,
                   CollectiveEngine, ops, counts, args.seed, smi, get_config)
    for row in rows:      # launches on every path's runs (K1 runs on all)
        row["launches"] = sum(c[row["name"]] for c in counts.values())
        if not row["launches"]:
            fail(f"the main path launched no {row['name']}")
        by_path: dict = {}
        for key, c in counts.items():
            path = next((p for p in ("dlrm", "vecmat", "queue",
                                     "lm_families", "lm", "train",
                                     "dryrun", "procs_lm", "procs_families",
                                     "procs")
                         if key.startswith(p)), "collectives")
            by_path[path] = by_path.get(path, 0) + c[row["name"]]
        row["launches_by_path"] = by_path
        if "lookup" in row:   # every K5 launch of the DLRM path is a lookup
            row["lookup"]["launches"] = sum(
                c["gather_rows"] for k, c in counts.items()
                if k.startswith("dlrm"))
    rows.append(ssd_kernel)
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
