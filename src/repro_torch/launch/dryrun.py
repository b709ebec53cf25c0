"""Production dry run: every (arch x shape x mesh) cell on 'meta' tensors.

Port of `repro/launch/dryrun.py`. The reference lowers and compiles each
cell for 256 or 512 virtual devices and reads XLA's memory and cost
analyses. The port runs the cell's own step — `build_train_step`,
`build_prefill` or `build_decode_step` on the production mesh — once,
eagerly, on storage-free 'meta' tensors: params, AdamW state, caches
and the batch are shapes only, each kernel entry point gives its
output's shape (`kernels/ops.py`), nothing is allocated and no card is
needed. The counters of
`launch/analysis.py` read the run:

  * memory per rank: argument, output, temp and alias bytes and their
    `peak_bytes_est` (= argument + the peak of the live bytes the step
    made), and whether it fits the spec's HBM;
  * FLOPs per rank, collective wire bytes per rank (ICI and DCN) and
    the three roofline terms with the dominant one.

Every rank's copy of a tensor is stacked, so a per-rank value is the
stacked total over the rank count; a tensor that is not stacked (the
optimizer's step count) is counted once, whole, and named in
`memory.unstacked_argument_bytes`. Terms priced on `TPU_V5E` (the
default, as the reference and the selector price) are a model of that
spec, not a time of any card this runs on.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  python -m repro_torch.launch.dryrun --arch dlrm
  python -m repro_torch.launch.dryrun --all [--multi-pod]

--all runs one subprocess per cell (resumable: cells with an existing
result JSON are skipped). Each cell prints its host seconds: a
production mesh puts a 16-rank ring under every collective, and the
eager run walks every ring step of every layer.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import ParallelConfig
from repro_torch.core.hw_spec import TPU_V5E
from repro_torch.launch import analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.common import Builder, dt
from repro_torch.optim import adamw
from repro_torch.parallel import stages

WHISPER_S_ENC = 1500  # 30 s of audio frames (decode cross-attention cache)


def input_shapes(cfg, shape_cfg, mesh_shape: dict, kind: str) -> dict:
    """Meta stand-ins for every model input of the cell, stacked."""
    b, s = shape_cfg.global_batch, shape_cfg.seq_len
    dp = stages.dp_axes(mesh_shape, b)
    bld = Builder("shape", mesh_shape=dict(mesh_shape),
                  dtype=dt(cfg.param_dtype))
    if kind == "decode":
        return {"tokens": bld.param((b, 1), (dp, None), dtype=torch.int32)}
    out = {"tokens": bld.param((b, s), (dp, None), dtype=torch.int32)}
    if kind == "train":
        out["labels"] = bld.param((b, s), (dp, None), dtype=torch.int32)
    if cfg.family == "vlm":
        out["vis_embed"] = bld.param((b, cfg.n_vis_tokens, cfg.d_model),
                                     (dp, None, None))
    if cfg.encoder_layers:
        out["frames"] = bld.param((b, s, cfg.d_model), (dp, None, None))
    return out


def pcfg_from_args(args, backend=None) -> ParallelConfig:
    return ParallelConfig(
        backend=backend or args.backend,
        sequence_parallel=args.sp,
        collective_matmul=args.collective_matmul,
        remat=args.remat,
        grad_compression=args.compress or None,
        attn_q_block=args.q_block,
        attn_kv_block=args.kv_block,
        moe_capacity_factor=args.capacity,
        scan_layers=not args.no_scan,
        decode_seq_shard=not args.no_seq_shard,
        kv_cache_dtype=args.kv_cache,
        microbatches=args.microbatches,
    )


def _mesh_name(mesh_shape: dict) -> str:
    return "x".join(str(s) for s in mesh_shape.values())


def build_cell(cfg, shape_cfg, mesh_shape: dict, pcfg: ParallelConfig,
               s_enc: int = None):
    """(step thunk, engine, argument tree) of one cell's step on
    `mesh_shape`, every input a 'meta' tensor. A decode step of the audio
    family reads a cross cache of `s_enc` encoder positions (default
    WHISPER_S_ENC). Its position is a host int, where the reference's
    step takes a 4-byte int32 argument: `memory` counts no bytes for it."""
    kind = shape_cfg.kind
    tp = mesh_shape.get("model", 1)
    pshapes = stages.param_shapes(cfg, mesh_shape, tp, serve=kind != "train")
    batch = input_shapes(cfg, shape_cfg, mesh_shape, kind)
    if kind == "train":
        ts = stages.build_train_step(cfg, pcfg, mesh_shape,
                                     adamw.AdamWConfig(), device="meta")
        oshapes = adamw.adamw_init(pshapes)
        args = (pshapes, oshapes, batch)
        return (lambda: ts.fn(pshapes, oshapes, batch, 0)), ts.ctx.engine, \
            args
    if kind == "prefill":
        pf, ctx, _, _ = stages.build_prefill(
            cfg, pcfg, mesh_shape, shape_cfg.global_batch,
            shape_cfg.seq_len, device="meta")
        return (lambda: pf(pshapes, batch)), ctx.engine, (pshapes, batch)
    s_enc = (WHISPER_S_ENC if s_enc is None else s_enc) \
        if cfg.encoder_layers else 0
    dstep, ctx, _, _ = stages.build_decode_step(
        cfg, pcfg, mesh_shape, s_max=shape_cfg.seq_len,
        global_batch=shape_cfg.global_batch, s_enc=s_enc, device="meta")
    cshapes = stages.cache_shapes(
        cfg, pcfg, mesh_shape, tp, shape_cfg.global_batch, shape_cfg.seq_len,
        s_enc=s_enc, dp=stages.dp_axes(mesh_shape, shape_cfg.global_batch))
    pos = shape_cfg.seq_len - 1
    return (lambda: dstep(pshapes, cshapes, batch["tokens"], pos)), \
        ctx.engine, (pshapes, cshapes, batch)


def run_cell(arch_id: str, shape_id: str, multi_pod: bool,
             pcfg: ParallelConfig, variant: str = "base", tp: int = 16,
             hw=TPU_V5E):
    """One cell's result dict (the reference's schema), its terms priced
    on `hw`."""
    t_start = time.time()
    cfg = get_config(arch_id)
    shape_cfg = SHAPES[shape_id]
    mesh = make_production_mesh(multi_pod=multi_pod, tp=tp)
    result = {
        "arch": arch_id, "shape": shape_id, "mesh": _mesh_name(mesh),
        "chips": math.prod(mesh.values()), "backend": pcfg.backend,
        "variant": variant, "kind": shape_cfg.kind,
    }
    if shape_cfg.kind == "decode" and shape_cfg.seq_len >= 500_000 \
            and not cfg.is_subquadratic:
        result["status"] = "SKIP(full-attn)"
        return result
    fn, engine, args = build_cell(cfg, shape_cfg, mesh, pcfg)
    result["t_lower_s"] = round(time.time() - t_start, 2)
    n_active = cfg.n_active_params()
    tokens = shape_cfg.global_batch * (
        shape_cfg.seq_len if shape_cfg.kind != "decode" else 1)
    mult = 6 if shape_cfg.kind == "train" else 2
    return _finish(result, fn, engine, args, mesh,
                   mult * n_active * tokens, t_start, hw)


def _finish(result, fn, engine, args, mesh_shape, model_flops, t_start, hw):
    t0 = time.time()
    out, st = analysis.count(fn, [engine])
    result["t_run_s"] = round(time.time() - t0, 2)
    chips = result["chips"]
    mem = analysis.memory(args, out, st, mesh_shape)
    result["memory"] = mem
    result["fits_hbm"] = mem["peak_bytes_est"] < hw.hbm_bytes
    terms = analysis.roofline_terms(st, mem, hw, chips)
    result["roofline"] = terms
    result["model_flops"] = model_flops
    gf = terms["global_flops"]
    result["model_flops_ratio"] = model_flops / gf if gf else None
    step_time = max(terms["t_compute_s"], terms["t_memory_floor_s"],
                    terms["t_collective_s"])
    result["roofline_step_time_s"] = step_time
    result["roofline_mfu"] = model_flops / (
        chips * hw.peak_flops_bf16 * step_time) if step_time else None
    step_art = max(terms["t_compute_s"], terms["t_memory_s"],
                   terms["t_collective_s"])
    result["roofline_mfu_artifact"] = model_flops / (
        chips * hw.peak_flops_bf16 * step_art) if step_art else None
    result["hw"] = hw.name
    result["status"] = "OK"
    result["t_total_s"] = round(time.time() - t_start, 2)
    return result


def build_dlrm_cell(dcfg, mesh_shape: dict, pcfg: ParallelConfig,
                    batch: int):
    """(forward thunk, engine, argument tree) of the DLRM serving step on
    `mesh_shape`: the tables sharded over 'model' on rows, the FC stack
    checkerboard-decomposed, `batch` requests of `dcfg.n_tables` ids over
    the data axes; every input a 'meta' tensor (the counterpart of
    `build_cell` for `run_dlrm_cell`)."""
    from repro_torch.core.engine import CollectiveEngine
    from repro_torch.models import dlrm as dlrm_mod
    from repro_torch.parallel.ops import ParCtx

    pcfg = dataclasses.replace(pcfg, serving=True)
    engine = CollectiveEngine(mesh_shape, backend=pcfg.backend,
                              device="meta")
    ctx = ParCtx(engine=engine, pcfg=pcfg)
    bld = Builder("shape", mesh_shape=dict(mesh_shape), dtype=torch.float32)
    params = dlrm_mod.dlrm_params(bld, dcfg, mesh_shape["model"])
    dp = stages.dp_axes(mesh_shape, batch)
    idx = bld.param((batch, dcfg.n_tables), (dp, None), dtype=torch.int32)
    return (lambda: dlrm_mod.dlrm_forward(params, idx, ctx)), engine, \
        (params, idx)


def run_dlrm_cell(multi_pod: bool, pcfg: ParallelConfig,
                  variant: str = "base", batch: int = 1024, hw=TPU_V5E):
    """Paper Table 2 at full scale: 100 tables x 4M rows x 32 (51 GB fp32),
    sharded over the model axis; FC stack checkerboard-decomposed."""
    from repro_torch.configs.dlrm import CONFIG as dcfg

    t_start = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod)
    result = {"arch": "dlrm", "shape": f"serve_b{batch}",
              "mesh": _mesh_name(mesh), "chips": math.prod(mesh.values()),
              "backend": pcfg.backend, "variant": variant, "kind": "serve"}
    fn, engine, args = build_dlrm_cell(dcfg, mesh, pcfg, batch)
    result["t_lower_s"] = round(time.time() - t_start, 2)
    # FC flops (2*b*in*out summed) + embedding gather bytes dominate
    dims = (dcfg.n_tables * dcfg.emb_dim,) + tuple(dcfg.fc_dims) \
        + (dcfg.out_dim,)
    flops = sum(2 * batch * dims[i] * dims[i + 1]
                for i in range(len(dims) - 1))
    return _finish(result, fn, engine, args, mesh, flops, t_start, hw)


def all_cells():
    for arch_id in ARCH_IDS:
        for shape_id in SHAPES:
            yield arch_id, shape_id


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCH_IDS) + ["dlrm"])
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--backend", default="microcode",
                    choices=("microcode", "native"))
    ap.add_argument("--variant", default="base")
    ap.add_argument("--results", default="results/dryrun")
    ap.add_argument("--sp", action="store_true")
    ap.add_argument("--collective-matmul", action="store_true")
    ap.add_argument("--remat", default="full",
                    choices=("none", "full", "dots", "names"))
    ap.add_argument("--compress", default="")
    ap.add_argument("--q-block", type=int, default=512)
    ap.add_argument("--kv-block", type=int, default=1024)
    ap.add_argument("--capacity", type=float, default=1.25)
    ap.add_argument("--no-scan", action="store_true")
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--kv-cache", default="param", choices=("param", "int8"))
    ap.add_argument("--tp", type=int, default=16)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--timeout", type=int, default=3600)
    args = ap.parse_args(argv)
    os.makedirs(args.results, exist_ok=True)

    if args.all:
        failures = []
        for arch_id, shape_id in all_cells():
            tag = "multi" if args.multi_pod else "single"
            name = f"{arch_id}_{shape_id}_{tag}_{args.variant}.json"
            path = os.path.join(args.results, name)
            if os.path.exists(path):
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch_id, "--shape", shape_id,
                   "--backend", args.backend, "--variant", args.variant,
                   "--results", args.results, "--remat", args.remat,
                   "--tp", str(args.tp)]
            if args.multi_pod:
                cmd.append("--multi-pod")
            for flag, on in [("--sp", args.sp),
                             ("--collective-matmul", args.collective_matmul),
                             ("--no-scan", args.no_scan),
                             ("--no-seq-shard", args.no_seq_shard)]:
                if on:
                    cmd.append(flag)
            if args.compress:
                cmd += ["--compress", args.compress]
            print(f"[dryrun] {name} ...", flush=True)
            try:
                subprocess.run(cmd, check=True, timeout=args.timeout)
            except (subprocess.SubprocessError, OSError) as e:
                failures.append((name, str(e)))
                with open(path, "w") as f:
                    json.dump({"arch": arch_id, "shape": shape_id,
                               "status": f"SUBPROCESS_FAIL: {e}"}, f)
        print(f"[dryrun] done; {len(failures)} failures")
        for n, e in failures:
            print("  FAIL", n, e)
        return

    if not args.arch or not (args.shape or args.arch == "dlrm"):
        ap.error("--arch and --shape (or --all)")
    pcfg = pcfg_from_args(args)
    tag = "multi" if args.multi_pod else "single"
    shape_tag = args.shape or "serve_b1024"
    name = f"{args.arch}_{shape_tag}_{tag}_{args.variant}.json"
    path = os.path.join(args.results, name)
    try:
        if args.arch == "dlrm":
            result = run_dlrm_cell(args.multi_pod, pcfg, args.variant)
        else:
            result = run_cell(args.arch, args.shape, args.multi_pod, pcfg,
                              args.variant, tp=args.tp)
    except Exception as e:  # noqa: BLE001 — the cell's record says why
        result = {"arch": args.arch, "shape": args.shape,
                  "status": f"FAIL: {type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-4000:]}
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items()
                      if k not in ("traceback", "roofline")}, indent=1))
    if "roofline" in result:
        print(json.dumps(result["roofline"], indent=1))


if __name__ == "__main__":
    main()
