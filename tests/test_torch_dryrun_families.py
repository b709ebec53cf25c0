"""The port's dry run (`launch/dryrun.py`) against the reference's compiled
step for every family, step kind and variant, at 2 layers on the CPU.

One helper lowers and compiles the reference's step (train, prefill,
decode, or the DLRM forward under `shard_map`) on a mesh of the 8 host
devices and runs the port's `build_cell` / `build_dlrm_cell` on 'meta'
under `launch/analysis.py`'s counters. For every cell it asserts argument
bytes against `memory_analysis()`, and FLOPs, ICI and DCN wire bytes per
device against `repro.launch.analysis.analyze_hlo`: equal, or differing
by the exact amounts of `compiler_differences`, each computed from the
config and the mesh (ROADMAP Queue 3):

  * argument bytes: jit drops the arguments a step never reads (whisper's
    encoder and cross-attention k/v projections in a decode step), which
    the port reports as `unread_argument_bytes`; and the reference's
    decode position is a 4-byte int32 argument where the port's is a host
    int (mamba2's decode never reads it, so jit drops it there too);
  * FLOPs: XLA turns a product whose contraction is 1 into a multiply
    (the MoE combine's adjoint for the expert outputs, one per MoE layer
    of a train step); jnp.einsum contracts the SSD chunk state's
    three-operand einsum through a product whose adjoint is a dot over
    the head dim, which torch's einsum adjoint makes a multiply and a
    sum (one per SSM layer of a train step); under remat XLA drops the
    recomputed forward's attention product of every attention block as
    dead, and where remat='names' saves a self-attention's output its
    output projection and the TP allreduce after it (wire bytes too);
  * wire bytes: XLA merges the FSDP gathers of the embedding and the
    head (one table when tied) across the microbatches (hoisted out of
    the microbatch scan) into one a table.

The default set runs the cells ROADMAP Queue 1 item 2 names;
VERIFY_EXHAUSTIVE=1 runs every arch x kind with every remat, the int8
kv cache, the native backend and the (2, 2, 2) mesh. Never import
`repro.launch.dryrun` here: it rewrites XLA_FLAGS for the process.
"""
import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.configs import dlrm as jax_dlrm_configs
from repro.configs.base import ParallelConfig as JaxParallelConfig
from repro.core.compat import shard_map
from repro.core.engine import CollectiveEngine as JaxEngine
from repro.core.topology import make_mesh as jax_make_mesh
from repro.launch import analysis as jax_analysis
from repro.models import dlrm as jax_dlrm
from repro.models.common import Builder as JaxBuilder
from repro.models.common import dt as jax_dt
from repro.optim import adamw as jax_adamw
from repro.parallel import stages as jax_stages
from repro.parallel.ops import ParCtx as JaxParCtx
from repro_torch.configs import ARCH_IDS, ParallelConfig, get_config
from repro_torch.configs import dlrm as dlrm_configs
from repro_torch.configs import reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import analysis, dryrun
from repro_torch.models import mlp
from repro_torch.models.common import dt
from repro_torch.parallel import stages

AXES = ("pod", "data", "model")
B, S, LAYERS = 8, 64, 2
S_ENC = 64              # whisper's encoder positions in a decode step
DLRM_BATCH = 32
POS_BYTES = 4           # the reference's int32 decode position
# LLVM's optimizations of the CPU code only: the compiled HLO the counters
# read (and `memory_analysis()`) are the same with them off, the compile
# ~20% faster
FAST_BACKEND = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def configs(arch: str):
    """(reference, port) configs of `arch` at LAYERS layers."""
    if arch == "dlrm":
        return jax_dlrm_configs.reduced(), dlrm_configs.reduced()
    return (jax_reduced_config(jax_get_config(arch), n_layers=LAYERS),
            reduced_config(get_config(arch), n_layers=LAYERS))


def lower_reference(arch: str, kind: str, pkw: dict, mesh_t: tuple):
    """The reference's step of one cell lowered on `mesh_t` of the host
    devices: train, prefill or decode of an LM, or the DLRM forward
    (`arch` 'dlrm') under `shard_map` as `repro/launch/dryrun.py` lowers
    it."""
    jcfg, _ = configs(arch)
    mesh = jax_make_mesh(mesh_t, AXES)
    tp = mesh_t[2]
    batch = DLRM_BATCH if arch == "dlrm" else B
    dp = jax_stages.dp_axes(mesh, batch)

    def sds(shape, dtype, spec):
        return jax.ShapeDtypeStruct(shape, dtype,
                                    sharding=NamedSharding(mesh, spec))

    pcfg = JaxParallelConfig(**pkw)
    if arch == "dlrm":
        ctx = JaxParCtx(engine=JaxEngine(mesh, backend=pcfg.backend),
                        pcfg=dataclasses.replace(pcfg, serving=True),
                        mesh=mesh)
        fn = jax.jit(shard_map(
            lambda p, i: jax_dlrm.dlrm_forward(p, i, ctx), mesh=mesh,
            in_specs=(jax_dlrm.dlrm_specs(jcfg, tp), P(dp, None)),
            out_specs=P(dp, None), check_vma=False))
        lowered = fn.lower(
            jax_dlrm.dlrm_params(JaxBuilder("shape", mesh=mesh,
                                            dtype=jnp.float32), jcfg, tp),
            sds((batch, jcfg.n_tables), jnp.int32, P(dp, None)))
    elif kind == "decode":
        s_enc = S_ENC if jcfg.encoder_layers else 0
        dstep, _, _, _ = jax_stages.build_decode_step(
            jcfg, pcfg, mesh, s_max=S, global_batch=B, s_enc=s_enc)
        lowered = dstep.lower(
            jax_stages.param_shapes(jcfg, mesh, tp, serve=True),
            jax_stages.cache_shapes(jcfg, pcfg, mesh, tp, B, S, s_enc=s_enc,
                                    dp=dp),
            sds((B, 1), jnp.int32, P(dp, None)),
            jax.ShapeDtypeStruct((), jnp.int32))
    else:
        tokens = sds((B, S), jnp.int32, P(dp, None))
        inputs = {"tokens": tokens}
        cdt = jax_dt(jcfg.param_dtype)
        if jcfg.family == "vlm":
            inputs["vis_embed"] = sds((B, jcfg.n_vis_tokens, jcfg.d_model),
                                      cdt, P(dp, None, None))
        if jcfg.encoder_layers:
            inputs["frames"] = sds((B, S, jcfg.d_model), cdt,
                                   P(dp, None, None))
        if kind == "train":
            inputs["labels"] = tokens
            ts = jax_stages.build_train_step(jcfg, pcfg, mesh,
                                             jax_adamw.AdamWConfig())
            ps = jax_stages.param_shapes(jcfg, mesh, tp)
            f32 = lambda sd: jax.ShapeDtypeStruct(  # noqa: E731
                sd.shape, jnp.float32, sharding=sd.sharding)
            opt = {"leaves": jax.tree.map(
                lambda sd: {"master": f32(sd), "m": f32(sd), "v": f32(sd)},
                ps, is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct)),
                "count": jax.ShapeDtypeStruct((), jnp.int32)}
            lowered = ts.fn.lower(ps, opt, inputs,
                                  jax.ShapeDtypeStruct((), jnp.int32))
        else:
            pf, _, _, _ = jax_stages.build_prefill(jcfg, pcfg, mesh, B, S)
            lowered = pf.lower(
                jax_stages.param_shapes(jcfg, mesh, tp, serve=True), inputs)
    return lowered


def reference_stats(compiled, mesh_t: tuple):
    """(memory_analysis, analyze_hlo stats) of a compiled reference step;
    a pod axis over 1 makes the devices of each pod one DCN island
    (`pod_size`)."""
    pod_size = mesh_t[1] * mesh_t[2] if mesh_t[0] > 1 else 0
    return (compiled.memory_analysis(),
            jax_analysis.analyze_hlo(compiled.as_text(), pod_size))


def reference(arch: str, kind: str, pkw: dict, mesh_t: tuple):
    """(memory_analysis, analyze_hlo stats) of one cell's reference step."""
    lowered = lower_reference(arch, kind, pkw, mesh_t)
    return reference_stats(lowered.compile(compiler_options=FAST_BACKEND),
                           mesh_t)


def port(arch: str, kind: str, pkw: dict, mesh_t: tuple):
    """(memory dict, StepStats) of the port's step of the same cell, run
    once on 'meta' under the dry run's counters."""
    _, cfg = configs(arch)
    mesh = dict(zip(AXES, mesh_t))
    if arch == "dlrm":
        fn, eng, args = dryrun.build_dlrm_cell(cfg, mesh,
                                               ParallelConfig(**pkw),
                                               DLRM_BATCH)
    else:
        fn, eng, args = dryrun.build_cell(cfg, ShapeConfig("cell", S, B,
                                                           kind),
                                          mesh, ParallelConfig(**pkw),
                                          s_enc=S_ENC)
    out, st = analysis.count(fn, [eng])
    return analysis.memory(args, out, st, mesh), st


def _layers(cfg) -> dict:
    """Layers of each mixer kind the step runs."""
    return {"attn": cfg.n_layers if cfg.n_heads else 0,
            "moe": cfg.n_layers if cfg.n_experts else 0,
            "ssm": cfg.n_layers if cfg.ssm_state else 0}


def unread_leaves(cfg, kind: str, mesh: dict) -> int:
    """Per-device bytes of the serving params a decode step never reads:
    whisper's encoder (its output is the cross cache) and the cross
    attention's k and v projections (the cross cache holds their
    product). The port's dry run counts them as it runs
    (`unread_argument_bytes`); jit drops them from the compiled step."""
    if kind != "decode" or not cfg.encoder_layers:
        return 0
    shapes = stages.param_shapes(cfg, mesh, mesh["model"], serve=True)
    leaves = [shapes["enc_norm"], *analysis.tensors(shapes["enc_layers"]),
              shapes["layers"]["xattn"]["wk"],
              shapes["layers"]["xattn"]["wv"]]
    return sum(t.numel() * t.element_size() for t in leaves) \
        // math.prod(mesh.values())


def compiler_differences(cfg, kind: str, pcfg: ParallelConfig,
                         mesh: dict) -> dict:
    """Port minus reference, per device, of each counter: what the
    compiler (or jit, or jnp.einsum) does that an eager step does not.
    Every term is exact; see the module doc and ROADMAP Queue 3."""
    d = {"argument_bytes": 0, "flops": 0, "ici": 0, "dcn": 0}
    if kind == "decode":
        d["argument_bytes"] = unread_leaves(cfg, kind, mesh) - (
            POS_BYTES if cfg.n_heads else 0)
    if kind != "train":
        return d
    tp = mesh["model"]
    b_l = B // (mesh["pod"] * mesh["data"])
    lay = _layers(cfg)
    if lay["moe"]:
        # the combine's adjoint for the picked expert outputs: a
        # (t, k f, 1) @ (t, 1, d) product per MoE layer
        t = b_l * S // tp if S % tp == 0 else b_l * S
        kf = cfg.experts_per_token * mlp.moe_factor(cfg, tp)
        d["flops"] += lay["moe"] * 2 * t * kf * cfg.d_model
    if lay["ssm"]:
        # the SSD chunk state's adjoint for decay * dt: a dot over the
        # head dim, b c l h_l p = b_l S (d_inner / tp)
        d["flops"] -= lay["ssm"] * 2 * b_l * S * cfg.ssm_d_inner // tp
    if pcfg.remat != "none" and lay["attn"]:
        # the recomputed forward's attention product (probs @ v) of every
        # attention block: self, an encoder's and the cross attention
        hd_l = cfg.n_heads // tp * cfg.resolved_head_dim
        blocks = lay["attn"] + cfg.encoder_layers + (
            cfg.n_layers if cfg.encoder_layers else 0)
        d["flops"] += blocks * 2 * b_l * S * S * hd_l
        if pcfg.remat == "names" and cfg.family != "hybrid":
            # remat='names' saves a self-attention's output (`mixer_out`;
            # a hybrid names its mixed output): its output projection and
            # the TP allreduce after it are dead in the recompute too
            named = lay["attn"] + cfg.encoder_layers
            rb = b_l * S * cfg.d_model * dt(cfg.compute_dtype).itemsize
            d["flops"] += named * 2 * b_l * S * hd_l * cfg.d_model
            d["ici"] += named * 2 * rb * (tp - 1) // tp
    # the embedding's and the head's FSDP gathers, one each a microbatch
    # in the port, merged into one a table by XLA
    shard = cfg.vocab_size * cfg.d_model * dt(cfg.param_dtype).itemsize \
        // (mesh["data"] * tp)
    tables = 1 if cfg.tie_embeddings else 2
    d["ici"] += (2 * pcfg.microbatches - tables) * (mesh["data"] - 1) * shard
    return d


def check_cell(arch: str, kind: str, pkw: dict, mesh_t: tuple) -> None:
    """Assert the port's counters of one cell against the reference's
    compiled step, exactly."""
    mem, hlo = reference(arch, kind, pkw, mesh_t)
    pmem, st = port(arch, kind, pkw, mesh_t)
    _, cfg = configs(arch)
    mesh = dict(zip(AXES, mesh_t))
    d = compiler_differences(cfg, kind, ParallelConfig(**pkw), mesh)
    n = math.prod(mesh_t)
    assert pmem["unread_argument_bytes"] == unread_leaves(cfg, kind, mesh)
    assert pmem["argument_bytes"] - mem.argument_size_in_bytes == \
        d["argument_bytes"]
    assert st.flops / n - hlo.flops == d["flops"]
    ici = st.coll_wire_bytes - st.coll_dcn_bytes
    assert ici - (hlo.coll_wire_bytes - hlo.coll_dcn_bytes) == d["ici"]
    assert st.coll_dcn_bytes - hlo.coll_dcn_bytes == d["dcn"]
    assert st.coll_ops > 0


M142, M222, M118 = (1, 4, 2), (2, 2, 2), (1, 1, 8)
NONE = {"remat": "none"}

# (arch, kind, ParallelConfig fields, mesh): ROADMAP Queue 1 item 2's set
DEFAULT = {
    "qwen_decode": ("qwen3-0.6b", "decode", {}, M142),
    "whisper_decode": ("whisper-medium", "decode", {}, M142),
    "moe_decode": ("qwen3-moe-30b-a3b", "decode", {}, M142),
    "mixtral_train": ("mixtral-8x7b", "train", NONE, M142),
    "mamba_train": ("mamba2-1.3b", "train", NONE, M142),
    "hymba_train": ("hymba-1.5b", "train", NONE, M142),
    "moe_train_remat_full": ("qwen3-moe-30b-a3b", "train",
                             {"remat": "full"}, M142),
    # int8 buckets with SP + the collective matmul: the padded codec wire
    # and allgather_matmul's adjoint in one step
    "qwen_train_int8_sp_cm": ("qwen3-0.6b", "train",
                              {**NONE, "grad_compression": "int8",
                               "sequence_parallel": True,
                               "collective_matmul": True}, M142),
    # two microbatches on (2, 2, 2): the DCN bytes of the pod axis too
    "qwen_train_mb2_222": ("qwen3-0.6b", "train",
                           {**NONE, "microbatches": 2}, M222),
    "mixtral_prefill": ("mixtral-8x7b", "prefill", {}, M142),
    "mamba_prefill": ("mamba2-1.3b", "prefill", {}, M142),
    "whisper_prefill": ("whisper-medium", "prefill", {}, M142),
    "hymba_prefill": ("hymba-1.5b", "prefill", {}, M142),
    "internvl_prefill": ("internvl2-26b", "prefill", {}, M142),
    "dlrm": ("dlrm", "serve", {}, M118),
    "dlrm_cm": ("dlrm", "serve", {"collective_matmul": True}, M142),
}


@pytest.mark.parametrize("cell", sorted(DEFAULT))
def test_cell_against_compiled_reference(cell):
    check_cell(*DEFAULT[cell])


def _exhaustive() -> dict:
    cells = {}
    for arch in ARCH_IDS:
        for remat in ("none", "full", "dots", "names"):
            cells[f"{arch}-train-{remat}"] = (arch, "train",
                                              {"remat": remat}, M142)
        for kind in ("prefill", "decode"):
            cells[f"{arch}-{kind}"] = (arch, kind, {}, M142)
        cells[f"{arch}-decode-int8kv"] = (arch, "decode",
                                          {"kv_cache_dtype": "int8"}, M142)
        for variant, pkw in (
                ("int8", {"grad_compression": "int8"}),
                ("sp-cm", {"sequence_parallel": True,
                           "collective_matmul": True}),
                ("mb2", {"microbatches": 2})):
            cells[f"{arch}-train-{variant}"] = (arch, "train",
                                                {**NONE, **pkw}, M142)
        for kind, pkw in (("train", NONE), ("prefill", {}), ("decode", {})):
            cells[f"{arch}-{kind}-native"] = (arch, kind,
                                              {**pkw, "backend": "native"},
                                              M142)
            cells[f"{arch}-{kind}-2x2x2"] = (arch, kind, pkw, M222)
    cells["dlrm-native"] = ("dlrm", "serve", {"backend": "native"}, M118)
    cells["dlrm-2x2x2"] = ("dlrm", "serve", {}, M222)
    return cells


EXHAUSTIVE = _exhaustive() if os.environ.get("VERIFY_EXHAUSTIVE") else {}


@pytest.mark.skipif(not EXHAUSTIVE, reason="VERIFY_EXHAUSTIVE=1 runs the "
                    "whole arch x kind x variant grid")
@pytest.mark.parametrize("cell", sorted(EXHAUSTIVE) or ["grid"])
def test_grid_against_compiled_reference(cell):
    check_cell(*EXHAUSTIVE[cell])

