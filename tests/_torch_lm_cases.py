"""Shared cases of the port's LM tests (`test_torch_lm.py`,
`test_torch_serve.py`): reduced configs on the (pod, data, model) =
(2, 2, 2) mesh, the JAX reference on conftest's 8 host devices, the
port on the CPU with the same 8 ranks stacked.

Params are drawn by the reference's `init_params` and carried across by
`convert.lm_params_from_jax`; tokens and other inputs come from numpy
seeds. JAX programs are built once per case (`lru_cache`) and every
builder here counts its compiles in `JAX_COMPILES`.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.configs.base import ParallelConfig as JaxParallelConfig
from repro.core.topology import make_mesh
from repro.parallel import stages as jax_stages
from repro_torch import convert
from repro_torch.configs import ParallelConfig, get_config, reduced_config
from repro_torch.parallel import stages

MESH = {"pod": 2, "data": 2, "model": 2}
DP = ("pod", "data")
B, S = 4, 16
TOL = dict(rtol=1e-5, atol=1e-5)   # fp32 hidden states, two frameworks

# name -> (arch id, reduced_config overrides)
CASES = {
    "qwen": ("qwen3-0.6b", {}),
    # padded heads (3 -> 4 at tp 2), KV replicated, the decode cache
    # sequence-sharded and the flash-combine: three engine allreduces per
    # layer (one op="max")
    "smollm31": ("smollm-360m", {"n_heads": 3, "n_kv_heads": 1}),
    # KV replicated (3 kv heads do not split over tp 2) with GQA groups of
    # 2: each rank's q heads read other kv heads (rank 0: 0, 0, 1; rank 1:
    # 1, 2, 2)
    "smollm63": ("smollm-360m", {"n_heads": 6, "n_kv_heads": 3}),
    # the rolling sliding-window cache (no dense config sets a window)
    "qwen_sw8": ("qwen3-0.6b", {"sliding_window": 8}),
    # the visual prefix in prefill
    "internvl": ("internvl2-26b", {}),
    # MoE: 4 experts, top-2, SWA 32; dispatch over the EP (= TP) axis
    "mixtral": ("mixtral-8x7b", {}),
    # one expert on 2 ranks: pseudo-experts (f = 2 halves of d_ff)
    "mixtral_pe": ("mixtral-8x7b", {"n_experts": 1, "experts_per_token": 1}),
    "qwen3moe": ("qwen3-moe-30b-a3b", {}),
    # Mamba2: one SSD chunk at S = 16, two at S = 32
    "mamba": ("mamba2-1.3b", {}),
    "mamba_2chunks": ("mamba2-1.3b", {}),
    # hybrid: attention + SSM in parallel, layer 0 global, layer 1 SWA 32
    "hymba": ("hymba-1.5b", {}),
    # 5 SSM heads padded to 6 at tp 2 (d_model 40: d_inner 80, heads of 16)
    "hymba_pad": ("hymba-1.5b", {"d_model": 40}),
    # encoder-decoder: 12 stub frames, cross-attention, static cross cache
    "whisper": ("whisper-medium", {}),
    # encoder-decoder with KV replicated (1 kv head at tp 2): the self
    # cache sequence-sharded, the static cross cache whole
    "whisper_rep": ("whisper-medium", {"n_kv_heads": 1}),
    # hybrid with hymba's head layout: 15 q heads padded to 16, 3 KV
    # heads replicated (groups of 5), windowed and global layers
    "hymba_rep": ("hymba-1.5b", {"n_heads": 15, "n_kv_heads": 3}),
}
# per-case ParallelConfig fields: MoE at the reference's decode-test
# capacity (no assignment drops in the forward, so decode == forward);
# whisper's blocks tile its 12 frames and 16 tokens in several blocks
CASE_PCFG = {
    "mixtral": {"moe_capacity_factor": 16.0},
    "mixtral_pe": {"moe_capacity_factor": 16.0},
    "qwen3moe": {"moe_capacity_factor": 16.0},
    "whisper": {"attn_q_block": 4, "attn_kv_block": 4},
    "whisper_rep": {"attn_q_block": 4, "attn_kv_block": 4},
}
CASE_S = {"mamba_2chunks": 32}     # prompt length where not S
S_ENC = {"whisper": 12, "whisper_rep": 12}   # stub encoder frames
JAX_COMPILES = {"n": 0}


def configs(case: str):
    """(reference ArchConfig, port ArchConfig) of a case."""
    arch, over = CASES[case]
    return (jax_reduced_config(jax_get_config(arch), **over),
            reduced_config(get_config(arch), **over))


def pcfgs(**kw):
    """(reference, port) ParallelConfig with the same fields."""
    kw.setdefault("remat", "none")
    return JaxParallelConfig(**kw), ParallelConfig(**kw)


def case_pcfgs(case: str, **kw):
    """pcfgs with the case's own fields (`CASE_PCFG`), then `kw`."""
    return pcfgs(**{**CASE_PCFG.get(case, {}), **kw})


def seq_len(case: str) -> int:
    return CASE_S.get(case, S)


@functools.lru_cache(maxsize=None)
def jax_mesh():
    return make_mesh((2, 2, 2), ("pod", "data", "model"))


@functools.lru_cache(maxsize=None)
def jax_params(case: str):
    return jax_stages.init_params(configs(case)[0], jax_mesh(), 2, seed=0)


@functools.lru_cache(maxsize=None)
def params_np(case: str):
    return jax.tree.map(np.asarray, jax_params(case))


def port_params(case: str, serve: bool):
    return convert.lm_params_from_jax(params_np(case), configs(case)[1],
                                      MESH, serve=serve)


def tokens(case: str, seed: int = 0, s: int = None):
    vocab = configs(case)[1].vocab_size
    return np.random.default_rng(seed).integers(
        0, vocab, (B, s or seq_len(case))).astype(np.int32)


def batch_np(case: str, s: int = None) -> dict:
    """A prefill batch: tokens, a VLM's visual prefix embeddings, the
    audio family's stub frames."""
    cfg = configs(case)[1]
    out = {"tokens": tokens(case, s=s)}
    if cfg.family == "vlm":
        out["vis_embed"] = np.random.default_rng(1).standard_normal(
            (B, cfg.n_vis_tokens, cfg.d_model)).astype(np.float32)
    if cfg.encoder_layers:
        out["frames"] = np.random.default_rng(2).standard_normal(
            (B, S_ENC[case], cfg.d_model)).astype(np.float32)
    return out


def stack(x, spec):
    return convert.to_stacked(x, MESH, spec)


def shard_map(fn, in_specs, out_specs):
    """jit(shard_map(fn)) over the (2, 2, 2) host mesh, counted."""
    from repro.core.compat import shard_map as smap
    JAX_COMPILES["n"] += 1
    return jax.jit(smap(fn, mesh=jax_mesh(), in_specs=in_specs,
                        out_specs=out_specs, check_vma=False))


@functools.lru_cache(maxsize=None)
def jax_decode(case: str, kv: str = "param"):
    """The reference's teacher-forced decode of `tokens(case)` from zero
    caches (an audio case's cross cache too): (B, S) greedy predictions
    and the final caches (numpy)."""
    jpcfg, _ = case_pcfgs(case, kv_cache_dtype=kv)
    s, s_enc = seq_len(case), S_ENC.get(case, 0)
    JAX_COMPILES["n"] += 1
    dstep, _, _, _ = jax_stages.build_decode_step(
        configs(case)[0], jpcfg, jax_mesh(), s_max=s, global_batch=B,
        s_enc=s_enc)
    cache = jax_stages.init_cache(configs(case)[0], jpcfg, jax_mesh(), 2,
                                  B, s, s_enc=s_enc)
    toks = tokens(case)
    preds = []
    for t in range(s):
        nxt, cache = dstep(jax_params(case), cache,
                           jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        preds.append(np.asarray(nxt))
    return np.stack(preds, 1), jax.tree.map(np.asarray, cache)


def port_decode(case: str, kv: str = "param"):
    """The port's teacher-forced decode of `tokens(case)` on the CPU:
    (B, S) predictions and the final stacked caches."""
    cfg = configs(case)[1]
    _, pcfg = case_pcfgs(case, kv_cache_dtype=kv)
    s, s_enc = seq_len(case), S_ENC.get(case, 0)
    dstep, _, _, _ = stages.build_decode_step(cfg, pcfg, MESH, s_max=s,
                                              global_batch=B, s_enc=s_enc,
                                              device="cpu")
    cache = stages.init_cache(cfg, pcfg, MESH, 2, B, s, s_enc=s_enc,
                              device="cpu")
    params = port_params(case, serve=True)
    toks = tokens(case)
    preds = []
    for t in range(s):
        nxt, cache = dstep(params, cache, stack(toks[:, t:t + 1], (DP, None)),
                           t)
        preds.append(convert.from_stacked(nxt, MESH, (DP,)))
    return np.stack(preds, 1), cache


@functools.lru_cache(maxsize=None)
def jax_prefill(case: str):
    """The reference's prefill of `batch_np(case)`: (next tokens, caches)."""
    jpcfg, _ = case_pcfgs(case)
    JAX_COMPILES["n"] += 1
    pf, _, _, _ = jax_stages.build_prefill(configs(case)[0], jpcfg,
                                           jax_mesh(), B, seq_len(case))
    nxt, caches = pf(jax_params(case),
                     {k: jnp.asarray(v) for k, v in batch_np(case).items()})
    return np.asarray(nxt), jax.tree.map(np.asarray, caches)


def port_prefill(case: str, **pcfg_kw):
    """The port's prefill of `batch_np(case)` on the CPU: (next tokens,
    the caches as the reference's global arrays, the engine's trace log)."""
    cfg = configs(case)[1]
    _, pcfg = case_pcfgs(case, **pcfg_kw)
    s = seq_len(case)
    pf, ctx, _, bspec = stages.build_prefill(cfg, pcfg, MESH, B, s,
                                             device="cpu")
    batch = {k: stack(v, bspec[k]) for k, v in batch_np(case).items()}
    nxt, caches = pf(port_params(case, serve=True), batch)
    return (convert.from_stacked(nxt, MESH, (DP,)),
            convert.prefill_caches_to_jax(caches, cfg, pcfg, MESH, B, s),
            ctx.engine.trace_log)


def owner_gathered(cache, case: str, tp: int = 2):
    """A replicated-KV cache (..., S, n_kv, hd), sequence-sharded over tp
    ranks, as the reference's prefill emits it: each rank's slice of the
    sequence holds its local q heads' owner kv heads (the port's holds
    the kv heads themselves, the layout decode reads: ROADMAP Queue 3)."""
    cfg = configs(case)[1]
    hl = -(-cfg.n_heads // tp)
    group = max(cfg.n_heads // cfg.n_kv_heads, 1)
    sl = cache.shape[-3] // tp
    parts = []
    for r in range(tp):
        owner = np.clip((r * hl + np.arange(hl)) // group, 0,
                        cfg.n_kv_heads - 1)
        parts.append(cache[..., r * sl:(r + 1) * sl, :, :][..., owner, :])
    return np.concatenate(parts, axis=-3)


def first_layer_specs(case: str):
    """The reference's FSDP param specs with layer 0's leaves unstacked."""
    specs = jax_stages.param_specs(configs(case)[0], 2)
    return jax.tree.map(lambda s: P(*tuple(s)[1:]), specs["layers"],
                        is_leaf=lambda x: isinstance(x, P))
