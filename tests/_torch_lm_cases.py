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
}
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


def tokens(case: str, seed: int = 0, s: int = S):
    vocab = configs(case)[1].vocab_size
    return np.random.default_rng(seed).integers(
        0, vocab, (B, s)).astype(np.int32)


def batch_np(case: str, s: int = S) -> dict:
    """A prefill batch: tokens, and a VLM's visual prefix embeddings."""
    cfg = configs(case)[1]
    out = {"tokens": tokens(case, s=s)}
    if cfg.family == "vlm":
        out["vis_embed"] = np.random.default_rng(1).standard_normal(
            (B, cfg.n_vis_tokens, cfg.d_model)).astype(np.float32)
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
    """The reference's teacher-forced decode of `tokens(case)`: (B, S)
    greedy predictions and the final caches (numpy)."""
    jpcfg, _ = pcfgs(kv_cache_dtype=kv)
    JAX_COMPILES["n"] += 1
    dstep, _, _, _ = jax_stages.build_decode_step(
        configs(case)[0], jpcfg, jax_mesh(), s_max=S, global_batch=B)
    cache = jax_stages.init_cache(configs(case)[0], jpcfg, jax_mesh(), 2,
                                  B, S)
    toks = tokens(case)
    preds = []
    for t in range(S):
        nxt, cache = dstep(jax_params(case), cache,
                           jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        preds.append(np.asarray(nxt))
    return np.stack(preds, 1), jax.tree.map(np.asarray, cache)


def port_decode(case: str, kv: str = "param"):
    """The port's teacher-forced decode of `tokens(case)` on the CPU:
    (B, S) predictions and the final stacked caches."""
    cfg = configs(case)[1]
    _, pcfg = pcfgs(kv_cache_dtype=kv)
    dstep, _, _, _ = stages.build_decode_step(cfg, pcfg, MESH, s_max=S,
                                              global_batch=B, device="cpu")
    cache = stages.init_cache(cfg, pcfg, MESH, 2, B, S, device="cpu")
    params = port_params(case, serve=True)
    toks = tokens(case)
    preds = []
    for t in range(S):
        nxt, cache = dstep(params, cache, stack(toks[:, t:t + 1], (DP, None)),
                           t)
        preds.append(convert.from_stacked(nxt, MESH, (DP,)))
    return np.stack(preds, 1), cache


@functools.lru_cache(maxsize=None)
def jax_prefill(case: str):
    """The reference's prefill of `batch_np(case)`: (next tokens, caches)."""
    jpcfg, _ = pcfgs()
    JAX_COMPILES["n"] += 1
    pf, _, _, _ = jax_stages.build_prefill(configs(case)[0], jpcfg,
                                           jax_mesh(), B, S)
    nxt, caches = pf(jax_params(case),
                     {k: jnp.asarray(v) for k, v in batch_np(case).items()})
    return np.asarray(nxt), jax.tree.map(np.asarray, caches)


def port_prefill(case: str, **pcfg_kw):
    """The port's prefill of `batch_np(case)` on the CPU: (next tokens,
    the caches as the reference's global arrays, the engine's trace log)."""
    cfg = configs(case)[1]
    _, pcfg = pcfgs(**pcfg_kw)
    pf, ctx, _, bspec = stages.build_prefill(cfg, pcfg, MESH, B, S,
                                             device="cpu")
    batch = {k: stack(v, bspec[k]) for k, v in batch_np(case).items()}
    nxt, caches = pf(port_params(case, serve=True), batch)
    return (convert.from_stacked(nxt, MESH, (DP,)),
            convert.prefill_caches_to_jax(caches, cfg, pcfg, MESH, B, S),
            ctx.engine.trace_log)


def first_layer_specs(case: str):
    """The reference's FSDP param specs with layer 0's leaves unstacked."""
    specs = jax_stages.param_specs(configs(case)[0], 2)
    return jax.tree.map(lambda s: P(*tuple(s)[1:]), specs["layers"],
                        is_leaf=lambda x: isinstance(x, P))
