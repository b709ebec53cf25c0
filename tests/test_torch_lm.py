"""The port's LM modules against the JAX package, at reduced size on the
(2, 2, 2) mesh (`_torch_lm_cases.py`): the configs, the numerics, the
attention block (causal, windowed, padded heads), the decode attention's
flash-combine, the MLP, the vocab-parallel embedding and greedy head,
and the whole forward.

The reference runs under shard_map on conftest's 8 host devices, the
port on the CPU with the ranks stacked. Hidden states agree within
rtol = atol = 1e-5 (fp32: two frameworks sum in different orders, and
XLA's and torch's exp / rsqrt / cos may differ in the last bit); tokens
must be EQUAL.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_lm_cases import (
    B, DP, MESH, S, TOL, batch_np, configs, first_layer_specs, jax_mesh,
    jax_params, params_np, pcfgs, port_params, shard_map, stack,
)
from repro import configs as jax_configs
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import mlp as jmlp
from repro.parallel import stages as jax_stages
from repro_torch import configs as port_configs
from repro_torch import convert
from repro_torch.models import attention, common, lm, mlp
from repro_torch.models.blocks import layer_slice
from repro_torch.models.serve import prefill_cache_specs
from repro_torch.parallel import stages

X3 = (DP, None, None)


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _ctxs(case: str, **kw):
    """(reference ctx, port ctx), FSDP layout."""
    cfg_j, cfg = configs(case)
    jpcfg, pcfg = pcfgs(**kw)
    return (jax_stages.make_ctx(cfg_j, jpcfg, jax_mesh()),
            stages.make_ctx(cfg, pcfg, MESH, device="cpu"))


def _layer0(case: str):
    """(reference layer-0 params, port layer-0 params), FSDP layout."""
    jl = jax.tree.map(lambda a: a[0], jax_params(case)["layers"])
    return jl, layer_slice(port_params(case, serve=False)["layers"], 0)


def _close(got, spec, want):
    np.testing.assert_allclose(convert.from_stacked(got, MESH, spec), want,
                               **TOL)


@pytest.mark.parametrize("arch", sorted(port_configs.ARCH_IDS))
def test_config_matches_reference(arch):
    """get_config and reduced_config equal the reference's, field for
    field, for every assigned architecture (and the id tables)."""
    got, want = port_configs.get_config(arch), jax_configs.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(port_configs.reduced_config(got)) == \
        dataclasses.asdict(jax_configs.reduced_config(want))
    assert got.n_params() == want.n_params()
    assert got.resolved_head_dim == want.resolved_head_dim
    assert port_configs.ARCH_IDS == jax_configs.ARCH_IDS
    assert port_configs.ASSIGNED_ARCHS == jax_configs.ASSIGNED_ARCHS
    assert {k: dataclasses.asdict(v) for k, v in
            port_configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jax_configs.SHAPES.items()}


@pytest.mark.parametrize("fn", ["rms_norm", "rope", "silu", "gelu",
                                "sinusoidal_positions"])
def test_numerics_match(fn):
    """The shared numerics on fp32 inputs (rms_norm with a stacked
    weight, rope at positions past the prompt)."""
    x = _normal((2, 2, 2, B, S, 4, 16), 0)
    if fn == "rms_norm":
        w = _normal((2, 2, 2, 16), 1)
        got = common.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
        want = jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w)[
            :, :, :, None, None, None, :], 1e-6)
    elif fn == "rope":
        pos = np.arange(S) + 5
        got = common.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
        want = jcommon.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    elif fn in ("silu", "gelu"):
        got = getattr(common, fn)(torch.from_numpy(x))
        want = getattr(jcommon, fn)(jnp.asarray(x))
    else:
        got = common.sinusoidal_positions(S, 64, offset=3)
        want = jcommon.sinusoidal_positions(S, 64, offset=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case,window", [("qwen", 0), ("qwen", 8),
                                         ("smollm31", 0), ("smollm63", 0)])
def test_attention_block_matches(case, window):
    """attention_block (fused QKV, qk-norm, rope, GQA, the blocked flash
    forward over 4 x 2 blocks of (4, 8), causal with and without a
    window; padded heads at 3/1 heads; per-rank kv owners at 6/3 heads)
    and the cache it emits equal the reference's."""
    cfg_j, cfg = configs(case)
    jctx, ctx = _ctxs(case)
    kv = P(*prefill_cache_specs(cfg, ctx.pcfg, 2, S)[0][1:])
    jl, tl = _layer0(case)

    def f(lp, x):
        return jattn.attention_block(
            lp["attn"], x, cfg_j, jctx, jattn.AttnConfig(), jnp.arange(S),
            window=window, q_block=4, kv_block=8, return_kv=True)

    x = _normal((B, S, cfg.d_model), 2)
    y_j, (k_j, v_j) = shard_map(f, (first_layer_specs(case), P(*X3)),
                                (P(*X3), (kv, kv)))(jl, jnp.asarray(x))
    y, (k, v) = attention.attention_block(
        tl["attn"], stack(x, X3), cfg, ctx, attention.AttnConfig(),
        torch.arange(S), window=window, q_block=4, kv_block=8,
        return_kv=True)
    _close(y, X3, np.asarray(y_j))
    _close(k, tuple(kv), np.asarray(k_j))
    _close(v, tuple(kv), np.asarray(v_j))


def test_decode_attention_flash_combine_matches():
    """decode_attention over a sequence-sharded cache merges (m, l, acc)
    across the TP group with three engine allreduces (one op="max"),
    unwritten slots masked: equal to the reference's."""
    cfg_j, cfg = configs("smollm31")
    jctx, ctx = _ctxs("smollm31")
    q = _normal((B, 4, 16), 3)
    kc, vc = _normal((B, S, 1, 16), 4), _normal((B, S, 1, 16), 5)
    slots = np.arange(S, dtype=np.int32)
    slots[S // 2 + 3:] = -1                      # not yet written
    cache = (DP, "model", None, None)

    def f(q, k, v, sp):
        return jattn.decode_attention(q, k, v, slot_positions=sp, cur_pos=9,
                                      combine_axis="model",
                                      engine=jctx.engine)

    want = shard_map(f, (P(*X3), P(*cache), P(*cache), P("model")),
                     P(*X3))(q, kc, vc, slots)
    ctx.engine.trace_log.clear()
    got = attention.decode_attention(
        stack(q, X3), stack(kc, cache), stack(vc, cache),
        slot_positions=stack(slots, ("model",)), cur_pos=9,
        combine_axis="model", engine=ctx.engine)
    assert [(e[0], e[2]) for e in ctx.engine.trace_log] == \
        [("allreduce", "model")] * 3
    _close(got, X3, np.asarray(want))


def test_mlp_block_matches():
    cfg_j, cfg = configs("qwen")
    jctx, ctx = _ctxs("qwen")
    jl, tl = _layer0("qwen")
    x = _normal((B, S, cfg.d_model), 6)
    want = shard_map(lambda lp, x: jmlp.mlp_block(lp["mlp"], x, cfg_j, jctx),
                     (first_layer_specs("qwen"), P(*X3)), P(*X3))(jl, x)
    _close(mlp.mlp_block(tl["mlp"], stack(x, X3), cfg, ctx), X3,
           np.asarray(want))


def test_embed_tokens_matches():
    """The vocab-parallel embedding: each rank's rows of its vocab shard,
    then an engine allreduce — BITWISE (one nonzero term per sum)."""
    cfg_j, cfg = configs("qwen")
    jctx, ctx = _ctxs("qwen")
    toks = batch_np("qwen")["tokens"]
    spec = jax_stages.param_specs(cfg_j, 2)["embed"]
    want = shard_map(
        lambda e, t: jlm.embed_tokens({"embed": e}, t, cfg_j, jctx),
        (spec, P(DP, None)), P(*X3))(jax_params("qwen")["embed"], toks)
    got = lm.embed_tokens(port_params("qwen", serve=False), stack(
        toks, (DP, None)), cfg, ctx)
    np.testing.assert_array_equal(convert.from_stacked(got, MESH, X3),
                                  np.asarray(want))


@pytest.mark.parametrize("case,tie", [("qwen", False), ("qwen", True),
                                      ("internvl", False)])
def test_lm_head_sample_matches(case, tie):
    """The greedy head (tied and untied): each rank's max and first
    argmax, the max allreduce, the min id within 1e-6 of the best. The
    tie case puts two equal best rows on one rank (ids 7 and 9) and a
    third on the other rank (id 200): both packages pick 7."""
    cfg_j, cfg = configs(case)
    jctx, ctx = _ctxs(case)
    name = "embed" if cfg.tie_embeddings else "head"
    w = params_np(case)[name].copy()
    x = np.abs(_normal((B, cfg.d_model), 7))
    if tie:
        for i in (7, 9, 200):
            w[i] = 0.5
    spec = jax_stages.param_specs(cfg_j, 2)[name]
    want = np.asarray(shard_map(
        lambda w, x: jlm.lm_head_sample({name: w}, x, cfg_j, jctx),
        (spec, P(DP, None)), P(DP))(w, x))
    pw = convert.to_stacked(w, MESH, stages.param_specs(cfg, 2)[name])
    got = lm.lm_head_sample({name: pw}, stack(x, (DP, None)), cfg, ctx)
    assert got.dtype == torch.int32
    got = convert.from_stacked(got, MESH, (DP,))
    np.testing.assert_array_equal(got, want)
    if tie:
        assert (got == 7).all()


@pytest.mark.parametrize("case,sp", [("qwen", False), ("internvl", False),
                                     ("qwen", True)])
def test_forward_matches(case, sp):
    """lm.forward (FSDP layout: the engine's ZeRO-3 gathers; the VLM with
    its visual prefix; sequence parallel with the streaming collective
    matmul) — final hidden states equal the reference's, and so do the
    greedy tokens at every position."""
    cfg_j, cfg = configs(case)
    kw = dict(sequence_parallel=sp, collective_matmul=sp)
    jctx, ctx = _ctxs(case, **kw)
    batch = batch_np(case)
    bspec = jlm.batch_specs(cfg_j, "prefill")
    specs = jax_stages.param_specs(cfg_j, 2)

    def f(p, b):
        x, _ = jlm.forward(p, b, cfg_j, jctx)
        toks = jnp.stack([jlm.lm_head_sample(p, x[:, i], cfg_j, jctx)
                          for i in range(S)], axis=1)
        return x, toks

    x_j, t_j = shard_map(f, (specs, bspec), (P(*X3), P(DP, None)))(
        jax_params(case), batch)
    params = port_params(case, serve=False)
    x, _ = lm.forward(params, {k: stack(v, lm.batch_specs(cfg, "prefill")[k])
                               for k, v in batch.items()}, cfg, ctx)
    _close(x, X3, np.asarray(x_j))
    toks = torch.stack([lm.lm_head_sample(params, x[..., i, :], cfg, ctx)
                        for i in range(S)], dim=-1)
    np.testing.assert_array_equal(
        convert.from_stacked(toks, MESH, (DP, None)), np.asarray(t_j))
