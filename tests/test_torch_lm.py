"""The port's LM modules against the JAX package, at reduced size on the
(2, 2, 2) mesh (`_torch_lm_cases.py`): the configs, the numerics, the
attention block (causal, windowed, padded heads, cross), the decode
attention's flash-combine, the MLP, the MoE (top-k tie order, capacity
dispatch, the block at the training capacity and dropless), the Mamba2
mixer's pieces (causal conv, chunked SSD, the mixer in prefill and
decode), the encoder stack, the vocab-parallel embedding and greedy
head, and the whole forward of every family.

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
    B, DP, MESH, S, S_ENC, TOL, batch_np, case_pcfgs, configs,
    first_layer_specs, jax_mesh, jax_params, owner_gathered, params_np,
    port_params, seq_len, shard_map, stack,
)
from repro import configs as jax_configs
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import mlp as jmlp
from repro.models import ssm as jssm
from repro.parallel import stages as jax_stages
from repro_torch import configs as port_configs
from repro_torch import convert
from repro_torch.models import attention, common, lm, mlp, ssm
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
    jpcfg, pcfg = case_pcfgs(case, **kw)
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
    and the cache it emits equal the reference's — a replicated-KV cache
    once gathered through each rank's owners, as the reference emits it
    (the port's holds the kv heads decode reads, ROADMAP Queue 3)."""
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
    for got, want in ((k, k_j), (v, v_j)):
        got = convert.from_stacked(got, MESH, tuple(kv))
        if not attention.kv_layout(cfg, 2)[1]:
            assert got.shape[-2] == cfg.n_kv_heads
            got = owner_gathered(got, case)
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


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


@pytest.mark.parametrize("case,sp", [
    ("qwen", False), ("internvl", False), ("qwen", True),
    ("mixtral", False), ("mixtral_pe", True), ("mamba_2chunks", False),
    ("hymba_pad", False), ("whisper", False), ("whisper", True)])
def test_forward_matches(case, sp):
    """lm.forward (FSDP layout: the engine's ZeRO-3 gathers; the VLM with
    its visual prefix; sequence parallel with the streaming collective
    matmul; the MoE's all-to-all dispatch, pseudo-experts under SP; two
    SSD chunks; the hybrid's padded SSM heads; the audio encoder stack
    and cross-attention) — final hidden states equal the reference's,
    and so do the greedy tokens at every position."""
    cfg_j, cfg = configs(case)
    kw = dict(sequence_parallel=sp, collective_matmul=sp)
    jctx, ctx = _ctxs(case, **kw)
    batch = batch_np(case)
    bspec = jlm.batch_specs(cfg_j, "prefill")
    specs = jax_stages.param_specs(cfg_j, 2)

    s = seq_len(case)

    def f(p, b):
        x, _ = jlm.forward(p, b, cfg_j, jctx)
        toks = jnp.stack([jlm.lm_head_sample(p, x[:, i], cfg_j, jctx)
                          for i in range(s)], axis=1)
        return x, toks

    x_j, t_j = shard_map(f, (specs, bspec), (P(*X3), P(DP, None)))(
        jax_params(case), batch)
    params = port_params(case, serve=False)
    x, _ = lm.forward(params, {k: stack(v, lm.batch_specs(cfg, "prefill")[k])
                               for k, v in batch.items()}, cfg, ctx)
    _close(x, X3, np.asarray(x_j))
    toks = torch.stack([lm.lm_head_sample(params, x[..., i, :], cfg, ctx)
                        for i in range(s)], dim=-1)
    np.testing.assert_array_equal(
        convert.from_stacked(toks, MESH, (DP, None)), np.asarray(t_j))


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed,ties", [(0, False), (1, True)])
def test_top_k_tie_order_matches(seed, ties):
    """top_k keeps jax.lax.top_k's order: largest first, the lower index
    first among equal values (rows of many exact ties included; no
    signed zeros, which jax orders -0 < +0: router probabilities are
    never -0)."""
    x = np.random.default_rng(seed).standard_normal((64, 16)).astype(
        np.float32)
    if ties:
        x = np.abs(np.round(x * 2) / 2)  # a few distinct values per row
    vals, idx = jax.lax.top_k(jnp.asarray(x), 5)
    got_v, got_i = mlp.top_k(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(vals))


@pytest.mark.parametrize("n_experts,capacity,lead", [
    (4, 3, ()), (4, 100, ()), (8, 1, (2, 2)), (1, 5, (3,))])
def test_dispatch_indices_matches(n_experts, capacity, lead):
    """The sort-based capacity dispatch, batched over leading dims: the
    slots (and -1 for every dropped assignment) EQUAL the reference's
    per row, with many equal expert ids per row (ties in the sort)."""
    ids = np.random.default_rng(capacity).integers(
        0, n_experts, lead + (40,)).astype(np.int32)
    got = mlp._dispatch_indices(torch.from_numpy(ids).long(), n_experts,
                                capacity).numpy()
    for row, g in zip(ids.reshape(-1, 40), got.reshape(-1, 40)):
        want = np.asarray(jmlp._dispatch_indices(jnp.asarray(row),
                                                 n_experts, capacity))
        np.testing.assert_array_equal(g, want)
    assert (got < 0).any() == (capacity < 40 // n_experts)


@pytest.mark.parametrize("case", ["mixtral", "mixtral_pe", "qwen3moe"])
@pytest.mark.parametrize("dropless", [False, True])
def test_moe_block_matches(case, dropless):
    """moe_block at the training capacity (factor 1.25: assignments drop)
    and with the serving capacity (`dropless`): the routed output and the
    router probabilities equal the reference's — the token-sharded
    dispatch, both engine all-to-alls and the re-gather; pseudo-experts
    (one expert split over 2 ranks) in mixtral_pe."""
    cfg_j, cfg = configs(case)
    jctx, ctx = _ctxs(case)
    jl, tl = _layer0(case)
    x = _normal((B, S, cfg.d_model), 8)
    t_l = B // 4 * S // 2            # tokens each rank routes
    probs = (DP, "model", None)      # (t_l, E) per rank: spec on (B, S)

    def f(lp, x):
        y, p = jmlp.moe_block(lp["moe"], x, cfg_j, jctx, 1.25,
                              dropless=dropless)
        return y, p.reshape(B // 4, S // 2, -1)

    y_j, p_j = shard_map(f, (first_layer_specs(case), P(*X3)),
                         (P(*X3), P(*probs)))(jl, jnp.asarray(x))
    ctx.engine.trace_log.clear()
    y, p = mlp.moe_block(tl["moe"], stack(x, X3), cfg, ctx, 1.25,
                         dropless=dropless)
    log = [e[0] for e in ctx.engine.trace_log]      # FSDP gathers first
    assert log.count("alltoall") == 2 and log[-1] == "allgather"
    assert p.shape[-2] == t_l
    # the reference's expert init scales w2 by 1/sqrt(n_experts), so the
    # outputs reach ~50 where fp32 reassociation alone passes an absolute
    # 1e-5: compare relative to the largest output
    top = float(np.abs(np.asarray(y_j)).max())
    np.testing.assert_allclose(convert.from_stacked(y, MESH, X3) / top,
                               np.asarray(y_j) / top, **TOL)
    _close(p.reshape(p.shape[:3] + (B // 4, S // 2, -1)), probs,
           np.asarray(p_j))


# --------------------------------------------------------------------------
# Mamba2 / SSD
# --------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches(with_state):
    """The depthwise causal conv, zero-padded (prefill) and with a carried
    window (decode), and the window it hands on."""
    x, w = _normal((B, 6, 12), 9), _normal((4, 12), 10)
    st = _normal((B, 3, 12), 11) if with_state else None
    y_j, s_j = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                 None if st is None else jnp.asarray(st))
    y, s = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                            None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))


@pytest.mark.parametrize("chunk", [4, 16])
def test_ssd_chunked_matches(chunk):
    """The chunked SSD scan over 16 positions in 4 chunks (the
    inter-chunk recurrence) and in one: the outputs and the final state
    equal the reference's."""
    rng = np.random.default_rng(12)
    xh = rng.standard_normal((B, S, 3, 8)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (B, S, 3)).astype(np.float32)
    a_neg = -rng.uniform(1.0, 16.0, (3,)).astype(np.float32)
    b_in = rng.standard_normal((B, S, 5)).astype(np.float32)
    c_in = rng.standard_normal((B, S, 5)).astype(np.float32)
    y_j, h_j = jssm._ssd_chunked(*map(jnp.asarray, (xh, dt, a_neg, b_in,
                                                     c_in)), chunk)
    y, h = ssm._ssd_chunked(*map(torch.from_numpy, (xh, dt, a_neg, b_in,
                                                    c_in)), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), **TOL)


@pytest.mark.parametrize("case", ["mamba", "hymba_pad"])
@pytest.mark.parametrize("decode", [False, True])
def test_ssm_mixer_matches(case, decode):
    """ssm_mixer over a prompt (prefill: its conv window and final state)
    and one decode step from a carried state: outputs and carries equal
    the reference's; hymba_pad's padded sixth head masked before the
    cross-TP gated norm (an engine allreduce)."""
    cfg_j, cfg = configs(case)
    jctx, ctx = _ctxs(case)
    jl, tl = _layer0(case)
    cspec = jax_stages.cache_specs(cfg_j, jctx.pcfg, 2, S)[0]
    s = 1 if decode else S
    x = _normal((B, s, cfg.d_model), 13)
    carries = ()
    if decode:
        glob = jax.tree.map(lambda sd: _normal(sd.shape, 14).astype(
            sd.dtype), jax.eval_shape(lambda: jax_stages.cache_shapes(
                cfg_j, jctx.pcfg, jax_mesh(), 2, B, S)[0]))
        carries = (glob["conv"], glob["state"])
    specs = (first_layer_specs(case), P(*X3)) + tuple(
        cspec[k] for k in ("conv", "state"))[:len(carries)]

    def f(lp, x, *c):
        y, (conv, st) = jssm.ssm_mixer(lp["ssm"], x, cfg_j, jctx, *c,
                                       decode=decode)
        return y, conv, st

    y_j, conv_j, st_j = shard_map(f, specs, (P(*X3), cspec["conv"],
                                             cspec["state"]))(
        jl, jnp.asarray(x), *carries)
    y, (conv, st) = ssm.ssm_mixer(
        tl["ssm"], stack(x, X3), cfg, ctx,
        *(stack(c, tuple(cspec[k])) for c, k in zip(carries,
                                                    ("conv", "state"))),
        decode=decode)
    _close(y, X3, np.asarray(y_j))
    _close(conv, tuple(cspec["conv"]), np.asarray(conv_j))
    _close(st, tuple(cspec["state"]), np.asarray(st_j))


# --------------------------------------------------------------------------
# The audio family: cross-attention and the encoder stack
# --------------------------------------------------------------------------

def test_cross_attention_matches():
    """attention_block with kv_source (non-causal, no rope, K/V from 12
    encoder positions in blocks of 4) and the cross cache it emits."""
    cfg_j, cfg = configs("whisper")
    jctx, ctx = _ctxs("whisper")
    jl, tl = _layer0("whisper")
    xkv = P(*prefill_cache_specs(cfg, ctx.pcfg, 2, S)[2][1:])
    x = _normal((B, S, cfg.d_model), 15)
    enc = _normal((B, S_ENC["whisper"], cfg.d_model), 16)

    def f(lp, x, e):
        return jattn.attention_block(
            lp["xattn"], x, cfg_j, jctx,
            jattn.AttnConfig(causal=False, cross=True), jnp.arange(S),
            kv_source=e, q_block=4, kv_block=4, return_kv=True)

    y_j, (k_j, v_j) = shard_map(
        f, (first_layer_specs("whisper"), P(*X3), P(*X3)),
        (P(*X3), (xkv, xkv)))(jl, jnp.asarray(x), jnp.asarray(enc))
    y, (k, v) = attention.attention_block(
        tl["xattn"], stack(x, X3), cfg, ctx,
        attention.AttnConfig(causal=False, cross=True), torch.arange(S),
        kv_source=stack(enc, X3), q_block=4, kv_block=4, return_kv=True)
    _close(y, X3, np.asarray(y_j))
    _close(k, tuple(xkv), np.asarray(k_j))
    _close(v, tuple(xkv), np.asarray(v_j))


@pytest.mark.parametrize("sp", [False, True])
def test_encoder_stack_matches(sp):
    """_input_stream of the audio family: the sinusoidal positions, the
    non-causal encoder stack (sequence-sharded and re-gathered under SP)
    and its final norm give the reference's encoder output."""
    cfg_j, cfg = configs("whisper")
    kw = dict(sequence_parallel=sp)
    jctx, ctx = _ctxs("whisper", **kw)
    batch = batch_np("whisper")
    bspec = jlm.batch_specs(cfg_j, "prefill")
    specs = jax_stages.param_specs(cfg_j, 2)
    want = shard_map(lambda p, b: jlm._input_stream(p, b, cfg_j, jctx)[1],
                     (specs, bspec), P(*X3))(jax_params("whisper"), batch)
    _, enc = lm._input_stream(
        port_params("whisper", serve=False),
        {k: stack(v, lm.batch_specs(cfg, "prefill")[k])
         for k, v in batch.items()}, cfg, ctx)
    _close(enc, X3, np.asarray(want))
