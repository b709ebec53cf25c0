"""The port's LM training against the JAX package's: the flash backward
(the reference's custom VJP), the vocab-parallel loss, AdamW and the
schedules, and one train step of the dense, VLM and MoE families on the
(2, 2, 2) mesh, with sequence parallelism + the collective matmul and
with microbatches (`_torch_train_cases.py`; the SSM, hybrid and audio
families, the codecs, remat and every arch are in
`test_torch_train_families.py`). Inputs from numpy seeds; tolerances are
stated per test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_lm_cases as C
import _torch_train_cases as T
from _torch_train_cases import one_torch_thread  # noqa: F401
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import attention as jax_attention
from repro.models import lm as jax_lm
from repro.optim import adamw as jax_adamw
from repro.optim import schedules as jax_schedules
from repro.parallel import stages as jax_stages
from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import attention
from repro_torch.models import lm as lm_mod
from repro_torch.optim import adamw, schedules
from repro_torch import tree
from repro_torch.parallel import stages


# --------------------------------------------------------------------------
# Flash attention backward
# --------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0), (False, 24)])
def test_flash_grad_matches_reference_vjp(causal, window):
    """The port's flash forward and the dq, dk, dv of its `_Flash` equal
    the reference's flash and custom VJP (GQA 6 / 2 heads, several q and
    kv blocks; atol 1e-5, tighter than the reference's own 5e-4
    flash-vs-chunked check)."""
    B, S, H, KV, hd = 2, 64, 6, 2, 16
    rng = np.random.default_rng(0)
    qn, kn, vn = (rng.normal(size=s).astype(np.float32) for s in (
        (B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    cot = rng.normal(size=(B, S, H, hd)).astype(np.float32)

    def jl(q, k, v):
        return (jax_attention.flash_attention(
            q, k, v, causal=causal, window=window, q_block=16,
            kv_block=32) * cot).sum()

    jg = jax.grad(jl, argnums=(0, 1, 2))(jnp.asarray(qn), jnp.asarray(kn),
                                         jnp.asarray(vn))
    jout = jax_attention.flash_attention(
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), causal=causal,
        window=window, q_block=16, kv_block=32)
    q, k, v = (torch.tensor(a, requires_grad=True) for a in (qn, kn, vn))
    out = attention.flash_attention(q, k, v, causal=causal, window=window,
                                    q_block=16, kv_block=32)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5)
    pg = torch.autograd.grad((out * torch.tensor(cot)).sum(), (q, k, v))
    for a, b in zip(jg, pg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)


def test_flash_backward_keeps_o_s_residuals():
    """Under grad the flash path saves only (q, k, v, out, lse): no tensor
    of the (q block x kv block) score tiles is kept for the backward."""
    B, S, H, hd = 1, 64, 2, 8
    q, k, v = (torch.randn(B, S, H, hd, requires_grad=True)
               for _ in range(3))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        attention.flash_attention(q, k, v, causal=True, q_block=16,
                                  kv_block=16).sum()
    assert saved and all(16 * 16 not in (s[-1] * s[-2] if len(s) > 1
                                         else 0,) for s in saved)
    assert max(int(np.prod(s)) for s in saved) <= B * S * H * hd


# --------------------------------------------------------------------------
# The loss
# --------------------------------------------------------------------------

def _vocab_cfgs(vocab: int):
    over = {"vocab_size": vocab}
    return (jax_reduced_config(jax_get_config("qwen3-0.6b"), **over),
            reduced_config(get_config("qwen3-0.6b"), **over))


@pytest.mark.parametrize("vocab", [256, 255])
def test_loss_fn_matches_reference(vocab):
    """Each rank's loss and the metrics of `loss_fn` (the vocab-parallel
    CE, its padded vocab rows masked at V = 255 on tp 2, the 1/(T tp)
    scale, ce_mean reduced over the dp axes) equal the reference's inside
    shard_map, per rank (fp32, 1e-5)."""
    jcfg, cfg = _vocab_cfgs(vocab)
    jpcfg, pcfg = C.pcfgs()
    params = jax_stages.init_params(jcfg, C.jax_mesh(), 2, seed=0)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, vocab, (4, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    ctx_j = jax_stages.make_ctx(jcfg, jpcfg, C.jax_mesh())
    all_axes = ("pod", "data", "model")

    def per_rank(p, b):
        loss, m = jax_lm.loss_fn(p, b, jcfg, ctx_j)
        return loss[None], m["ce_mean"][None]

    fn = C.shard_map(per_rank, (jax_stages.param_specs(jcfg, 2),
                                jax_lm.batch_specs(jcfg, "train",
                                                   dp=C.DP)),
                     (P(all_axes), P(all_axes)))
    jl, jce = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    ctx = stages.make_ctx(cfg, pcfg, C.MESH, "cpu")
    pp = convert.lm_params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                    C.MESH)
    spec = lm_mod.batch_specs(cfg, "train", dp=C.DP)
    loss, m = lm_mod.loss_fn(pp, {k: C.stack(v, spec[k])
                                  for k, v in batch.items()}, cfg, ctx)
    np.testing.assert_allclose(loss.detach().reshape(-1).numpy(),
                               np.asarray(jl), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m["ce_mean"].reshape(-1).numpy(),
                               np.asarray(jce), rtol=1e-5)


def test_lm_head_ce_gradient_through_the_engine():
    """The CE's allreduces take their adjoints through the engine (the max
    is detached): d(sum of ranks' ce) / dx is finite, and the logits'
    padded rows get no gradient."""
    _, cfg = _vocab_cfgs(255)
    _, pcfg = C.pcfgs()
    ctx = stages.make_ctx(cfg, pcfg, C.MESH, "cpu")
    params = stages.init_params(cfg, C.MESH, 2, seed=0, device="cpu")
    emb = params["embed"].detach().requires_grad_()
    x = torch.randn((2, 2, 2, 4, 16, cfg.d_model), requires_grad=True)
    labels = torch.randint(0, 255, (2, 2, 2, 4, 16))
    ce, count = lm_mod.lm_head_ce({"embed": emb}, x, labels, cfg, ctx)
    assert ce.shape == (2, 2, 2) and int(count[0, 0, 0]) == 64
    gx, ge = torch.autograd.grad(ce.sum(), (x, emb))
    assert torch.isfinite(gx).all() and torch.isfinite(ge).all()
    # the model-axis rank 1's last local vocab row is global row 255 (pad)
    assert float(ge[:, :, 1, -1].abs().max()) == 0.0


# --------------------------------------------------------------------------
# AdamW and the schedules
# --------------------------------------------------------------------------

def test_adamw_matches_reference():
    """adamw_init / adamw_update (with its global clip) / apply_updates
    equal the reference's on a random tree over two steps (fp32, 1e-6),
    the master a copy, not an alias."""
    rng = np.random.default_rng(2)
    shapes = {"a": (5, 3), "b": {"c": (7,), "d": (2, 2, 4)}}

    def make(fn):
        return {"a": fn(shapes["a"]), "b": {k: fn(s) for k, s in
                                            shapes["b"].items()}}
    p_np = make(lambda s: rng.normal(size=s).astype(np.float32))
    g_np = [make(lambda s: 3 * rng.normal(size=s).astype(np.float32))
            for _ in range(2)]
    cfg_j = jax_adamw.AdamWConfig(lr=1e-2, grad_clip=1.0)
    cfg = adamw.AdamWConfig(lr=1e-2, grad_clip=1.0)
    js = jax_adamw.adamw_init(jax.tree.map(jnp.asarray, p_np))
    params = tree.tree_map(torch.tensor, p_np)
    ps = adamw.adamw_init(params)
    assert ps["leaves"]["a"]["master"].data_ptr() != \
        params["a"].data_ptr()
    for i, g in enumerate(g_np):
        js, jm = jax_adamw.adamw_update(cfg_j, jax.tree.map(jnp.asarray, g),
                                        js, lr_scale=0.5)
        ps, pm = adamw.adamw_update(cfg, tree.tree_map(torch.tensor, g),
                                    ps, lr_scale=0.5, inplace=bool(i))
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(js), tree.leaves(ps)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)
    jp = jax_adamw.apply_updates(js, jnp.bfloat16)
    pp = adamw.apply_updates(ps, torch.bfloat16)
    for a, b in zip(jax.tree.leaves(jp), tree.leaves(pp)):
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a, np.float32))


@pytest.mark.parametrize("step", [0, 5, 19, 20, 21, 60, 99, 150])
def test_schedules_match_reference(step):
    """cosine_warmup and linear_warmup at an int step and a 0-d tensor
    step equal the reference's (fp32, 1e-6)."""
    for s in (step, torch.tensor(step, dtype=torch.int32)):
        np.testing.assert_allclose(
            float(schedules.cosine_warmup(s, 20, 100)),
            float(jax_schedules.cosine_warmup(jnp.int32(step), 20, 100)),
            rtol=1e-6)
        np.testing.assert_allclose(
            float(schedules.linear_warmup(s, 20)),
            float(jax_schedules.linear_warmup(jnp.int32(step), 20)),
            rtol=1e-6)


# --------------------------------------------------------------------------
# One train step against the reference's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["qwen", "internvl", "mixtral"])
def test_train_step_matches_reference(case):
    """Dense, VLM and MoE: loss, metrics, updated params and AdamW state
    of one step equal `build_train_step`'s (`_torch_train_cases`
    tolerances)."""
    T.check_step(case)


def test_train_step_sp_collective_matmul():
    """sequence_parallel + collective_matmul: the engine's
    `allgather_matmul` and its adjoint in the backward."""
    T.check_step("qwen", sequence_parallel=True, collective_matmul=True)


def test_train_step_microbatches():
    """microbatches=2: per-microbatch backward, fp32 accumulation, grads,
    loss and metrics averaged (global batch 8, 2 rows per dp rank)."""
    T.check_step("qwen", B=8, microbatches=2)
