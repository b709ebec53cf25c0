"""The port's train step for the SSM, hybrid and audio families and
with int8 / bf16 gradient compression against the JAX package's
`build_train_step` (`_torch_train_cases.py`), every remat mode against
remat='none', and every assigned arch as a port-only smoke (as
`tests/test_archs_smoke.py`). Tolerances are stated per test.
"""
import math

import numpy as np
import pytest
import torch

import _torch_lm_cases as C
import _torch_train_cases as T
from _torch_train_cases import one_torch_thread  # noqa: F401
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.configs import ParallelConfig
from repro_torch.optim import adamw
from repro_torch import tree
from repro_torch.parallel import stages

N_SYNC = 8      # ranks of the largest sync group on the (2, 2, 2) mesh


@pytest.mark.parametrize("case", ["mamba", "hymba", "whisper"])
def test_train_step_matches_reference(case):
    """SSM, hybrid and audio (encoder stack, cross-attention): loss,
    metrics, updated params and AdamW state of one step equal the
    reference's (`_torch_train_cases` tolerances)."""
    T.check_step(case)


@pytest.mark.parametrize("codec,rtol", [
    # int8: each of the <= n - 1 compressed hops errs by <= 1/254 of the
    # block's absmax (phase 4's rule), and a one-quantum flip between the
    # two frameworks' near-equal grads moves m by that much
    ("int8", (N_SYNC - 1) / 254),
    # bf16: one rounding of 2^-8 per hop
    ("bf16", (N_SYNC - 1) * 2.0 ** -8)])
def test_train_step_grad_compression(codec, rtol):
    """grad_compression int8 / bf16: the gradient buckets through the
    engine's codec; the moments within the codec's bound of the
    reference's (of the leaf's largest entry), the rest as the plain
    step's."""
    T.check_step("qwen", moment_rtol=rtol, grad_compression=codec)


def _grads_after_step(case: str, remat: str):
    """The port's first AdamW moment (0.1 x the clipped synced grads) after
    one step under `remat`, from the same state."""
    _, cfg = C.configs(case)
    _, pcfg = C.case_pcfgs(case, remat=remat)
    ts = stages.build_train_step(cfg, pcfg, C.MESH,
                                 adamw.AdamWConfig(lr=T.LR), device="cpu")
    p_np, s_np = T.initial_state_np(case)
    from repro_torch import convert
    params = convert.lm_params_from_jax(p_np, cfg, C.MESH)
    state = convert.opt_state_from_jax(s_np, cfg, C.MESH)
    ts.fn(params, state, ts.put_batch(T.batch_np(case)), 0)
    return [l["m"] for l in tree.leaves(
        state["leaves"], lambda x: isinstance(x, dict) and "m" in x)]


@pytest.mark.parametrize("case", ["qwen", "hymba"])
@pytest.mark.parametrize("remat", ["full", "dots", "names"])
def test_remat_changes_no_value(case, remat):
    """remat full / dots / names recompute in the backward what they do
    not save; the gradients equal remat='none''s bitwise."""
    base = _grads_after_step(case, "none")
    got = _grads_after_step(case, remat)
    for a, b in zip(base, got):
        assert torch.equal(a, b)


def _batch(cfg, rng, B=4, S=32):
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        b["vis_embed"] = rng.normal(
            size=(B, cfg.n_vis_tokens, cfg.d_model)).astype(np.float32)
    if cfg.encoder_layers:
        b["frames"] = (0.1 * rng.normal(size=(B, S, cfg.d_model))
                       ).astype(np.float32)
    return b


@pytest.mark.parametrize("arch_id", sorted(ARCH_IDS))
def test_arch_train_step_smoke(arch_id):
    """Every assigned arch at a reduced config takes one train step on
    the port's (2, 2, 2) mesh: init CE within 1 of log V, a finite
    positive grad norm, params keeping their shapes, finite, and moved."""
    cfg = reduced_config(get_config(arch_id))
    ts = stages.build_train_step(cfg, ParallelConfig(remat="none"), C.MESH,
                                 adamw.AdamWConfig(lr=1e-3), device="cpu")
    params = stages.init_params(cfg, C.MESH, ts.ctx.tp, seed=0,
                                device="cpu")
    before = [p.clone() for p in tree.leaves(params)]
    opt = adamw.adamw_init(params)
    batch = ts.put_batch(_batch(cfg, np.random.default_rng(0)))
    _p, _o, m = ts.fn(params, opt, batch, 0)
    ce = float(m["ce_mean"])
    assert math.isfinite(ce) and abs(ce - math.log(cfg.vocab_size)) < 1.0
    gn = float(m["grad_norm"])
    assert math.isfinite(gn) and gn > 0
    after = tree.leaves(params)
    for a, b in zip(before, after):
        assert a.shape == b.shape and bool(torch.isfinite(b).all())
    assert any(not torch.equal(a, b) for a, b in zip(before, after))
