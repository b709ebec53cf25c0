"""Shared cases of the port's training tests (`test_torch_train.py`,
`test_torch_train_families.py`): one train step of a reduced config on
the (2, 2, 2) mesh through the JAX package's `build_train_step` and the
port's, from the same state.

The reference's params (`init_params`) and AdamW state carry across by
`convert.lm_params_from_jax` / `opt_state_from_jax`; the batch comes from
a numpy seed. Each side's step is run once per case and its results
cached (`lru_cache`), as numpy.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_cases import MESH, case_pcfgs, configs, jax_mesh, \
    jax_params
from repro.optim import adamw as jax_adamw
from repro.parallel import stages as jax_stages
from repro_torch import convert
from repro_torch.optim import adamw
from repro_torch.parallel import stages

LR = 1e-3
S = 16


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The training tests' tensors are small: one intra-op thread runs
    them faster than many, and leaves the suite's other workers their
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


METRICS = ("ce_mean", "aux", "grad_norm", "loss")
# fp32 on both sides, two frameworks' summation orders: the metrics and
# the AdamW moments agree to ~1e-6 relative; an updated param or master to
# ~3e-5 absolute (the first Adam step moves each by lr * g / (|g| + eps),
# sensitive where |g| is tiny)
METRIC_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_ATOL = 2e-4
MOMENT_RTOL = 2e-5     # of the leaf's largest entry


def batch_np(case: str, B: int = 4) -> dict:
    cfg = configs(case)[1]
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        out["vis_embed"] = rng.standard_normal(
            (B, cfg.n_vis_tokens, cfg.d_model)).astype(np.float32)
    if cfg.encoder_layers:
        out["frames"] = 0.1 * rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    return out


def _key(kw: dict) -> tuple:
    return tuple(sorted(kw.items()))


@functools.lru_cache(maxsize=None)
def jax_step(case: str, B: int = 4, kw: tuple = ()):
    """(metrics, new params, new AdamW state) of the reference's step,
    as numpy."""
    jcfg, _ = configs(case)
    jpcfg, _ = case_pcfgs(case, **dict(kw))
    ts = jax_stages.build_train_step(jcfg, jpcfg, jax_mesh(),
                                     jax_adamw.AdamWConfig(lr=LR))
    params = jax.tree.map(jnp.copy, jax_params(case))
    state = jax_adamw.adamw_init(params)
    batch = {k: jnp.asarray(v) for k, v in batch_np(case, B).items()}
    new_p, new_s, m = ts.fn(params, state, batch, jnp.int32(0))
    return ({k: float(v) for k, v in m.items()},
            jax.tree.map(np.asarray, new_p), jax.tree.map(np.asarray, new_s))


def initial_state_np(case: str):
    params = jax_params(case)
    return (jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, jax_adamw.adamw_init(params)))


def port_step(case: str, B: int = 4, kw: tuple = ()):
    """(metrics, new params, new AdamW state) of the port's step from the
    reference's initial state, converted back to the reference's trees
    (numpy)."""
    _, cfg = configs(case)
    _, pcfg = case_pcfgs(case, **dict(kw))
    ts = stages.build_train_step(cfg, pcfg, MESH, adamw.AdamWConfig(lr=LR),
                                 device="cpu")
    p_np, s_np = initial_state_np(case)
    params = convert.lm_params_from_jax(p_np, cfg, MESH)
    state = convert.opt_state_from_jax(s_np, cfg, MESH)
    _p, _s, m = ts.fn(params, state, ts.put_batch(batch_np(case, B)), 0)
    return ({k: float(v) for k, v in m.items()},
            convert.lm_params_to_jax(params, cfg, MESH),
            convert.opt_state_to_jax(state, cfg, MESH))


def check_step(case: str, B: int = 4, moment_rtol: float = MOMENT_RTOL,
               **kw) -> None:
    """The port's step equals the reference's: metrics within
    METRIC_TOL, every updated param and master within PARAM_ATOL, every
    m and v within `moment_rtol` of the leaf's largest entry, the count
    exactly."""
    jm, jp, js = jax_step(case, B, _key(kw))
    pm, pp, ps = port_step(case, B, _key(kw))
    for k in METRICS:
        np.testing.assert_allclose(pm[k], jm[k], err_msg=k, **METRIC_TOL)
    for (path, a), b in zip(jax.tree.flatten_with_path(jp)[0],
                            jax.tree.leaves(pp)):
        np.testing.assert_allclose(b, a, atol=PARAM_ATOL, rtol=0,
                                   err_msg=str(path))
    for (path, a), b in zip(jax.tree.flatten_with_path(js)[0],
                            jax.tree.leaves(ps)):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        name = str(path[-1])
        if "count" in str(path[0]):
            assert int(a) == int(b) == 1
        elif "master" in name:
            np.testing.assert_allclose(b, a, atol=PARAM_ATOL, rtol=0,
                                       err_msg=str(path))
        else:
            np.testing.assert_allclose(
                b, a, rtol=0, atol=moment_rtol * np.abs(a).max() + 1e-30,
                err_msg=str(path))
