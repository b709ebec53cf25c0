"""The port's LM serving path against the JAX package: teacher-forced
decode, prefill, the serve session and the int8 KV cache, at reduced
size on the (2, 2, 2) mesh (`_torch_lm_cases.py`).

The reference runs under shard_map on conftest's 8 host devices, the
port on the CPU with the 8 ranks stacked (K1's plain version in every
engine allreduce). Tokens must be EQUAL; caches agree within rtol =
atol = 1e-5 (fp32, two frameworks' summation orders), except where a
test says bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_cases import (
    B, DP, MESH, S, TOL, configs, jax_decode, jax_mesh,
    jax_params, jax_prefill, params_np, pcfgs, port_decode, port_params,
    port_prefill, stack, tokens,
)
from repro.runtime.serve_session import ServeSession as JaxServeSession
from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import serve as serve_launch
from repro_torch.models import blocks, lm, serve
from repro_torch.models.common import Builder
from repro_torch.parallel import stages
from repro_torch.runtime import ServeSession


def _port_forward_argmax(case: str):
    """The port's own forward (FSDP layout, the reference's training
    params) and greedy head at every position: (B, S)."""
    cfg = configs(case)[1]
    _, pcfg = pcfgs()
    ctx = stages.make_ctx(cfg, pcfg, MESH, device="cpu")
    params = port_params(case, serve=False)
    x, _ = lm.forward(params, {"tokens": stack(tokens(case), (DP, None))},
                      cfg, ctx)
    preds = [lm.lm_head_sample(params, x[..., i, :], cfg, ctx)
             for i in range(S)]
    return np.stack([convert.from_stacked(p, MESH, (DP,)) for p in preds], 1)


@pytest.mark.parametrize("case", ["qwen", "smollm31", "smollm63",
                                  "qwen_sw8", "internvl"])
def test_decode_matches_jax_and_forward(case):
    """16 teacher-forced decode tokens equal the reference's decode and
    the port's own forward at every position (agreement 1.0, the
    reference's test_decode_matches_forward), and the final caches
    equal the reference's."""
    want, jcache = jax_decode(case)
    got, cache = port_decode(case)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _port_forward_argmax(case))
    _, pcfg = pcfgs()
    got_cache = convert.decode_caches_to_jax(cache, configs(case)[1], pcfg,
                                             MESH, B, S)
    for layer, (g, w) in enumerate(zip(got_cache, jcache)):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], err_msg=f"{layer} {k}",
                                       **TOL)


@pytest.mark.parametrize("case", ["qwen", "smollm31", "internvl"])
def test_prefill_matches_jax(case):
    """prefill's next token and its layer-stacked caches (the VLM's with
    the visual prefix; the replicated-KV case's sequence-sharded and
    owner-gathered) equal the reference's."""
    want_tok, want_caches = jax_prefill(case)
    got_tok, got_caches, _log = port_prefill(case)
    np.testing.assert_array_equal(got_tok, want_tok)
    for g, w in zip(got_caches, want_caches):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)


def test_prefill_sequence_parallel_matches():
    """Under sequence_parallel + collective_matmul the port's prefill
    runs the streaming allgather-matmul (K4's plain version here) and
    gives the reference's non-SP prefill: the reference's own SP prefill
    does not cut the stream to each rank's slice and fails to broadcast
    (ROADMAP Queue 3), so the comparison is with its SP-free result."""
    want_tok, want_caches = jax_prefill("qwen")
    got_tok, got_caches, log = port_prefill("qwen", sequence_parallel=True,
                                            collective_matmul=True)
    # two streaming projections (QKV, gate/up) and two sequence
    # reduce-scatters (after attention and the MLP) per layer
    n_layers = configs("qwen")[1].n_layers
    assert [e[0] for e in log].count("allgather_matmul") == 2 * n_layers
    assert [e[0] for e in log].count("reduce_scatter") == 2 * n_layers
    np.testing.assert_array_equal(got_tok, want_tok)
    for g, w in zip(got_caches, want_caches):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("case", ["qwen", "qwen_sw8"])
def test_serve_session_matches_jax(case):
    """ServeSession.generate (prefill, the handoff, decode) gives the
    reference session's tokens; with a window of 8 under a 12-token
    prompt the handoff rolls the prompt's last 8 positions into their
    slots (p % 8)."""
    s_p, n_new = 12, 4
    cfg_j, cfg = configs(case)
    jpcfg, pcfg = pcfgs()
    prompt = tokens(case, seed=3, s=s_p)
    jsess = JaxServeSession(cfg_j, jpcfg, jax_mesh(), 2, B, s_p, s_p + n_new)
    want = jsess.generate(jax_params(case), jnp.asarray(prompt), n_new)
    sess = ServeSession(cfg, pcfg, MESH, 2, B, s_p, s_p + n_new,
                        device="cpu")
    got = sess.generate(port_params(case, serve=True),
                        torch.from_numpy(prompt), n_new)
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_kv_cache_matches_jax():
    """The int8 KV cache (per-slot symmetric scales): the port's
    teacher-forced tokens equal the reference's int8 decode; its codes
    and scales equal the reference's; and the int8 ServeSession (whose
    handoff quantizes the prompt's slots) agrees with the param-dtype
    session on > 85% of tokens, the reference's own bar
    (tests/test_decode.py::test_int8_kv_cache_close_to_bf16)."""
    want, jcache = jax_decode("qwen", "int8")
    got, cache = port_decode("qwen", "int8")
    np.testing.assert_array_equal(got, want)
    cfg = configs("qwen")[1]
    _, pcfg = pcfgs(kv_cache_dtype="int8")
    got_cache = convert.decode_caches_to_jax(cache, cfg, pcfg, MESH, B, S)
    for g, w in zip(got_cache, jcache):
        for k in ("k", "v"):
            np.testing.assert_array_equal(g[k], w[k])
        for k in ("k_scale", "v_scale"):
            np.testing.assert_allclose(g[k], w[k], **TOL)
    s_p, n_new = 8, 8
    prompt = torch.from_numpy(tokens("qwen", seed=4, s=s_p))
    out = {}
    for kv in ("param", "int8"):
        sess = ServeSession(cfg, pcfgs(kv_cache_dtype=kv)[1], MESH, 2, B,
                            s_p, s_p + n_new, device="cpu")
        out[kv] = sess.generate(port_params("qwen", serve=True), prompt,
                                n_new)
    assert (out["param"] == out["int8"]).float().mean() > 0.85


def test_launcher_loop_matches_decode():
    """`launch/serve.py`'s loop (teacher-forced prompt, then free-running)
    on the CPU: its generated tokens are the decode steps' own greedy
    predictions, and its CLI runs (`--device cpu`, reduced by default)."""
    cfg = configs("qwen")[1]
    _, pcfg = pcfgs()
    p, gen = 6, 4
    dstep, _, _, _ = stages.build_decode_step(cfg, pcfg, MESH, s_max=p + gen,
                                              global_batch=B, device="cpu")
    params = port_params("qwen", serve=True)
    prompt = torch.from_numpy(tokens("qwen", seed=5, s=p))
    cache = stages.init_cache(cfg, pcfg, MESH, 2, B, p + gen, device="cpu")
    out = serve_launch.decode_loop(dstep, params, cache, prompt, gen, MESH,
                                   DP)
    assert out.shape == (B, p + gen)
    assert torch.equal(out[:, :p], prompt)
    # replay: each generated token is the step's prediction on the prefix
    cache = stages.init_cache(cfg, pcfg, MESH, 2, B, p + gen, device="cpu")
    for t in range(p + gen - 1):
        nxt, cache = dstep(params, cache,
                           stack(out[:, t:t + 1].numpy(), (DP, None)), t)
        if t + 1 >= p:
            assert np.array_equal(convert.from_stacked(nxt, MESH, (DP,)),
                                  out[:, t + 1].numpy())
    serve_launch.main(["--arch", "qwen3-0.6b", "--device", "cpu",
                       "--prompt-len", "4", "--gen", "2"])


def test_cache_and_param_round_trips_bitwise():
    """lm_params_{from,to}_jax in both layouts and
    decode_caches_{from,to}_jax (param and int8) are exact inverses."""
    cfg = configs("internvl")[1]
    ref = params_np("internvl")
    for serve_layout in (False, True):
        back = convert.lm_params_to_jax(
            convert.lm_params_from_jax(ref, cfg, MESH, serve=serve_layout),
            cfg, MESH, serve=serve_layout)
        jax.tree.map(np.testing.assert_array_equal, back, ref)
    rng = np.random.default_rng(6)
    for kv in ("param", "int8"):
        _, pcfg = pcfgs(kv_cache_dtype=kv)
        caches = stages.init_cache(cfg, pcfg, MESH, 2, B, S, device="cpu")
        glob = convert.decode_caches_to_jax(caches, cfg, pcfg, MESH, B, S)
        glob = [{k: (rng.integers(-127, 128, v.shape).astype(v.dtype)
                     if v.dtype == np.int8 else
                     rng.standard_normal(v.shape).astype(v.dtype))
                 for k, v in layer.items()} for layer in glob]
        back = convert.decode_caches_to_jax(
            convert.decode_caches_from_jax(glob, cfg, pcfg, MESH, B, S),
            cfg, pcfg, MESH, B, S)
        for g, w in zip(back, glob):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mamba2-1.3b",
                                  "hymba-1.5b", "whisper-medium"])
def test_deferred_families_raise(arch):
    """moe, ssm, hybrid and audio never fall through to a dense layer:
    their layers, caches and decode raise NotImplementedError naming
    the ROADMAP item that ports them."""
    cfg = reduced_config(get_config(arch))
    _, pcfg = pcfgs()
    b = Builder("spec")
    with pytest.raises(NotImplementedError, match="6b"):
        blocks.layer_params(b, cfg, 2, cross=bool(cfg.encoder_layers))
    with pytest.raises(NotImplementedError, match="6b"):
        serve.make_cache(b, cfg, 2, B, S, pcfg)
    with pytest.raises(NotImplementedError, match="6b"):
        serve.decode_step({}, [], None, 0, cfg, None, S)
    with pytest.raises(NotImplementedError, match="6b"):
        blocks.layer_forward({}, None, cfg, None,
                             blocks.LayerIO())
    with pytest.raises(NotImplementedError, match="6b"):
        stages.init_params(cfg, MESH, 2, device="cpu")
