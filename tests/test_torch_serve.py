"""The port's LM serving path against the JAX package: teacher-forced
decode, prefill, the serve session and the int8 KV cache, at reduced
size on the (2, 2, 2) mesh (`_torch_lm_cases.py`), for every family:
dense, VLM, MoE, SSM, hybrid and audio (the cross cache).

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
    B, DP, MESH, S, S_ENC, TOL, batch_np, case_pcfgs, configs, jax_decode,
    jax_mesh, jax_params, jax_prefill, owner_gathered, params_np, pcfgs,
    port_decode, port_params, port_prefill, stack, tokens,
)
from repro.parallel import stages as jax_stages
from repro.runtime.serve_session import ServeSession as JaxServeSession
from repro.runtime.serve_session import \
    convert_prefill_caches as jax_convert_prefill_caches
from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import serve as serve_launch
from repro_torch.models import attention, lm
from repro_torch.parallel import stages
from repro_torch.runtime import ServeSession, convert_prefill_caches


def _port_forward_argmax(case: str):
    """The port's own forward (FSDP layout, the reference's training
    params) and greedy head at every position: (B, S)."""
    cfg = configs(case)[1]
    _, pcfg = case_pcfgs(case)
    ctx = stages.make_ctx(cfg, pcfg, MESH, device="cpu")
    params = port_params(case, serve=False)
    x, _ = lm.forward(params, {"tokens": stack(tokens(case), (DP, None))},
                      cfg, ctx)
    preds = [lm.lm_head_sample(params, x[..., i, :], cfg, ctx)
             for i in range(S)]
    return np.stack([convert.from_stacked(p, MESH, (DP,)) for p in preds], 1)


@pytest.mark.parametrize("case", ["qwen", "smollm31", "smollm63",
                                  "qwen_sw8", "internvl", "mixtral",
                                  "mixtral_pe", "qwen3moe", "mamba",
                                  "hymba", "hymba_pad"])
def test_decode_matches_jax_and_forward(case):
    """16 teacher-forced decode tokens equal the reference's decode and
    the port's own forward at every position (agreement 1.0, the
    reference's test_decode_matches_forward: MoE dispatch with the
    dropless serving capacity, the SSM's O(1) carries against the
    chunked forward), and the final caches (the SSM `conv`/`state`
    included) equal the reference's."""
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


@pytest.mark.parametrize("case", ["qwen", "smollm31", "internvl", "mixtral",
                                  "mamba", "mamba_2chunks", "hymba",
                                  "hymba_pad", "whisper"])
def test_prefill_matches_jax(case):
    """prefill's next token and its layer-stacked caches (the VLM's with
    the visual prefix; the replicated-KV case's sequence-sharded, equal
    once gathered through each rank's owners as the reference emits it;
    the SSM's conv window and final state, after two SSD chunks in
    mamba_2chunks; the audio family's static cross cache xk/xv) equal
    the reference's."""
    cfg = configs(case)[1]
    want_tok, want_caches = jax_prefill(case)
    got_tok, got_caches, _log = port_prefill(case)
    np.testing.assert_array_equal(got_tok, want_tok)
    for i, (g, w) in enumerate(zip(got_caches, want_caches)):
        if i < 2 and cfg.has_attention and \
                not attention.kv_layout(cfg, 2)[1]:
            assert g.shape[-2] == cfg.n_kv_heads
            g = owner_gathered(g, case)
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


@pytest.mark.parametrize("case", ["qwen", "qwen_sw8", "mixtral", "mamba",
                                  "hymba"])
def test_serve_session_matches_jax(case):
    """ServeSession.generate (prefill, the handoff, decode) gives the
    reference session's tokens; with a window of 8 under a 12-token
    prompt the handoff rolls the prompt's last 8 positions into their
    slots (p % 8); the SSM carries hand over as prefill left them."""
    s_p, n_new = 12, 4
    cfg_j, cfg = configs(case)
    jpcfg, pcfg = case_pcfgs(case)
    prompt = tokens(case, seed=3, s=s_p)
    jsess = JaxServeSession(cfg_j, jpcfg, jax_mesh(), 2, B, s_p, s_p + n_new)
    want = jsess.generate(jax_params(case), jnp.asarray(prompt), n_new)
    sess = ServeSession(cfg, pcfg, MESH, 2, B, s_p, s_p + n_new,
                        device="cpu")
    got = sess.generate(port_params(case, serve=True),
                        torch.from_numpy(prompt), n_new)
    np.testing.assert_array_equal(got.numpy(), want)


def test_serve_session_calls_its_step_fns_plainly():
    """Without `return_logits`, generate calls the prefill and decode fns
    in their plain form, (params, batch) and (params, caches, tokens,
    pos), so a caller's wrapper of that form serves as before; with it,
    the tokens are the same and each comes with its logits."""
    s_p, n_new = 8, 3
    cfg = configs("qwen")[1]
    _, pcfg = case_pcfgs("qwen")
    prompt = torch.from_numpy(tokens("qwen", seed=5, s=s_p))
    params = port_params("qwen", serve=True)
    sess = ServeSession(cfg, pcfg, MESH, 2, B, s_p, s_p + n_new,
                        device="cpu")
    want, logits = sess.generate(params, prompt, n_new, return_logits=True)
    calls = []
    pf, df = sess.prefill_fn, sess.decode_fn

    def plain_pf(params, batch):
        calls.append("prefill")
        return pf(params, batch)

    def plain_df(params, caches, tok, pos):
        calls.append(pos)
        return df(params, caches, tok, pos)
    sess.prefill_fn, sess.decode_fn = plain_pf, plain_df
    got = sess.generate(params, prompt, n_new)
    assert calls == ["prefill", s_p, s_p + 1]
    assert torch.equal(got, want)
    assert logits.shape == (B, n_new, cfg.vocab_size)
    assert torch.equal(logits.argmax(-1).to(want.dtype), want)


@pytest.mark.parametrize("case", ["smollm31", "smollm63", "hymba_rep"])
def test_serve_session_replicated_kv_matches_decode(case):
    """With KV heads replicated (the flash-combine decode cache), the
    session's handoff gives decode the kv heads it reads, so the
    session's tokens equal the teacher-forced decode loop's (the
    reference's test_prefill_decode_handoff). The reference's prefill
    emits owner-gathered heads that its decode misreads (ROADMAP Queue
    3), so this is held against the port's own decode-only path."""
    s_p, n_new = 8, 6
    cfg = configs(case)[1]
    _, pcfg = case_pcfgs(case)
    prompt = torch.from_numpy(tokens(case, seed=10, s=s_p))
    params = port_params(case, serve=True)
    sess = ServeSession(cfg, pcfg, MESH, 2, B, s_p, s_p + n_new,
                        device="cpu")
    got = sess.generate(params, prompt, n_new)
    dstep, _, _, _ = stages.build_decode_step(
        cfg, pcfg, MESH, s_max=s_p + n_new, global_batch=B, device="cpu")
    cache = stages.init_cache(cfg, pcfg, MESH, 2, B, s_p + n_new,
                              device="cpu")
    want = serve_launch.decode_loop(dstep, params, cache, prompt, n_new - 1,
                                    MESH, DP)
    assert not attention.kv_layout(cfg, 2)[1]
    np.testing.assert_array_equal(got.numpy()[:, :n_new - 1],
                                  want[:, s_p:].numpy())


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


def test_whisper_decode_with_cross_cache():
    """The reference's test_whisper_decode_with_cross_cache: three
    free-running decode steps over a zero cross cache of 12 frames —
    the port's tokens equal the reference's, in the vocab."""
    cfg_j, cfg = configs("whisper")
    jpcfg, pcfg = case_pcfgs("whisper")
    s_max, s_enc = 8, S_ENC["whisper"]
    jstep, _, _, _ = jax_stages.build_decode_step(
        cfg_j, jpcfg, jax_mesh(), s_max=s_max, global_batch=B, s_enc=s_enc)
    jcache = jax_stages.init_cache(cfg_j, jpcfg, jax_mesh(), 2, B, s_max,
                                   s_enc=s_enc)
    dstep, _, _, _ = stages.build_decode_step(
        cfg, pcfg, MESH, s_max=s_max, global_batch=B, s_enc=s_enc,
        device="cpu")
    cache = stages.init_cache(cfg, pcfg, MESH, 2, B, s_max, s_enc=s_enc,
                              device="cpu")
    params = port_params("whisper", serve=True)
    jtok = jnp.asarray(tokens("whisper", seed=7, s=1))
    tok = stack(np.asarray(jtok), (DP, None))
    for t in range(3):
        jnxt, jcache = jstep(jax_params("whisper"), jcache, jtok,
                             jnp.int32(t))
        nxt, cache = dstep(params, cache, tok, t)
        got = convert.from_stacked(nxt, MESH, (DP,))
        np.testing.assert_array_equal(got, np.asarray(jnxt))
        assert ((got >= 0) & (got < cfg.vocab_size)).all()
        jtok = jnxt[:, None].astype(jnp.int32)
        tok = nxt[..., None]


def test_whisper_serving_pieces_match_jax():
    """The audio family served as its session cannot be (ROADMAP Queue
    3): prefill over the prompt and 12 stub frames, the handoff with
    s_enc (the static cross cache carried over), then decode steps that
    read it — every token equals the reference's pieces' (its
    build_prefill, convert_prefill_caches and build_decode_step)."""
    cfg_j, cfg = configs("whisper")
    jpcfg, pcfg = case_pcfgs("whisper")
    s_enc, n_new = S_ENC["whisper"], 4
    s_max = S + n_new
    batch = batch_np("whisper")
    want_tok, want_caches = jax_prefill("whisper")
    jcaches = jax_convert_prefill_caches(
        want_caches, cfg_j, jpcfg, jax_mesh(), 2, B, S, s_max, s_enc=s_enc)
    jstep, _, _, _ = jax_stages.build_decode_step(
        cfg_j, jpcfg, jax_mesh(), s_max=s_max, global_batch=B, s_enc=s_enc)
    pf, _, _, bspec = stages.build_prefill(cfg, pcfg, MESH, B, S,
                                           device="cpu")
    params = port_params("whisper", serve=True)
    nxt, caches = pf(params, {k: stack(v, bspec[k])
                              for k, v in batch.items()})
    caches = convert_prefill_caches(caches, cfg, pcfg, MESH, 2, B, S, s_max,
                                    s_enc=s_enc)
    dstep, _, _, _ = stages.build_decode_step(
        cfg, pcfg, MESH, s_max=s_max, global_batch=B, s_enc=s_enc,
        device="cpu")
    jnxt = jnp.asarray(want_tok)
    for i in range(n_new):
        np.testing.assert_array_equal(convert.from_stacked(nxt, MESH, (DP,)),
                                      np.asarray(jnxt))
        jnxt, jcaches = jstep(jax_params("whisper"), jcaches,
                              jnxt[:, None].astype(jnp.int32),
                              jnp.int32(S + i))
        nxt, caches = dstep(params, caches, nxt[..., None], S + i)


def test_whisper_replicated_kv_cross_cache_whole():
    """With KV heads replicated (1 kv head at tp 2), prefill hands decode
    the whole static cross cache (all 12 encoder positions on every
    rank), though the self cache is sequence-sharded; the served pieces'
    tokens equal the port's own forward over the prompt, the generated
    tokens and the same frames (the reference seq-shards its cross cache
    here too, which decode reads as full-length: ROADMAP Queue 3)."""
    case = "whisper_rep"
    cfg = configs(case)[1]
    _, pcfg = case_pcfgs(case)
    s_enc, n_new = S_ENC[case], 5      # the forward's 20 tokens tile by 4
    s_max = S + n_new
    assert not attention.kv_layout(cfg, 2)[1]
    batch = batch_np(case)
    params = port_params(case, serve=True)
    pf, _, _, bspec = stages.build_prefill(cfg, pcfg, MESH, B, S,
                                           device="cpu")
    nxt, caches = pf(params, {k: stack(v, bspec[k])
                              for k, v in batch.items()})
    caches = convert_prefill_caches(caches, cfg, pcfg, MESH, 2, B, S, s_max,
                                    s_enc=s_enc)
    for c in caches:
        assert c["xk"].shape[-3] == s_enc and c["xv"].shape[-3] == s_enc
    dstep, _, _, _ = stages.build_decode_step(
        cfg, pcfg, MESH, s_max=s_max, global_batch=B, s_enc=s_enc,
        device="cpu")
    got = [convert.from_stacked(nxt, MESH, (DP,))]
    for i in range(n_new - 1):
        nxt, caches = dstep(params, caches, nxt[..., None], S + i)
        got.append(convert.from_stacked(nxt, MESH, (DP,)))
    got = np.stack(got, 1)
    seq = np.concatenate([batch["tokens"], got[:, :-1]], axis=1)
    ctx = stages.make_ctx(cfg, pcfg, MESH, device="cpu")
    fparams = port_params(case, serve=False)
    x, _ = lm.forward(fparams, {"tokens": stack(seq, (DP, None)),
                                "frames": stack(batch["frames"],
                                                (DP, None, None))},
                      cfg, ctx)
    want = np.stack([convert.from_stacked(
        lm.lm_head_sample(fparams, x[..., S - 1 + i, :], cfg, ctx), MESH,
        (DP,)) for i in range(n_new)], 1)
    np.testing.assert_array_equal(got, want)


def test_audio_session_refuses_like_the_reference():
    """The reference's ServeSession prefills tokens only, so it cannot
    serve the audio family (prefill needs frames); the port's session
    mirrors it rather than diverging (ROADMAP Queue 3)."""
    cfg_j, cfg = configs("whisper")
    jpcfg, pcfg = case_pcfgs("whisper")
    prompt = tokens("whisper", s=8)
    jsess = JaxServeSession(cfg_j, jpcfg, jax_mesh(), 2, B, 8, 10)
    with pytest.raises(Exception):
        jsess.generate(jax_params("whisper"), jnp.asarray(prompt), 2)
    sess = ServeSession(cfg, pcfg, MESH, 2, B, 8, 10, device="cpu")
    with pytest.raises(KeyError, match="frames"):
        sess.generate(port_params("whisper", serve=True),
                      torch.from_numpy(prompt), 2)


@pytest.mark.parametrize("case", ["mixtral_pe", "qwen3moe", "mamba",
                                  "hymba_pad", "whisper"])
def test_family_round_trips_bitwise(case):
    """lm_params_{from,to}_jax (the router, stacked and pseudo experts,
    the SSM leaves, xattn, the encoder stack) in both layouts, and the
    decode caches (SSM conv/state, the cross cache xk/xv) and prefill
    caches through the converters, are exact inverses."""
    cfg = configs(case)[1]
    ref = params_np(case)
    for serve_layout in (False, True):
        back = convert.lm_params_to_jax(
            convert.lm_params_from_jax(ref, cfg, MESH, serve=serve_layout),
            cfg, MESH, serve=serve_layout)
        jax.tree.map(np.testing.assert_array_equal, back, ref)
    _, pcfg = case_pcfgs(case)
    s_enc = S_ENC.get(case, 0)
    rng = np.random.default_rng(8)
    caches = stages.init_cache(cfg, pcfg, MESH, 2, B, S, s_enc=s_enc,
                               device="cpu")
    glob = convert.decode_caches_to_jax(caches, cfg, pcfg, MESH, B, S,
                                        s_enc=s_enc)
    glob = [{k: rng.standard_normal(v.shape).astype(v.dtype)
             for k, v in layer.items()} for layer in glob]
    back = convert.decode_caches_to_jax(
        convert.decode_caches_from_jax(glob, cfg, pcfg, MESH, B, S,
                                       s_enc=s_enc),
        cfg, pcfg, MESH, B, S, s_enc=s_enc)
    for g, w in zip(back, glob):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mamba2-1.3b",
                                  "hymba-1.5b"])
def test_launcher_serves_family(arch):
    """`launch/serve.py` on the CPU for the MoE, SSM and hybrid families
    (reduced): its loop's sequences start with the prompt and hold ids
    in the vocab."""
    cfg = reduced_config(get_config(arch))
    _, pcfg = pcfgs(moe_capacity_factor=8.0)
    p, gen = 4, 3
    dstep, _, _, _ = stages.build_decode_step(cfg, pcfg, MESH, s_max=p + gen,
                                              global_batch=B, device="cpu")
    params = stages.init_params(cfg, MESH, 2, seed=1, device="cpu",
                                serve=True)
    cache = stages.init_cache(cfg, pcfg, MESH, 2, B, p + gen, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (B, p)).astype(np.int32))
    out = serve_launch.decode_loop(dstep, params, cache, prompt, gen, MESH,
                                   DP)
    assert out.shape == (B, p + gen) and torch.equal(out[:, :p], prompt)
    assert bool(((out >= 0) & (out < cfg.vocab_size)).all())
    serve_launch.main(["--arch", arch, "--device", "cpu", "--prompt-len",
                       "3", "--gen", "2"])
