"""DeepSeek-V3 (`configs/deepseek_v3.py`: MLA with a latent cache, leading
dense layers, the `noaux_tc` router, an expert share) through the port's
serving path against the benchmark's plain reference
(`perfbench/reference/deepseek_v3.py`, loaded by its path), on seeded
random weights at a small size on the CPU, in float32: d 64, 4 heads of
16 + 8 (v 12: its own width), q_lora 32, kv_lora 16, one dense layer then
three MoE layers, 4 of 16 experts held (4 groups, 2 kept), top-4.

Prefill's last-position logits and every layer's latent cache on
(1, 1, 1) and stacked on (1, 1, 2) / (1, 1, 4); prefill then 8 decode
steps through `ServeSession` (the absorbed form) against the full
forward; the router (group cut, bias for selection only, normalisation,
the scaling) against a brute force; YaRN's frequencies and scale
against their closed form; the four quarter-shares' routed outputs and
the shared expert against the uncut layer; and faults that must fail.
"""
import dataclasses
import json
import math
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "perfbench"))

import bench_harness as H  # noqa: E402

from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.core import CollectiveEngine  # noqa: E402
from repro_torch.models import attention, common, mlp  # noqa: E402
from repro_torch.parallel.ops import ParCtx  # noqa: E402

drv = H.load_module("drivers/deepseek_prefill.py")
faults = H.load_module("deepseek_faults.py")
ref = drv.ref

SEED = 2**31 + 314
S = 32
# fp32 against fp32 in another order: the widest error seen is ~4e-6 of
# the rms; a mechanism left out or altered moves the answers by more
# than 1e-2
TOL = 1e-4
SMALL = dict(hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
             num_attention_heads=4, num_key_value_heads=4, q_lora_rank=32,
             kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
             v_head_dim=12, n_routed_experts=4, router_experts=16,
             n_group=4, topk_group=2, num_experts_per_tok=4, vocab_size=256,
             num_hidden_layers=4, first_k_dense_replace=1, dtype="float32")
PARAMS = {"batch": 1, "prompt_tokens": S, "pool": 2}


def _cfg(model: int = 1, **over) -> dict:
    cfg = json.loads((ROOT / "perfbench" / "configs"
                      / "deepseek-v3-7l-ep32.json").read_text())
    cfg.update(SMALL, mesh={"pod": 1, "data": 1, "model": model})
    cfg.update(over)
    return cfg


def _tokens(cfg, seed: int = SEED):
    return drv.prompts(cfg, PARAMS, seed)


def _gaps(prog, cfg, tokens) -> tuple:
    """(logit gap, widest cache gap) of the program's prefill of `tokens`
    against the reference's forward with `cfg`."""
    lg, caches = prog.answers(prog(tokens[None]))
    want_lg, want_caches = drv.reference(prog, cfg, tokens)
    cgap = max(ref.gap(g, w) for got, want in zip(caches, want_caches)
               for g, w in zip(got, want))
    return ref.gap(lg, want_lg[0]), cgap


@pytest.mark.parametrize("model", [1, 2, 4])
def test_prefill_matches_reference(model):
    cfg = _cfg(model)
    prog = drv.Program(cfg, PARAMS, SEED, "cpu")
    lgap, cgap = _gaps(prog, cfg, _tokens(cfg)[0])
    assert lgap < TOL and cgap < TOL, (lgap, cgap)
    assert prog.cache_names == ("c_kv", "k_pe")
    assert prog.dropped() == 0
    m = prog.ctx.engine.metrics
    assert m.get("moe.assignments") == 3 * S * 4
    assert 0 < m.get("moe.absent") < m.get("moe.assignments")


@pytest.mark.parametrize("budget", [0, 2048])
def test_chunked_dispatch_matches_reference(monkeypatch, budget):
    """A dispatch buffer past `mlp.DISPATCH_BYTES` goes in runs of each
    rank's tokens (at budget 0, one token a run), each run's buffer sized
    by its own counts: the same answers, nothing dropped, the same
    assignments counted."""
    cfg = _cfg(2)
    prog = drv.Program(cfg, PARAMS, SEED, "cpu")
    whole = prog.answers(prog(_tokens(cfg)[0][None]))
    real, runs = mlp.dispatch_runs, []

    def counted(top_pe, e_eff, row_bytes, ctx):
        got = real(top_pe, e_eff, row_bytes, ctx)
        runs.append(len(got))
        rows = math.prod(top_pe.shape[:ctx.lead]) * e_eff * row_bytes
        assert all(rows * cap <= budget or c.stop - c.start == 1
                   for c, cap, _loads, _absent in got)
        assert [c.stop - c.start for c, *_ in got] == [
            top_pe.shape[-2] // len(got)] * len(got)
        return got
    monkeypatch.setattr(mlp, "DISPATCH_BYTES", budget)
    monkeypatch.setattr(mlp, "dispatch_runs", counted)
    lgap, cgap = _gaps(prog, cfg, _tokens(cfg)[0])
    assert lgap < TOL and cgap < TOL, (lgap, cgap)
    chunked = prog.answers(prog(_tokens(cfg)[0][None]))
    assert ref.gap(chunked[0], whole[0]) < TOL
    assert runs and min(runs) > 1
    if budget == 0:
        assert set(runs) == {S // 2}
    m = prog.ctx.engine.metrics
    assert m.get("moe.dropped") == 0
    assert m.get("moe.assignments") == 3 * 3 * S * 4


def test_prefill_then_decode_matches_full_forward():
    """A 32-token prompt, then 8 decode steps over the latent cache in the
    absorbed form, each step's logits against the reference's full
    forward over the prompt and the tokens generated."""
    from repro_torch.parallel import stages
    from repro_torch.runtime.serve_session import ServeSession
    cfg = _cfg(2)
    arch = drv.arch_config(cfg)
    mesh = dict(cfg["mesh"])
    n = 9
    sess = ServeSession(arch, ParallelConfig(), mesh, 2, 1, S, S + n,
                        device="cpu")
    params = stages.init_params(arch, mesh, 2, seed=SEED, device="cpu",
                                serve=True)
    tokens = _tokens(cfg)[:1]
    gen, logits = sess.generate(params, tokens, n, return_logits=True)
    assert gen.shape == (1, n) and logits.shape == (1, n, 256)
    w = drv.Weights(arch, params, mesh)
    seq = torch.cat([tokens[0], gen[0, :-1].to(tokens.dtype)])
    want, _ = ref.forward(w.layer_of, w.embed(), w.head(), w.final_norm(),
                          seq, cfg, last=n)
    gaps = [ref.gap(logits[0, i], want[i]) for i in range(n)]
    assert max(gaps) < TOL, gaps
    assert torch.equal(gen[0], want.argmax(-1).to(gen.dtype))


def _brute_route(scores, bias, k, groups, keep, scale):
    """Every token by itself, as written: group scores, kept groups, the
    top-k of s + b among them, gates from s."""
    top, gates = [], []
    e = scores.shape[-1]
    per = e // groups
    for s in scores:
        b = s + bias
        gs = [sorted(b[g * per:(g + 1) * per].tolist())[-2:]
              for g in range(groups)]
        ranked = sorted(range(groups), key=lambda g: -sum(gs[g]))[:keep]
        allowed = [i for i in range(e) if i // per in ranked]
        chosen = sorted(allowed, key=lambda i: -float(b[i]))[:k]
        w = torch.stack([s[i] for i in chosen])
        top.append(chosen)
        gates.append(w / w.sum() * scale)
    return torch.tensor(top), torch.stack(gates)


def test_router_matches_brute_force():
    """Sigmoid scores, the group cut by each group's two best biased
    scores, the top-k among the kept groups' biased scores, the gates
    from the unbiased scores normalised and x 2.5."""
    cfg = drv.arch_config(_cfg(1))
    g = torch.Generator().manual_seed(5)
    logits = torch.randn(64, 16, generator=g)
    bias = torch.randn(16, generator=g) * 0.3
    _probs, top_e, gate = mlp.route(logits, cfg, bias)
    want_e, want_g = _brute_route(torch.sigmoid(logits), bias, 4, 4, 2, 2.5)
    assert torch.equal(top_e, want_e)
    assert torch.allclose(gate, want_g, rtol=1e-6, atol=0)
    assert torch.allclose(gate.sum(-1), torch.full((64,), 2.5))
    # the reference's gate picks the same experts
    ref_e, _gap = ref.gate(torch.sigmoid(logits), bias, _cfg(1))
    assert torch.equal(torch.sort(ref_e, -1).values,
                       torch.sort(top_e, -1).values)
    # the bias moves the selection but never the gates' values
    _p, top0, _g0 = mlp.route(logits, cfg, None)
    assert not torch.equal(top0, top_e)
    assert torch.equal(gate, torch.gather(torch.sigmoid(logits), -1, top_e)
                       / torch.gather(torch.sigmoid(logits), -1, top_e)
                       .sum(-1, keepdim=True) * 2.5)
    # every chosen expert lies in a kept group: 2 groups of 4 a token
    assert all(len(set((e // 4).tolist())) <= 2 for e in top_e)


def test_yarn_against_closed_form():
    """DeepSeek-V3's YaRN at rope 64, base 1e4, factor 40 over 4096
    positions, beta 32 / 1: the correction range is [10, 23] (floor and
    ceil of 64 ln(4096 / (2 pi beta)) / (2 ln 1e4)); below it the plain
    frequencies, above it / 40, a linear ramp between; the cos / sin
    factor 1 (mscale = mscale_all_dim); the softmax scale m^2 / sqrt(192),
    m = 0.1 ln 40 + 1."""
    arch = drv.arch_config(json.loads(
        (ROOT / "perfbench" / "configs"
         / "deepseek-v3-7l-ep32.json").read_text()))
    inv, m = common.yarn_inv_freq(64, 1e4, *arch.yarn)
    plain = torch.tensor([1e4 ** (-2 * i / 64) for i in range(32)])
    ramp = torch.tensor([min(max((i - 10) / 13, 0.0), 1.0)
                         for i in range(32)])
    want = plain / 40 * ramp + plain * (1 - ramp)
    assert m == 1.0
    assert torch.allclose(inv, want, rtol=1e-6, atol=0)
    assert torch.allclose(inv[:11], plain[:11], rtol=1e-6, atol=0)
    assert torch.allclose(inv[23:], plain[23:] / 40, rtol=1e-6, atol=0)
    ref_inv, ref_m = ref.yarn_inv_freq(64, json.loads(
        (ROOT / "perfbench" / "configs"
         / "deepseek-v3-7l-ep32.json").read_text()))
    assert torch.allclose(inv, ref_inv, rtol=1e-6, atol=0) and ref_m == m
    mscale = 0.1 * math.log(40) + 1
    assert attention.mla_scale(arch) == pytest.approx(
        mscale * mscale / math.sqrt(192), rel=1e-12)
    # the rotation of interleaved pairs: pair i = (x[2i], x[2i + 1]) turns
    # by p * inv[i], the result in halves
    x = torch.randn(1, 3, 1, 64, generator=torch.Generator().manual_seed(2))
    pos = torch.tensor([0, 7, 5000])
    got = common.rope(x, pos, 1e4, arch.yarn, interleave=True)
    a, b = x[..., 0::2], x[..., 1::2]
    ang = pos[:, None, None].float() * inv
    want = torch.cat([a * ang.cos() - b * ang.sin(),
                      b * ang.cos() + a * ang.sin()], dim=-1)
    assert torch.allclose(got, want, atol=1e-5)


def test_quarter_shares_add_up_to_the_uncut_layer():
    """The MoE layer of 16 experts cut into four shares of 4 (offsets 0,
    4, 8, 12), each with its own experts' weights: their routed outputs
    summed, with the shared expert counted once, equal the uncut
    reference's layer (every expert held)."""
    cfg = _cfg(2, n_routed_experts=16)
    prog = drv.Program(cfg, PARAMS, SEED, "cpu")
    arch = prog.arch
    lp = prog.layer_of(1)
    x = torch.randn(S, arch.d_model, generator=torch.Generator()
                    .manual_seed(9))
    uncut = ref.moe(ref._Ops(), lp["moe"], x, cfg) \
        + ref.swiglu(ref._Ops(), x, *(lp["shared"][n]
                                      for n in ("w1", "w3", "w2")))
    stacked = {k: v[0] for k, v in prog.params["layers"]["mla_moe"]["moe"]
               .items()}
    xb = x.reshape(1, 1, 1, 1, S, -1).expand(1, 1, 2, 1, S, -1)
    total = 0
    for q in range(4):
        cut = dataclasses.replace(arch, n_experts=4, expert_offset=4 * q)
        el = 2             # experts a rank holds of the share's 4
        p = dict(stacked)
        for n in ("w1", "w3", "w2"):
            # rank r holds the share's experts [2r, 2r + 2)
            w = stacked[n].reshape((1, 1, 16) + stacked[n].shape[-2:])
            p[n] = w[:, :, 4 * q:4 * q + 4].reshape(
                (1, 1, 2, el) + stacked[n].shape[-2:])
        eng = CollectiveEngine(dict(cfg["mesh"]), device="cpu")
        y, _ = mlp.moe_block(p, xb, cut, ParCtx(engine=eng,
                                                pcfg=ParallelConfig()),
                             by_count=True)
        total = total + y[0, 0, 0, 0]
        assert eng.metrics.get("moe.dropped") == 0
        assert eng.metrics.get("moe.absent") > 0
    sh = {k: v for k, v in lp["shared"].items()}
    total = total + ref.swiglu(ref._Ops(), x, sh["w1"], sh["w3"], sh["w2"])
    assert ref.gap(total, uncut) < TOL


def test_absent_assignments_counted():
    """`moe.absent` counts exactly the assignments to experts held
    elsewhere, as the reference's routing gives them."""
    cfg = _cfg(2)
    prog = drv.Program(cfg, PARAMS, SEED, "cpu")
    prog.record(True)
    prog(_tokens(cfg)[0][None])
    routes = prog.record(False)
    absent = sum(int((r >= cfg["n_routed_experts"]).sum()) for r in routes)
    assert prog.ctx.engine.metrics.get("moe.absent") == absent > 0


@pytest.mark.parametrize("fault", ["no_mscale", "bias_in_gates", "no_yarn",
                                   "wrong_share", "no_alltoall",
                                   "latent_dropped"])
def test_each_fault_fails(fault):
    """The scale without m^2, the bias in the gates, YaRN left out, the
    wrong expert share, the alltoall left out, the latent not carried:
    each fails the comparison."""
    cfg = _cfg(2)
    prog = getattr(faults, fault)(cfg, PARAMS, SEED, "cpu")
    lgap, cgap = _gaps(prog, cfg, _tokens(cfg)[0])
    assert max(lgap, cgap) > 100 * TOL, (fault, lgap, cgap)


def test_registered_and_served_by_the_launcher(capsys):
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import ARCH_IDS, ASSIGNED_ARCHS
    from repro_torch.launch import serve
    cfg = get_config("deepseek-v3")
    assert cfg.n_params() == pytest.approx(671.0e9, rel=1e-3)
    assert cfg.n_active_params() == pytest.approx(37.55e9, rel=1e-3)
    assert "deepseek-v3" not in ARCH_IDS
    assert "deepseek_v3" not in ASSIGNED_ARCHS
    small = reduced_config(cfg)
    assert small.layer_types == ("mla_dense", "mla_moe")
    serve.main(["--arch", "deepseek-v3", "--device", "cpu", "--batch", "2",
                "--prompt-len", "16", "--gen", "3", "--tp", "2",
                "--devices", "2"])
    assert "deepseek-v3" in capsys.readouterr().out


def _flash_fwd_one_width(q, k, v, window: int, *, causal: bool, qb: int,
                         kb: int, q_offset: int, scale=None):
    """The blocked core as it was before v got its own width (one `hd`
    for q, k, v and the accumulator), kept to hold the shared core to it
    bitwise."""
    b, nq, qbs, kv, g, hd = q.shape
    nk = k.shape[0]
    dev = q.device
    scale = scale or 1.0 / math.sqrt(hd)
    eff_w = window if window > 0 else 1 << 30
    outs, lses = [], []
    for qi in range(nq):
        qblk = q[:, qi].float()
        q_pos = q_offset + qi * qbs + torch.arange(qbs, device=dev)
        m = torch.full((b, kv, g, qbs), attention.NEG_INF,
                       dtype=torch.float32, device=dev)
        l = torch.zeros((b, kv, g, qbs), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kv, g, qbs, hd), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            kblk, vblk = k[ki], v[ki]
            k_pos = ki * kb + torch.arange(kb, device=dev)
            s = torch.einsum("bqkgh,bskh->bkgqs", qblk, kblk.float()) * scale
            mask = k_pos[None, :] > q_pos[:, None] - eff_w
            if causal:
                mask &= k_pos[None, :] <= q_pos[:, None]
            s = torch.where(mask, s, attention.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bkgqs,bskh->bkgqh",
                              p.to(vblk.dtype).float(), vblk.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        lc = torch.clamp_min(l, 1e-30)
        outs.append((acc / lc[..., None]).to(q.dtype))
        lses.append(m + torch.log(lc))
    return torch.stack(outs, 1), torch.stack(lses, 1)


def _granite_prefill():
    gdrv = H.load_module("drivers/granite_prefill.py")
    cfg = json.loads((ROOT / "perfbench" / "configs"
                      / "granite-4.0-h-small-20l.json").read_text())
    cfg.update(hidden_size=64, mamba_n_heads=8, mamba_d_head=16,
               mamba_d_state=16, mamba_chunk_size=16, num_attention_heads=4,
               num_key_value_heads=2, num_local_experts=8,
               num_experts_per_tok=2, intermediate_size=32,
               shared_intermediate_size=64, vocab_size=256,
               num_hidden_layers=4,
               layer_types=["mamba", "attention", "mamba", "attention"],
               attention_multiplier=0.05, dtype="bfloat16",
               mesh={"pod": 1, "data": 1, "model": 2})
    prog = gdrv.Program(cfg, PARAMS, SEED, "cpu")
    tokens = gdrv.prompts(cfg, PARAMS, SEED)[:1]
    return lambda: prog(tokens)


def _gqa_prefill():
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.parallel import stages
    cfg = reduced_config(get_config("qwen3-0.6b"), param_dtype="bfloat16",
                         compute_dtype="bfloat16")
    mesh = {"pod": 1, "data": 1, "model": 2}
    fn, _ctx, _, bspec = stages.build_prefill(
        cfg, ParallelConfig(attn_q_block=8, attn_kv_block=16), mesh, 2, S,
        device="cpu")
    params = stages.init_params(cfg, mesh, 2, seed=SEED, device="cpu",
                                serve=True)
    from repro_torch.convert import stack_global
    tokens = torch.randint(cfg.vocab_size, (2, S),
                           generator=torch.Generator().manual_seed(SEED))
    batch = {"tokens": stack_global(tokens, mesh, bspec["tokens"])}
    return lambda: fn(params, batch, return_logits=True)


@pytest.mark.parametrize("family", ["granite", "qwen3-0.6b"])
def test_shared_core_leaves_other_families_bitwise(family, monkeypatch):
    """The blocked core with v's own width gives Granite's prefill (NoPE
    GQA attention beside Mamba2, bf16) and a GQA family's (qwen3-0.6b,
    bf16, several blocks) logits, tokens and caches bitwise as the core of
    one width did."""
    serve_once = (_granite_prefill if family == "granite"
                  else _gqa_prefill)()
    now = serve_once()
    monkeypatch.setattr(attention, "_flash_fwd_blocks",
                        _flash_fwd_one_width)
    before = serve_once()
    flat_now = [now[0], *now[1], now[2]]
    flat_before = [before[0], *before[1], before[2]]
    assert len(flat_now) == len(flat_before)
    for a, b in zip(flat_now, flat_before):
        assert a.dtype == b.dtype and torch.equal(a, b)
