"""Granite-4.0-H (`configs/base.py::LayerTypedConfig`) through the port's
serving path against the benchmark's plain reference
(`perfbench/reference/granite.py`, loaded by its path), on seeded random
weights at a small size on the CPU, in float32: d 64, layers
mamba / mamba / attention / mamba, 8 experts top-2 and the shared
expert, the muP scalars, NoPE and a conv bias.

Prefill's last-position logits and every layer's emitted caches on
(1, 1, 1) and stacked on (1, 1, 2) / (1, 1, 4) (EP over the stacked
ranks); prefill then decode through the cache against the full forward;
a router that sends every token to the same experts, where the
capacity rule drops and the dropless dispatch does not; and each of
NoPE, the attention scale, the muP scalars, the conv bias and the
shared expert with a case that fails without it.
"""
import json
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "perfbench"))

import bench_harness as H  # noqa: E402

from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.core import CollectiveEngine  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.parallel.ops import ParCtx  # noqa: E402

drv = H.load_module("drivers/granite_prefill.py")
faults = H.load_module("granite_faults.py")
ref = drv.ref

SEED = 2**31 + 99
S = 32
# fp32 against fp32 in another order: the widest error seen is ~4e-5 of
# the rms (caches, 1e-6 logits); a knob left out moves the answers by
# more than 1e-2
TOL = 1e-3
SMALL = dict(hidden_size=64, mamba_n_heads=8, mamba_d_head=16,
             mamba_d_state=16, mamba_chunk_size=16, num_attention_heads=4,
             num_key_value_heads=2, num_local_experts=8,
             num_experts_per_tok=2, intermediate_size=32,
             shared_intermediate_size=64, vocab_size=256,
             num_hidden_layers=4,
             layer_types=["mamba", "mamba", "attention", "mamba"],
             attention_multiplier=0.05, dtype="float32")


def _cfg(model: int = 1, **over) -> dict:
    cfg = json.loads((ROOT / "perfbench" / "configs"
                      / "granite-4.0-h-small-20l.json").read_text())
    cfg.update(SMALL, mesh={"pod": 1, "data": 1, "model": model})
    cfg.update(over)
    return cfg


PARAMS = {"batch": 1, "prompt_tokens": S, "pool": 2}


def _tokens(cfg, seed: int = SEED):
    return drv.prompts(cfg, PARAMS, seed)


def _gaps(prog, cfg, tokens) -> tuple:
    """(logit gap, widest cache gap) of the program's prefill of `tokens`
    against the reference's forward with `cfg`."""
    lg, caches = prog.answers(prog(tokens[None]))
    want_lg, want_caches = ref.forward(prog.layer_of, prog.embed(),
                                       prog.final_norm(), tokens, cfg)
    cgap = max(ref.gap(g, w) for got, want in zip(caches, want_caches)
               for g, w in zip(got, want))
    return ref.gap(lg, want_lg[0]), cgap


@pytest.mark.parametrize("model", [1, 2, 4])
def test_prefill_matches_reference(model):
    cfg = _cfg(model)
    prog = drv.Program(cfg, PARAMS, SEED, "cpu")
    lgap, cgap = _gaps(prog, cfg, _tokens(cfg)[0])
    assert lgap < TOL and cgap < TOL, (lgap, cgap)
    # every kind of cache, each layer its own: conv / state, then k / v
    assert prog.cache_names == ("conv", "state", "k", "v")
    assert prog.dropped() == 0
    assert prog.ctx.engine.metrics.get("moe.slots") >= \
        prog.ctx.engine.metrics.get("moe.assignments") == 4 * S * 2


def test_prefill_then_decode_matches_full_forward():
    from repro_torch.parallel import stages
    from repro_torch.runtime.serve_session import ServeSession
    cfg = _cfg(2)
    arch = drv.arch_config(cfg)
    mesh = dict(cfg["mesh"])
    n = 6
    sess = ServeSession(arch, ParallelConfig(), mesh, 2, 1, S, S + n,
                        device="cpu")
    params = stages.init_params(arch, mesh, 2, seed=SEED, device="cpu",
                                serve=True)
    tokens = _tokens(cfg)[:1]
    gen, logits = sess.generate(params, tokens, n, return_logits=True)
    assert gen.shape == (1, n) and logits.shape == (1, n, 256)
    w = drv.Weights(arch, params, mesh)
    seq = torch.cat([tokens[0], gen[0, :-1].to(tokens.dtype)])
    want, _ = ref.forward(w.layer_of, w.embed(), w.final_norm(), seq, cfg,
                          last=n)
    gaps = [ref.gap(logits[0, i], want[i]) for i in range(n)]
    assert max(gaps) < TOL, gaps
    assert torch.equal(gen[0], want.argmax(-1).to(gen.dtype))


def test_forced_router_dropless_drops_nothing():
    """Every token the same: all route to the same two experts. The
    capacity rule (1.25 x the mean load) drops most of them; the dropless
    dispatch sizes its buffer by the count and drops none, and equals the
    reference's loop over the experts."""
    cfg = _cfg(2)
    arch = drv.arch_config(cfg)
    prog = drv.Program(cfg, PARAMS, SEED, "cpu")
    lp = prog.weights.layer_of(0)
    d = arch.d_model
    x = torch.randn(d, generator=torch.Generator().manual_seed(3))
    xs = x.expand(S, d)
    want = ref.moe(ref._Ops(), lp["moe"], xs, cfg)
    stacked = prog.params["layers"]["mamba"]["moe"]
    moe_p = {k: v[0] for k, v in stacked.items()}
    xb = xs.reshape(1, 1, 1, 1, S, d).expand(1, 1, 2, 1, S, d)
    out = {}
    for by_count in (True, False):
        eng = CollectiveEngine(dict(cfg["mesh"]), device="cpu")
        ctx = ParCtx(engine=eng, pcfg=ParallelConfig())
        y, _ = mlp.moe_block(moe_p, xb, arch, ctx, by_count=by_count)
        out[by_count] = (y[0, 0, 0, 0], eng.metrics.get("moe.dropped"))
    y, dropped = out[True]
    assert dropped == 0 and ref.gap(y, want) < TOL
    y_cap, _ = out[False]
    assert ref.gap(y_cap, want) > 0.5        # most assignments dropped


@pytest.mark.parametrize("knob,variant", [
    ("NoPE", {"position_embedding_type": "rope"}),
    ("attention scale", {"attention_multiplier": 0.25}),
    ("embedding multiplier", {"embedding_multiplier": 1}),
    ("residual multiplier", {"residual_multiplier": 1.0}),
    ("logits scaling", {"logits_scaling": 1}),
])
def test_each_knob_left_out_fails(knob, variant):
    """The port run with one of the published knobs at its plain value,
    on the same weights, against the reference with the knob: fails."""
    cfg = _cfg(2)
    prog = drv.Program(_cfg(2, **variant), PARAMS, SEED, "cpu")
    lgap, cgap = _gaps(prog, cfg, _tokens(cfg)[0])
    assert max(lgap, cgap) > 10 * TOL, (knob, lgap, cgap)


@pytest.mark.parametrize("fault", ["no_shared", "no_alltoall",
                                   "expert_altered", "state_dropped"])
def test_each_part_left_out_fails(fault):
    """The shared expert, the alltoall, one expert's output, a Mamba
    layer's carried state: each broken, the comparison fails."""
    cfg = _cfg(2)
    prog = getattr(faults, fault)(cfg, PARAMS, SEED, "cpu")
    lgap, cgap = _gaps(prog, cfg, _tokens(cfg)[0])
    assert max(lgap, cgap) > 10 * TOL, (fault, lgap, cgap)


def test_conv_bias_left_out_fails():
    """The reference without the conv's bias (zeroed) against the port
    with it."""
    cfg = _cfg(2)
    prog = drv.Program(cfg, PARAMS, SEED, "cpu")

    def no_bias(i):
        w = prog.layer_of(i)
        if "ssm" in w:
            w["ssm"]["conv_x_b"] = w["ssm"]["conv_x_b"] * 0
            w["ssm"]["conv_bc_b"] = w["ssm"]["conv_bc_b"] * 0
        return w
    tokens = _tokens(cfg)[0]
    lg, _caches = prog.answers(prog(tokens[None]))
    want, _ = ref.forward(no_bias, prog.embed(), prog.final_norm(), tokens,
                          cfg)
    assert ref.gap(lg, want[0]) > 10 * TOL


def test_dropped_assignments_fail():
    """A dispatch one slot short of the largest count drops assignments:
    the engine's `moe.dropped` counts them."""
    cfg = _cfg(2)
    prog = faults.drops(cfg, PARAMS, SEED, "cpu")
    prog(_tokens(cfg)[0][None])
    assert prog.dropped() > 0


def test_registered_and_served_by_the_launcher(capsys):
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import ARCH_IDS, ASSIGNED_ARCHS
    from repro_torch.launch import serve
    cfg = get_config("granite-4.0-h-small")
    assert cfg.n_layers == 40 and cfg.kinds.count("attention") == 4
    assert cfg.kinds[5] == cfg.kinds[15] == "attention"
    assert abs(cfg.n_params() / 1e9 - 32.2) < 0.1
    assert "granite-4.0-h-small" not in ARCH_IDS
    assert "granite_4p0_h_small" not in ASSIGNED_ARCHS
    small = reduced_config(cfg)
    assert small.layer_types == ("mamba", "attention")
    serve.main(["--arch", "granite-4.0-h-small", "--device", "cpu",
                "--batch", "2", "--prompt-len", "16", "--gen", "3",
                "--tp", "2", "--devices", "2"])
    assert "granite-4.0-h-small" in capsys.readouterr().out
