"""Programs put in the place of the port's prefill in the DeepSeek-V3
cell, for the checks that the comparison deciding `correct` fails where
it must: the control (the plain reference with every product's operands
rounded through float8_e4m3fn, a precision below the configuration's
bfloat16) and the timed path broken in each way the cell can be. Each is
a program factory `drivers/deepseek_prefill.py` takes as `program=
"deepseek_faults:<name>"`, with its own factory's signature `(cfg,
params, seed, device)`. Used by `test_perfbench_deepseek.py`,
`tests/test_torch_deepseek_v3.py` and `control.py`, never by a
benchmark run.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import bench_harness as H

ref = H.load_module("reference/deepseek_v3.py")
granite_faults = H.load_module("granite_faults.py")
_swap = granite_faults._swap


def _driver():
    return H.load_module("drivers/deepseek_prefill.py")


class control:
    """The reference, every product's operands rounded through fp8, on
    the program's weights."""

    def __init__(self, cfg, params, seed, device):
        self.real = _driver().Program(cfg, params, seed, device)
        self.cfg, self.device = cfg, device
        self.chosen = None

    def __call__(self, tokens):
        return _driver().reference(self.real, self.cfg,
                                   tokens[0].to(self.device),
                                   round_inputs=ref.fp8_round,
                                   chosen=self.chosen)

    def host(self, out):
        return out[0].argmax().cpu(), out[0].cpu()

    def answers(self, out):
        return out[0][0], out[1]

    def record(self, on: bool):
        """The experts it served, as the program's `record`."""
        if on:
            self.chosen = []
            return None
        got, self.chosen = self.chosen, None
        return got

    def __getattr__(self, name):       # the weights, dropped()
        return getattr(self.real, name)


class _Patched:
    """The program with `patch()` in force while it serves."""

    def __init__(self, cfg, params, seed, device):
        self.real = _driver().Program(cfg, params, seed, device)

    def __call__(self, tokens):
        with self.patch():
            return self.real(tokens)

    def __getattr__(self, name):
        return getattr(self.real, name)


class no_mscale(_Patched):
    """The softmax scale without YaRN's m^2: 1 / sqrt(192)."""

    def patch(self):
        from repro_torch.models import attention
        return _swap(attention, "mla_scale", lambda cfg: 1.0 / math.sqrt(
            cfg.qk_nope_head_dim + cfg.qk_rope_head_dim))


class bias_in_gates(_Patched):
    """The correction bias added into the gates, not only the
    selection."""

    def patch(self):
        from repro_torch.models import mlp
        real = mlp.group_top_k

        def biased(scores, bias, *a):
            return real(scores + bias.float(), None, *a)
        return _swap(mlp, "group_top_k", biased)


class no_yarn(_Patched):
    """The rotation at the plain frequencies, YaRN left out."""

    def patch(self):
        from repro_torch.models import attention
        return _swap(attention, "mla_rope", lambda x, pos, cfg:
                     attention.rope(x, pos, cfg.rope_theta,
                                    interleave=True))


class no_alltoall(_Patched):
    """The engine's alltoall left out: each rank keeps its own buffer."""

    patch = granite_faults.no_alltoall.patch


class wrong_share(_Patched):
    """The layer told it holds the next node's experts (64-127) while it
    holds the weights of 0-63."""

    def __init__(self, cfg, params, seed, device):
        from repro_torch.configs.base import ParallelConfig
        from repro_torch.parallel import stages
        super().__init__(cfg, params, seed, device)
        r = self.real
        r.arch = dataclasses.replace(
            r.arch, expert_offset=r.arch.expert_offset + r.arch.n_experts)
        r.fn, r.ctx, _, _ = stages.build_prefill(
            r.arch, ParallelConfig(), r.mesh, params["batch"],
            params["prompt_tokens"], device=r.device)

    def patch(self):
        return contextlib.nullcontext()


class drops(_Patched):
    """A dispatch one slot short of the largest count: assignments
    drop."""

    patch = granite_faults.drops.patch


class latent_dropped(_Patched):
    """The first layer's latent c_kv not carried into the emitted
    cache."""

    def patch(self):
        return contextlib.nullcontext()

    def __call__(self, tokens):
        nxt, caches, logits = self.real(tokens)
        caches = list(caches)
        i = self.real.cache_names.index("c_kv")
        caches[i] = caches[i].clone()
        caches[i][0] = 0
        return nxt, tuple(caches), logits
