"""Programs put in the place of the port's prefill in the Granite cell,
for the checks that the comparison deciding `correct` fails where it
must: the control (the plain reference with every product's operands
rounded through float8_e4m3fn, a precision below the configuration's
bfloat16) and the timed path broken in each way the cell can be. Each is
a program factory `drivers/granite_prefill.py` takes as `program=
"granite_faults:<name>"`, with its own factory's signature `(cfg,
params, seed, device)`. Used by `test_perfbench_granite.py` and
`control.py`, never by a benchmark run.
"""
from __future__ import annotations

import contextlib

import bench_harness as H

ref = H.load_module("reference/granite.py")


def _driver():
    return H.load_module("drivers/granite_prefill.py")


class control:
    """The reference, every product's operands rounded through fp8, on
    the program's weights."""

    def __init__(self, cfg, params, seed, device):
        self.real = _driver().Program(cfg, params, seed, device)
        self.cfg, self.device = cfg, device
        self.chosen = None

    def __call__(self, tokens):
        r = self.real
        return ref.forward(r.layer_of, r.embed(), r.final_norm(),
                           tokens[0].to(self.device), self.cfg,
                           round_inputs=ref.fp8_round, chosen=self.chosen)

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


def _swap(obj, name, value):
    @contextlib.contextmanager
    def swapped():
        old = getattr(obj, name)
        setattr(obj, name, value)
        try:
            yield
        finally:
            setattr(obj, name, old)
    return swapped()


class no_alltoall(_Patched):
    """The engine's alltoall left out: each rank keeps its own buffer."""

    def patch(self):
        from repro_torch.core.engine import CollectiveEngine
        return _swap(CollectiveEngine, "alltoall",
                     lambda eng, x, axis, **k: x)


class no_shared(_Patched):
    """The shared expert left out (it is the cell's one dense SwiGLU)."""

    def patch(self):
        from repro_torch.models import mlp
        return _swap(mlp, "mlp_block", lambda p, x, cfg, ctx: x * 0)


class expert_altered(_Patched):
    """One expert's output altered: rank 0's first local expert's rows
    shifted by 1."""

    def patch(self):
        from repro_torch.models import mlp
        real = mlp.expert_ffn

        def altered(recv, w1, w3, w2):
            out = real(recv, w1, w3, w2)
            out.reshape((-1,) + tuple(out.shape[-3:]))[0, 0] += 1.0
            return out
        return _swap(mlp, "expert_ffn", altered)


class drops(_Patched):
    """A dispatch one slot short of the largest count: assignments
    drop."""

    def patch(self):
        from repro_torch.models import mlp
        real = mlp.count_capacity

        def short(*a):
            capacity, loads = real(*a)
            return max(1, capacity - 1), loads
        return _swap(mlp, "count_capacity", short)


class state_dropped(_Patched):
    """The first Mamba layer's SSM state not carried into the emitted
    cache."""

    def patch(self):
        return contextlib.nullcontext()

    def __call__(self, tokens):
        nxt, caches, logits = self.real(tokens)
        caches = list(caches)
        i = self.real.cache_names.index("state")
        caches[i] = caches[i].clone()
        caches[i][0] = 0
        return nxt, tuple(caches), logits
