"""PricingEnv — the one bundle of pricing parameters.

Before this module, pricing knobs were scattered per call site:
`Program.cost`/`cost_terms` took bare `(tier=, drop_prob=)` kwargs,
`Sequencer.makespan` additionally took `comm=`, and `Selector` threaded
`eager_max_bytes`/`lead_dim` through its own constructor and `choose`
arguments. A mesh-level composition (`core/mesh_cost.py`) prices MANY
queues under ONE set of assumptions, so those assumptions need a value
that can be passed around, compared, and defaulted — this frozen
dataclass.

Everywhere pricing happens now accepts `env=` (a `PricingEnv`):

    Program.cost(nbytes, comm, env=env)
    Program.cost_terms(nbytes, comm, env=env)
    Sequencer.makespan(axis, env=env)
    Selector.choose(collective, nbytes, comm, env=env)

The old bare kwargs survive as a thin deprecation shim (existing callers
keep working bitwise-identically), but mixing them with `env=` raises —
two sources of truth for the same knob would make sweeps unreadable. A
default `PricingEnv()` is bitwise-neutral: every consumer prices exactly
as if no env had been passed. New in-src callers must use `env=`; CI
greps for bare `tier=`/`drop_prob=` at pricing call sites.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class PricingEnv:
    """Frozen pricing assumptions, shared by every pricing surface.

    comm             communicator override (None = the caller's own /
                     the engine's fabric for the priced axis)
    tier             `faults.ReliabilityTier` for the retransmission
                     surcharge (None = fault-free, bitwise-neutral)
    drop_prob        per-segment loss rate the tier prices against
    eager_max_bytes  eager-protocol cap override for the selector
                     (None = the communicator's per-fabric cap, or the
                     selector's own constructor override)
    lead_dim         alltoall leading-dim the selector clamps segment
                     candidates on (None = flat element grid)
    """

    comm: object = None
    tier: object = None
    drop_prob: float = 0.0
    eager_max_bytes: Optional[float] = None
    lead_dim: Optional[int] = None

    def apply(self, comm, tier=None, drop_prob: float = 0.0):
        """Fold this env over a pricing call's positional `comm` and its
        deprecated bare kwargs -> (comm, tier, drop_prob). Mixing an env
        with non-default bare kwargs is a TypeError (one source of
        truth)."""
        if tier is not None or drop_prob:
            raise TypeError(
                "pass pricing parameters through env=PricingEnv(...) OR "
                "the deprecated bare tier=/drop_prob= kwargs, not both")
        return (self.comm if self.comm is not None else comm,
                self.tier, self.drop_prob)


def resolve_env(env: Optional[PricingEnv] = None, *, comm=None, tier=None,
                drop_prob: float = 0.0) -> PricingEnv:
    """The deprecation shim: fold a call's bare kwargs into a
    `PricingEnv` when no env was passed; reject a mix of both."""
    if env is None:
        return PricingEnv(comm=comm, tier=tier, drop_prob=drop_prob)
    if comm is not None or tier is not None or drop_prob:
        raise TypeError(
            "pass pricing parameters through env=PricingEnv(...) OR the "
            "deprecated bare comm=/tier=/drop_prob= kwargs, not both")
    return env
