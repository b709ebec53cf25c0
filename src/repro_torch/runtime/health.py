"""Health machinery: straggler detection + failure injection.

Port of `repro/runtime/health.py`, host-only and unchanged in behaviour.

On a real 1000-node fleet, stragglers (thermal throttling, failing HBM,
noisy neighbours) and hard failures dominate MTBF. The runtime pieces that
do not need real hardware to be real code:

  StragglerWatchdog  per-step wall-time EWMA + z-score detector; fires a
                     configurable mitigation callback (alert / rescale).
  FailureInjector    deterministic chaos hook used by the integration
                     tests: raises a simulated device failure at chosen
                     steps to exercise checkpoint-restart.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional


class SimulatedDeviceFailure(RuntimeError):
    pass


class RankFailure(RuntimeError):
    """A peer rank died mid-run (the grad-sync collective's PEER_FAILED
    surfaced to the trainer). Unlike SimulatedDeviceFailure — which is
    recovered by checkpoint-restart — a rank failure is recoverable
    WITHOUT a restore: the trainer shrinks the mesh to the survivors
    along `axis`, replans, and continues from in-memory state."""

    def __init__(self, msg, *, rank: int, axis: str = "data"):
        super().__init__(msg)
        self.rank = rank
        self.axis = axis
        #: (params, opt, step) attached by the trainer at the failure
        #: point so shrink-and-continue resumes without a checkpoint
        self.state = None


@dataclasses.dataclass
class StragglerWatchdog:
    """EWMA step-time monitor. z > threshold for `patience` consecutive
    steps => mitigation(step, z)."""

    alpha: float = 0.1
    threshold: float = 3.0
    patience: int = 3
    warmup: int = 5
    mitigation: Optional[Callable] = None

    _mean: float = 0.0
    _var: float = 0.0
    _n: int = 0
    _strikes: int = 0
    events: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> Optional[float]:
        """Feed one step duration; returns z-score if flagged."""
        self._n += 1
        if self._n <= self.warmup:
            # prime the EWMA
            self._mean = dt if self._n == 1 else \
                (1 - self.alpha) * self._mean + self.alpha * dt
            self._var = max(self._var, (dt - self._mean) ** 2)
            return None
        std = math.sqrt(self._var) if self._var > 0 else 1e-9
        z = (dt - self._mean) / std
        self._mean = (1 - self.alpha) * self._mean + self.alpha * dt
        self._var = (1 - self.alpha) * self._var \
            + self.alpha * (dt - self._mean) ** 2
        if z > self.threshold:
            self._strikes += 1
            if self._strikes >= self.patience:
                self.events.append((step, z))
                if self.mitigation:
                    self.mitigation(step, z)
                self._strikes = 0
                return z
        else:
            self._strikes = 0
        return None


@dataclasses.dataclass
class FailureInjector:
    """Raise SimulatedDeviceFailure at the given steps (once each).

    `rank_fail_at` additionally injects dead-RANK failures: (step, rank)
    pairs raise `RankFailure` at that step, once each — the chaos hook
    behind the trainer's shrink-and-continue path."""

    fail_at: tuple = ()
    rank_fail_at: tuple = ()
    axis: str = "data"
    fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise SimulatedDeviceFailure(
                f"injected chip failure at step {step}")
        for (s, rank) in self.rank_fail_at:
            if s == step and ("rank", s) not in self.fired:
                self.fired.add(("rank", s))
                raise RankFailure(
                    f"injected rank {rank} loss at step {step}",
                    rank=rank, axis=self.axis)


class Heartbeat:
    """Liveness file a cluster supervisor would watch (touch per step)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.last = 0.0

    def beat(self):
        self.last = time.time()
        if self.path:
            with open(self.path, "w") as f:
                f.write(str(self.last))
