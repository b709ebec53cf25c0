"""Fault model for the transport layer: fault plans, reliability tiers,
and the per-run transport state the simulator threads through a drain.

ACCL+ runs the same collectives over fabrics with very different
reliability contracts (best-effort UDP, retransmitting TCP, RDMA).  This
module reproduces that axis as data:

* :class:`FaultPlan` — a deterministic, seedable description of what the
  fabric does wrong: per-exchange segment drops (probabilistic or an
  explicit schedule), link flaps (a (src, dst) window of guaranteed
  loss), and ranks that die outright after exchange N.
* :class:`ReliabilityTier` — the protocol-side response: how many times
  a lost segment is retransmitted, with what (virtual) backoff, and the
  pricing surcharge honest `cost_terms` should carry for the tier.
* :class:`FaultyTransport` — the mutable per-run object the simulator
  consults at every wire crossing.  It owns the global exchange counter
  and the retry loop, and accumulates virtual retry/backoff time so the
  sequencer can enforce per-request timeouts without any wall-clock.

Everything here is deterministic: drop decisions hash ``(seed, exchange,
src, dst, attempt)`` through ``numpy``'s Philox-seeded generator, so the
same plan produces the same faults regardless of rank iteration order.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import telemetry

__all__ = [
    "TransportError", "TransportTimeout", "PeerFailedError",
    "ReliabilityTier", "TIERS", "FaultPlan", "FaultyTransport",
]


# ---------------------------------------------------------------------------
# Typed failures
# ---------------------------------------------------------------------------

class TransportError(RuntimeError):
    """Base class for typed transport failures (never a hang)."""


class TransportTimeout(TransportError):
    """A segment exhausted its retry budget (or a request its timeout)."""

    def __init__(self, msg, *, src=None, dst=None, exchange=None):
        super().__init__(msg)
        self.src, self.dst, self.exchange = src, dst, exchange


class PeerFailedError(TransportError):
    """A peer rank died; the collective cannot complete as planned."""

    def __init__(self, msg, *, rank, exchange=None):
        super().__init__(msg)
        self.rank, self.exchange = rank, exchange


# ---------------------------------------------------------------------------
# Reliability tiers
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ReliabilityTier:
    """Protocol-side reliability contract, mirroring ACCL+'s fabric tiers.

    ``max_retries`` bounds retransmissions per segment; ``backoff_base``
    seconds double (``backoff_factor``) per attempt up to ``backoff_cap``.
    All time here is *virtual* — it feeds the priced makespan and the
    simulated per-request timeout, never a wall clock.
    """

    name: str
    max_retries: int
    backoff_base: float = 2e-6
    backoff_factor: float = 2.0
    backoff_cap: float = 1e-3

    def backoff(self, attempt: int) -> float:
        """Virtual seconds to wait before retry number ``attempt`` (1-based)."""
        if attempt <= 0:
            return 0.0
        return min(self.backoff_base * self.backoff_factor ** (attempt - 1),
                   self.backoff_cap)

    def backoff_schedule(self, n: int | None = None) -> tuple:
        """The deterministic backoff sequence for ``n`` retries."""
        n = self.max_retries if n is None else n
        return tuple(self.backoff(a) for a in range(1, n + 1))

    def expected_transmissions(self, drop_prob: float) -> float:
        """E[wire crossings per segment] under i.i.d. drop probability.

        Truncated geometric: with R retries allowed, the segment is sent
        ``1 + min(failures, R)`` times, so E = (1 - p^(R+1)) / (1 - p).
        """
        p = float(drop_prob)
        if p <= 0.0:
            return 1.0
        if p >= 1.0:
            return float(self.max_retries + 1)
        return (1.0 - p ** (self.max_retries + 1)) / (1.0 - p)

    def expected_backoff(self, drop_prob: float) -> float:
        """E[virtual backoff seconds per segment] under drop prob ``p``."""
        p = float(drop_prob)
        if p <= 0.0:
            return 0.0
        # Retry a happens iff the first a transmissions all dropped.
        return sum(self.backoff(a) * min(p, 1.0) ** a
                   for a in range(1, self.max_retries + 1))


#: Named tiers after the three ACCL+ fabric protocols.  ``udp-like`` is
#: fire-and-forget (one shot, loss is terminal); ``tcp-like`` retransmits
#: with exponential backoff; ``rdma-like`` assumes a lossless fabric with
#: a tight retry bound for the rare corrupt segment.
TIERS = {
    "udp-like": ReliabilityTier("udp-like", max_retries=0),
    "tcp-like": ReliabilityTier("tcp-like", max_retries=5,
                                backoff_base=2e-6, backoff_cap=1e-3),
    "rdma-like": ReliabilityTier("rdma-like", max_retries=2,
                                 backoff_base=1e-6, backoff_cap=1e-5),
}


# ---------------------------------------------------------------------------
# Fault plans
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FaultPlan:
    """Deterministic, seedable description of fabric misbehaviour.

    * ``drop_prob`` — i.i.d. probability that any (exchange, src, dst,
      attempt) wire crossing drops its segment.
    * ``drops`` — explicit schedule of ``(exchange, src, dst)`` first-
      attempt drops (retries of a scheduled drop go through, so a
      retrying tier always recovers from these).
    * ``flaps`` — ``(src, dst, start, end)`` windows (end exclusive, in
      global exchange numbers) during which the link loses everything.
    * ``dead`` — ``(rank, after_exchange)`` pairs: the rank fails after
      that many exchanges have completed and never speaks again.
    """

    seed: int = 0
    drop_prob: float = 0.0
    drops: frozenset = frozenset()
    flaps: tuple = ()
    dead: tuple = ()

    def dead_at(self, exchange: int):
        """Ranks that are dead once the global exchange counter is ``exchange``."""
        return frozenset(r for (r, after) in self.dead if exchange >= after)

    def link_flapped(self, src: int, dst: int, exchange: int) -> bool:
        return any(s == src and d == dst and start <= exchange < end
                   for (s, d, start, end) in self.flaps)

    def drops_segment(self, exchange: int, src: int, dst: int,
                      attempt: int) -> bool:
        """Deterministic drop decision for one wire crossing attempt.

        Keyed on the full coordinate so the outcome is independent of
        the order ranks are simulated in, and so retries re-roll.
        """
        if self.link_flapped(src, dst, exchange):
            return True
        if attempt == 0 and (exchange, src, dst) in self.drops:
            return True
        if self.drop_prob <= 0.0:
            return False
        rng = np.random.default_rng((self.seed, exchange, src, dst, attempt))
        return bool(rng.random() < self.drop_prob)


# ---------------------------------------------------------------------------
# Per-run transport state
# ---------------------------------------------------------------------------

@dataclass
class FaultyTransport:
    """Mutable transport state for one simulated drain.

    The simulator calls :meth:`deliver` once per (src, dst) pair at every
    exchange and :meth:`advance` once per exchange; this object applies
    the plan, runs the tier's retry loop, and accumulates virtual time.
    """

    plan: FaultPlan
    tier: ReliabilityTier = field(default_factory=lambda: TIERS["tcp-like"])
    exchange: int = 0
    retries: int = 0
    backoff_s: float = 0.0

    def check_rank(self, rank: int):
        """Raise :class:`PeerFailedError` if ``rank`` is dead right now."""
        if rank in self.plan.dead_at(self.exchange):
            raise PeerFailedError(
                f"rank {rank} dead at exchange {self.exchange}",
                rank=rank, exchange=self.exchange)

    def deliver(self, src: int, dst: int) -> None:
        """Decide the fate of one segment crossing src→dst.

        Returns normally iff the segment (eventually) arrives intact —
        the caller then writes the *original* payload, which is what
        makes retried runs bitwise-identical to fault-free ones.  Raises
        a typed error otherwise, before any buffer is written.
        """
        dead = self.plan.dead_at(self.exchange)
        for rank in (src, dst):
            if rank in dead:
                raise PeerFailedError(
                    f"rank {rank} dead at exchange {self.exchange}",
                    rank=rank, exchange=self.exchange)
        for attempt in range(self.tier.max_retries + 1):
            if not self.plan.drops_segment(self.exchange, src, dst, attempt):
                if attempt:
                    back = sum(self.tier.backoff(a)
                               for a in range(1, attempt + 1))
                    self.retries += attempt
                    self.backoff_s += back
                    tr = telemetry.current()
                    if tr.enabled:
                        tr.instant("transport.retry", track="transport",
                                   src=src, dst=dst,
                                   exchange=self.exchange,
                                   retries=attempt, backoff_s=back,
                                   tier=self.tier.name)
                return
        back = sum(self.tier.backoff(a)
                   for a in range(1, self.tier.max_retries + 1))
        self.retries += self.tier.max_retries
        self.backoff_s += back
        tr = telemetry.current()
        if tr.enabled:
            tr.instant("transport.timeout", track="transport",
                       src=src, dst=dst, exchange=self.exchange,
                       retries=self.tier.max_retries, backoff_s=back,
                       tier=self.tier.name)
        raise TransportTimeout(
            f"segment {src}->{dst} lost after "
            f"{self.tier.max_retries + 1} attempts at exchange {self.exchange}",
            src=src, dst=dst, exchange=self.exchange)

    def advance(self) -> None:
        """Bump the global exchange counter (one call per exchange round)."""
        self.exchange += 1

    def penalty_s(self, alpha: float) -> float:
        """Virtual seconds added by retries so far: resent-alpha + backoff."""
        return self.retries * alpha + self.backoff_s
