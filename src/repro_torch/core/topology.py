"""Mesh topology: the TPU analogue of ACCL+'s communicator.

ACCL+ builds a `communicator` (rank list + session/queue-pair table held in
CCLO configuration memory). On TPU, the communicator is a named mesh axis.
This module owns:

  * the production mesh axes ("pod", "data", "model"),
  * rank-neighbour maps for schedule generation (rings, trees, hypercubes),
  * the physical-cost view of an axis (ICI vs DCN) used by the selector.

Schedule generators (core/algorithms.py) are expressed over a `Communicator`,
which knows only rank count and hop costs — exactly the information the
ACCL+ uC firmware reads from configuration memory.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from repro_torch.core.hw_spec import HwSpec, TPU_V5E


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> dict:
    """The port's mesh: `{axis: size}` in the order the stacked tensors'
    leading dims follow (the reference builds a `jax.sharding.Mesh` of
    the same shape and axis names)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} does not name axes {axes}")
    return dict(zip(axes, shape))


@dataclasses.dataclass(frozen=True)
class Communicator:
    """Rank group over one mesh axis (ACCL+ communicator analogue).

    `axis` is the shard_map axis name collectives run over; `size` its rank
    count. `is_dcn` marks pod-crossing axes (slower links) for the cost
    model. Hardware constants ride along so the selector can price
    schedules without global state.

    `ranks` is the rank-id table (ACCL+ keeps exactly this list in CCLO
    configuration memory): local rank i is global rank `ranks[i]`. The
    default `None` means the identity mapping `0..size-1` — every
    pre-degradation communicator, so hashes/cache keys are unchanged.
    A degraded communicator built by `without_ranks` carries the
    surviving global ids, which need NOT be a prefix: survivor i keeps
    its global shard `ranks[i]` however mid-mesh the failure was.
    """

    axis: str
    size: int
    is_dcn: bool = False
    hw: HwSpec = TPU_V5E
    ranks: Optional[tuple] = None

    def __post_init__(self):
        if self.ranks is not None and len(self.ranks) != self.size:
            raise ValueError(
                f"rank table {self.ranks} does not match size {self.size}")

    @property
    def global_ranks(self) -> tuple:
        """Local -> global rank-id mapping (identity when undegraded)."""
        return self.ranks if self.ranks is not None \
            else tuple(range(self.size))

    @property
    def link_bw(self) -> float:
        return self.hw.dcn_bw if self.is_dcn else self.hw.ici_link_bw

    @property
    def hop_latency(self) -> float:
        return self.hw.dcn_hop_latency if self.is_dcn else self.hw.ici_hop_latency

    @property
    def min_segment_bytes(self) -> float:
        """Per-fabric Rx-buffer floor for wire segmentation: the 10 us DCN
        alpha prices a far larger segment optimum than the ICI one."""
        return (self.hw.dcn_min_segment_bytes if self.is_dcn
                else self.hw.ici_min_segment_bytes)

    @property
    def eager_max_bytes(self) -> float:
        """Per-fabric eager-protocol cutoff (Rx staging-pool capacity)."""
        return (self.hw.dcn_eager_max_bytes if self.is_dcn
                else self.hw.ici_eager_max_bytes)

    def level_comm(self, level) -> "Communicator":
        """The communicator that prices exchanges tagged `level`.

        A flat communicator has one fabric, so every level resolves to
        itself; `ProductComm` overrides this to route "intra" exchanges to
        the inner (ICI) communicator and "inter" ones to the outer (DCN)
        communicator. `Program._cost_walk` calls this per exchange.
        """
        return self

    # -- neighbour maps used by schedule generators ------------------------
    def ring_perm(self, step: int = 1) -> list[tuple[int, int]]:
        """src->dst pairs rotating by `step` (bidirectional rings use ±1)."""
        n = self.size
        return [(i, (i + step) % n) for i in range(n)]

    def hypercube_perm(self, dim: int) -> list[tuple[int, int]]:
        """Pairwise exchange partners at hypercube dimension `dim`."""
        n = self.size
        if n & (n - 1):
            raise ValueError(f"hypercube needs power-of-two ranks, got {n}")
        return [(i, i ^ (1 << dim)) for i in range(n)]

    def tree_rounds(self, root: int = 0) -> list[list[tuple[int, int]]]:
        """Binomial-tree rounds of (src, dst) for broadcast from `root`.

        Round k doubles the informed set: ranks with id < 2^k (relative to
        root) send to id + 2^k. log2(n) rounds, n need not be a power of 2.
        """
        n = self.size
        rounds: list[list[tuple[int, int]]] = []
        informed = 1
        while informed < n:
            pairs = []
            for i in range(min(informed, n - informed)):
                src = (root + i) % n
                dst = (root + i + informed) % n
                pairs.append((src, dst))
            rounds.append(pairs)
            informed *= 2
        return rounds

    @property
    def log2_size(self) -> int:
        return int(math.log2(self.size))

    @property
    def is_pow2(self) -> bool:
        return self.size & (self.size - 1) == 0

    # -- graceful degradation ----------------------------------------------
    def shrunk(self, size: int) -> "Communicator":
        """The degraded communicator after ranks died, keyed by survivor
        COUNT: same axis and fabric, the first `size` entries of the
        rank table kept (ACCL+ rebuilds the communicator's rank table
        in configuration memory). For dead ranks identified by id —
        including mid-mesh, non-prefix failures — use `without_ranks`,
        which keeps every survivor's global id so its data shard stays
        addressable."""
        if not 1 <= int(size) <= self.size:
            raise ValueError(
                f"cannot shrink {self.size}-rank communicator to {size}")
        ranks = None if self.ranks is None else self.ranks[:int(size)]
        return dataclasses.replace(self, size=int(size), ranks=ranks)

    def without_ranks(self, dead) -> "Communicator":
        """The degraded communicator with the CURRENT-local ranks `dead`
        removed: survivors renumber to 0..n-1 but keep their global ids
        in `ranks`, so non-contiguous survivors keep their data shards."""
        dead = {int(r) for r in dead}
        bad = dead - set(range(self.size))
        if bad:
            raise ValueError(f"ranks {sorted(bad)} not in communicator")
        survivors = tuple(g for i, g in enumerate(self.global_ranks)
                          if i not in dead)
        if not survivors:
            raise ValueError("cannot remove every rank")
        return dataclasses.replace(self, size=len(survivors),
                                   ranks=survivors)

    # -- hierarchical factoring --------------------------------------------
    def factor(self, pod_size: int) -> "ProductComm":
        """Factor a flat communicator into a (pod x intra-pod) product.

        The outer level keeps this communicator's fabric (typically DCN)
        at `pod_size` ranks; the inner level is the remaining ICI group.
        Flat rank r maps inner-major: r = intra_rank * pod_size + pod_rank,
        so contiguous chunk ranges stay contiguous at both levels.
        """
        pod_size = int(pod_size)
        if pod_size < 1 or self.size % pod_size:
            raise ValueError(
                f"cannot factor {self.size} ranks into pods of {pod_size}")
        outer = dataclasses.replace(self, size=pod_size, ranks=None)
        inner = Communicator(
            axis=self.axis, size=self.size // pod_size,
            is_dcn=False, hw=self.hw,
        )
        return ProductComm(outer=outer, inner=inner)


@dataclasses.dataclass(frozen=True)
class ProductComm:
    """A two-level (outer x inner) product communicator.

    `outer` is the slow pod-crossing level (usually DCN), `inner` the
    fast intra-pod level (ICI). Flat rank numbering is inner-major:

        r = intra_rank * P + pod_rank      (P = outer.size)

    so every contiguous coarse chunk [i*P, (i+1)*P) belongs to intra
    rank i's pod-local shard. Delegating scalar properties report the
    outer (bottleneck) fabric so flat candidates priced over this comm
    see the slow link; `level_comm` routes per-exchange pricing to the
    correct level.
    """

    outer: Communicator
    inner: Communicator

    @property
    def size(self) -> int:
        return self.outer.size * self.inner.size

    @property
    def axis(self) -> str:
        return self.outer.axis

    @property
    def hw(self) -> HwSpec:
        return self.outer.hw

    # Bottleneck view: a flat algorithm over the product group crosses
    # the pod boundary, so price its links on the outer fabric.
    @property
    def is_dcn(self) -> bool:
        return self.outer.is_dcn

    @property
    def link_bw(self) -> float:
        return self.outer.link_bw

    @property
    def hop_latency(self) -> float:
        return self.outer.hop_latency

    @property
    def min_segment_bytes(self) -> float:
        return self.outer.min_segment_bytes

    @property
    def eager_max_bytes(self) -> float:
        return self.outer.eager_max_bytes

    @property
    def flat(self) -> Communicator:
        """The equivalent single-level communicator (bottleneck fabric)."""
        return Communicator(
            axis=self.outer.axis, size=self.size,
            is_dcn=self.outer.is_dcn, hw=self.outer.hw,
        )

    def level_comm(self, level) -> Communicator:
        if level == "intra":
            return self.inner
        if level == "inter":
            return self.outer
        return self.flat

    @property
    def is_pow2(self) -> bool:
        return self.size & (self.size - 1) == 0


def axis_comm(mesh, axis: str, hw: HwSpec = TPU_V5E) -> Communicator:
    """Build a Communicator for one axis of a mesh shape.

    `mesh` is a plain `{axis: size}` mapping (the engine's `mesh_shape`).

    The axis→fabric map lives in `HwSpec.dcn_axes` (default: "pod"), so
    renamed or multiple pod-crossing axes price on DCN without editing
    this function.
    """
    return Communicator(
        axis=axis,
        size=mesh[axis],
        is_dcn=(axis in hw.dcn_axes),
        hw=hw,
    )


def product_comm(mesh, outer_axis: str, inner_axis: str,
                 hw: HwSpec = TPU_V5E) -> ProductComm:
    """Product communicator over two mesh axes (outer = pod-crossing);
    `mesh` is a plain `{axis: size}` mapping."""
    return ProductComm(
        outer=axis_comm(mesh, outer_axis, hw),
        inner=axis_comm(mesh, inner_axis, hw),
    )


@dataclasses.dataclass(frozen=True)
class FabricOccupancy:
    """The per-chip physical-link capacity map for mesh-level pricing.

    `Program.cost_terms(per_link=True)` attributes each program's wire
    seconds to link keys `("ici"|"dcn", axis)` — the fabric and mesh
    axis its bytes cross. This model says which of those keys name the
    SAME physical resource, so `core/mesh_cost.py` can serialize wire
    time across queues that share a link while leaving disjoint fabrics
    independent:

      * ICI: each mesh axis rides its own torus direction (a chip has
        `hw.ici_links_per_chip` ports), so `("ici", "data")` and
        `("ici", "model")` are distinct links — queues on different ICI
        axes overlap.
      * DCN: every pod-crossing axis funnels through the chip's ONE
        shared uplink, so all `("dcn", *)` keys canonicalize to
        `DCN_UPLINK` — any two DCN queues contend.
    """

    hw: HwSpec = TPU_V5E

    DCN_UPLINK = ("dcn", "uplink")

    def link_key(self, comm) -> tuple:
        """The link a (flat) communicator's wire bytes occupy."""
        return self.canonical(
            ("dcn" if comm.is_dcn else "ici", comm.axis))

    def canonical(self, key: tuple) -> tuple:
        """Collapse link keys naming one physical resource: every DCN
        key is the shared uplink; ICI keys stay per-axis directions."""
        return self.DCN_UPLINK if key[0] == "dcn" else key

    def capacity(self, key: tuple) -> float:
        """Bytes/s the physical link behind `key` can carry."""
        return (self.hw.dcn_bw if key[0] == "dcn"
                else self.hw.ici_link_bw)

    def ports(self) -> dict:
        """Per-chip port counts by fabric (ICI torus directions + the
        DCN uplink)."""
        return {"ici": self.hw.ici_links_per_chip, "dcn": 1}
