"""Hardware constants for the alpha-beta cost model (priced fabric).

ACCL+ evaluates on Alveo-U55C + 100 Gb/s Ethernet; the reference package
prices a TPU v5e pod slice. These constants model the PRICED FABRIC the
selector compares algorithms on (core/selector.py) — they do not describe
the card the port runs on. `TPU_V5E` stays the default so the port's
selector picks and prices equal the reference's; no spec of the port's
own card is added until a measurement backs one.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HwSpec:
    """Per-chip hardware description."""

    name: str = "tpu-v5e"
    # Compute.
    peak_flops_bf16: float = 197e12  # FLOP/s per chip
    peak_flops_int8: float = 394e12
    # Memory.
    hbm_bytes: float = 16e9         # capacity per chip
    hbm_bw: float = 819e9           # bytes/s per chip
    vmem_bytes: float = 128 * 2**20  # ~128 MiB VMEM per chip
    # Interconnect.
    ici_link_bw: float = 50e9       # bytes/s per ICI link (per direction)
    ici_links_per_chip: int = 4     # 2-D torus: +x, -x, +y, -y
    dcn_bw: float = 25e9            # bytes/s per chip, pod-to-pod (data center network)
    # Latency terms (alpha in the alpha-beta model), seconds.
    ici_hop_latency: float = 1e-6   # per-hop ICI latency
    dcn_hop_latency: float = 10e-6  # pod-to-pod latency
    # Wire-segmentation floors (Rx-buffer minimums): never cut a step's
    # payload below this many bytes per segment. The DCN floor is much
    # higher than the ICI one because the 10 us pod-to-pod alpha makes
    # tiny segments pure latency (alpha*bw is 250 KB on DCN vs 50 KB on
    # ICI), so the pod axis prices a different segment optimum.
    ici_min_segment_bytes: float = 8 * 1024
    dcn_min_segment_bytes: float = 256 * 1024
    # Eager-protocol modeled staging-copy bandwidth (HBM copy at receiver).
    eager_copy_bw: float = 819e9
    # Eager-protocol cutoffs: the Rx staging pool is per-fabric, and the
    # DCN pool is provisioned smaller (more peers share it), so a DCN
    # communicator rejects eager at sizes the ICI one still accepts.
    ici_eager_max_bytes: float = 64 * 1024
    dcn_eager_max_bytes: float = 32 * 1024
    # Mesh axes that cross the pod boundary (priced on DCN). Renamed or
    # additional DCN axes belong here rather than in string compares.
    dcn_axes: tuple = ("pod",)
    # Rendezvous handshake: one extra round trip before payload.
    rendezvous_rtt: float = 2e-6

    # MXU native tile (for kernel block alignment checks).
    mxu_dim: int = 128
    vpu_lanes: int = 8 * 128


# The paper's cluster, for benchmark parity tables: 100 Gb/s = 12.5 GB/s.
ACCL_CLUSTER = HwSpec(
    name="alveo-u55c-100gbe",
    peak_flops_bf16=30e12,
    hbm_bytes=16e9,
    hbm_bw=460e9,
    ici_link_bw=12.5e9,
    ici_links_per_chip=1,
    dcn_bw=12.5e9,
    ici_hop_latency=2e-6,
    dcn_hop_latency=2e-6,
)

TPU_V5E = HwSpec()


def bytes_of(shape, dtype_bytes: int) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n * dtype_bytes
