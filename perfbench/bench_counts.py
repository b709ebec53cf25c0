"""Bytes and operations that the benchmark's work needs, from shapes alone.

A roofline share is the least time the card could take for a piece of
work over the time it took. These functions count what the work needs,
not what an implementation does: each input byte read once, each output
byte written once, each multiply-add as two operations. So a share reads
the same work whatever kernel computes it, and a kernel that reads again
or computes more than it must shows as a lower share. Frozen from the
counts behind the kernel table of `PERF.md` (K1's `bound ms`, K4's and
K5's at the DLRM shapes); sizes come from a configuration file.
"""
from __future__ import annotations

F32 = 4


def allreduce_least_bytes(ranks: int, elems: int, elem_bytes: int = F32) -> int:
    """An allreduce's least device traffic: every rank's input read once
    and every rank's result written once."""
    return 2 * ranks * elems * elem_bytes


def pairwise_combine_bytes(ranks: int, elems: int,
                           elem_bytes: int = F32) -> int:
    """The least traffic of an allreduce's pairwise combines (K1's work):
    summing `ranks` values takes ranks - 1 two-operand adds per element,
    each reading two operands and writing one result."""
    return 3 * (ranks - 1) * elems * elem_bytes


def dlrm_dims(cfg: dict) -> tuple:
    """The FC stack's widths, concat vector first."""
    return ((cfg["n_tables"] * cfg["emb_dim"],) + tuple(cfg["fc_dims"])
            + (cfg["out_dim"],))


def dlrm_flops_per_query(cfg: dict) -> int:
    """The DLRM's operations for one query: 2 K N for each FC layer
    (Table 2: 2 (3200 2048 + 2048 512 + 512 256 + 256 1) = 15.47 M)."""
    d = dlrm_dims(cfg)
    return sum(2 * a * b for a, b in zip(d, d[1:]))


def fc1_flops(cfg: dict, batch: int) -> int:
    """FC1's products for a batch: 2 B concat fc0."""
    d = dlrm_dims(cfg)
    return 2 * batch * d[0] * d[1]


def fc1_bytes(cfg: dict, batch: int, tp: int) -> int:
    """FC1's checkerboard product (K4) for a batch: the concat vector's
    slices read once (B x concat over the ranks), the weight read once
    (concat x fc0), every rank's partial product written once
    (tp x B x fc0)."""
    d = dlrm_dims(cfg)
    return F32 * (batch * d[0] + d[0] * d[1] + tp * batch * d[1])


def lookup_bytes(cfg: dict, batch: int, tp: int) -> int:
    """The sharded lookup (K5) for a batch: the ids read once (int32, B x
    T), each looked-up row read once (B x T x dim), and every rank's
    partial concat vector written once (tp x B x T dim: its own rows, and
    zeros where another rank holds the row)."""
    t, dim = cfg["n_tables"], cfg["emb_dim"]
    return 4 * batch * t + F32 * batch * t * dim + F32 * tp * batch * t * dim
