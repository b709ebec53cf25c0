"""Two-level hierarchical lowerings — cross-fabric compositions in the IR.

The HwSpec prices ICI and DCN separately, but a flat algorithm over a
(pod x intra-pod) product group puts the FULL message on the slow
pod-crossing fabric. The ACCL+ position — and the headline of
"Optimizing Communication for Latency Sensitive HPC Applications on up
to 48 FPGAs Using ACCL" — is that the collective engine should compose
per-fabric primitives instead. This module does exactly that: it reuses
the existing per-level schedule generators (core/algorithms.py) and
rewrites them into ONE flat-rank `Schedule` whose steps alternate
levels, e.g. for allreduce:

  1. reduce-scatter WITHIN each pod on ICI       (level="intra")
  2. allreduce of the 1/ici_size shard ACROSS
     pods on DCN                                 (level="inter")
  3. allgather within each pod on ICI            (level="intra")

so the DCN carries exactly 1/ici_size of the bytes. The composed
schedule compiles through the ordinary `compile_schedule` pipeline;
each Send is tagged with its level, so `Program.cost` prices every
exchange on its own fabric (`Communicator.level_comm`) and the engine
ppermutes each level's permutation on that level's own mesh axis.

Rank mapping (inner-major): with P = outer(pod) size and M =
inner(intra) size, flat rank

    r = intra_rank * P + pod_rank     intra_rank = r // P   (which slot)
                                      pod_rank   = r % P    (which pod)

Pod p is the stride-P rank set {i*P + p : i in range(M)}; the inter
group at intra slot i is the contiguous block [i*P, (i+1)*P) — the P
peers holding the same intra slot, one per pod. Inner-major numbering
makes every region contiguous:
the buffer is cut into M*C fine chunks (C = the inter schedule's chunk
count), coarse chunk i = fine range [i*C, (i+1)*C) is intra rank i's
pod-local shard, and the inter phase runs entirely inside that range.
For reduce-scatter with C = P this lands rank r exactly on fine chunk
r — the canonical flat shard layout.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core import algorithms
from repro_torch.core.schedule import (
    SEL_ALL, SEL_CHUNK, SEL_RANGE, Schedule, Sel, Step,
)

# Inter-level (DCN) algorithm choices per collective; first entry is the
# default. Power-of-two-only families are filtered by the caller.
INTER_ALGOS = {
    "allreduce": ("ring", "recursive_doubling"),
    "reduce_scatter": ("ring", "recursive_halving"),
    "allgather": ("ring", "recursive_doubling"),
    "bcast": ("binomial_tree",),
}
INTER_POW2_ONLY = frozenset({"recursive_doubling", "recursive_halving"})
# Intra level is the bandwidth-optimal chunked ring (any rank count).
INTRA_ALGOS = ("ring",)

# The only level names a two-level program may carry; `Step.level` tags
# and `Schedule.level_sizes` entries outside this set are rejected here
# at composition time and by the static verifier (LV_ORPHAN_LEVEL) on
# every compiled program.
LEVELS = ("intra", "inter")


def hier_name(intra: str, inter: str) -> str:
    return f"hierarchical:{intra}+{inter}"


def parse_hier_name(name: str) -> Optional[tuple]:
    """"hierarchical:<intra>+<inter>" -> (intra, inter), else None."""
    if not name.startswith("hierarchical:"):
        return None
    body = name[len("hierarchical:"):]
    if "+" not in body:
        return None
    intra, inter = body.split("+", 1)
    return intra, inter


# --------------------------------------------------------------------------
# Level remapping: per-level schedules -> flat-rank steps
# --------------------------------------------------------------------------

def _wrap_intra_sel(sel: Sel, P: int, C: int, base: int) -> Sel:
    """Intra selector in coarse-chunk space -> fine-chunk space. The
    level rank is r // P; the level step is the global step minus the
    phase base. Coarse chunk c covers fine range [c*C, (c+1)*C)."""
    if sel.kind == SEL_ALL:
        return sel
    f = sel.fn
    if sel.kind == SEL_CHUNK:
        if C == 1:
            return Sel.chunk(lambda r, s, f=f: f(r // P, s - base))
        return Sel.range(lambda r, s, f=f: (f(r // P, s - base) * C, C))
    if sel.kind == SEL_RANGE:
        def g(r, s, f=f):
            off, length = f(r // P, s - base)
            return (off * C, length * C)
        return Sel.range(g)
    raise ValueError(f"cannot remap intra selector kind {sel.kind!r}")


def _wrap_inter_sel(sel: Sel, P: int, C: int, base: int) -> Sel:
    """Inter selector -> fine-chunk space. The level rank is r % P; the
    inter phase's whole buffer is this rank's coarse chunk, fine range
    [(r//P)*C, (r//P)*C + C)."""
    f = sel.fn
    if sel.kind == SEL_ALL:
        if C == 1:
            return Sel.chunk(lambda r, s: r // P)
        return Sel.range(lambda r, s: ((r // P) * C, C))
    if sel.kind == SEL_CHUNK:
        return Sel.chunk(lambda r, s, f=f: (r // P) * C + f(r % P, s - base))
    if sel.kind == SEL_RANGE:
        def g(r, s, f=f):
            off, length = f(r % P, s - base)
            return ((r // P) * C + off, length)
        return Sel.range(g)
    raise ValueError(f"cannot remap inter selector kind {sel.kind!r}")


def _expand_intra_perm(perm: tuple, P: int) -> tuple:
    """Level perm over intra ranks -> flat pairs, replicated per pod."""
    return tuple((s * P + p, d * P + p) for (s, d) in perm
                 for p in range(P))


def _expand_inter_perm(perm: tuple, P: int, M: int) -> tuple:
    """Level perm over pod ranks -> flat pairs, replicated per slot."""
    return tuple((i * P + s, i * P + d) for (s, d) in perm
                 for i in range(M))


def _remap_phase(steps: tuple, level: str, P: int, M: int, C: int,
                 base: int, frac_scale: float = 1.0) -> list:
    """Rewrite one per-level phase into flat-rank, fine-chunk steps.

    Wrapped selectors and expanded perms are shared by identity across
    the phase (memoized per source object), so uniform runs keep equal
    signatures and still coalesce into LOOP/STREAM micro-ops."""
    if level not in LEVELS:
        raise ValueError(f"unknown level {level!r}; must be one of {LEVELS}")
    wrap_sel = _wrap_intra_sel if level == "intra" else _wrap_inter_sel
    sel_memo: dict = {}
    perm_memo: dict = {}
    out = []
    for step in steps:
        if step.level is not None:
            raise ValueError("cannot nest hierarchical schedules")
        key = id(step.send_sel)
        if key not in sel_memo:
            sel_memo[key] = wrap_sel(step.send_sel, P, C, base)
        send_sel = sel_memo[key]
        key = id(step.recv_sel)
        if key not in sel_memo:
            sel_memo[key] = wrap_sel(step.recv_sel, P, C, base)
        recv_sel = sel_memo[key]
        if step.perm not in perm_memo:
            perm_memo[step.perm] = (
                _expand_intra_perm(step.perm, P) if level == "intra"
                else _expand_inter_perm(step.perm, P, M))
        out.append(Step(
            perm=perm_memo[step.perm], op=step.op,
            send_sel=send_sel, recv_sel=recv_sel,
            bytes_frac=step.bytes_frac * frac_scale,
            mask_recv=step.mask_recv, uniform=step.uniform,
            segmentable=step.segmentable,
            level=level, level_perm=step.perm,
        ))
    return out


def _levels(P: int, M: int) -> tuple:
    return (("inter", P), ("intra", M))


def _check_sizes(comm) -> tuple:
    P, M = comm.outer.size, comm.inner.size
    if P < 2 or M < 2:
        raise ValueError(
            f"hierarchical composition needs both levels >= 2 ranks, "
            f"got pod={P} intra={M} (use the flat algorithm)")
    return P, M


# --------------------------------------------------------------------------
# Compositions
# --------------------------------------------------------------------------

def hier_allreduce(comm, intra: str = "ring", inter: str = "ring",
                   op: str = "add") -> Schedule:
    """Intra RS (ICI) -> inter allreduce of the 1/M shard (DCN) ->
    intra AG (ICI). DCN bytes = inter algorithm's bytes on msg/M."""
    P, M = _check_sizes(comm)
    rs = algorithms.GENERATORS[("reduce_scatter", intra)](comm.inner, op=op)
    ar = algorithms.GENERATORS[("allreduce", inter)](comm.outer, op=op)
    ag = algorithms.GENERATORS[("allgather", intra)](comm.inner)
    C = ar.chunks
    n_rs, n_ar = len(rs.steps), len(ar.steps)
    steps = (
        _remap_phase(rs.steps, "intra", P, M, C, base=0)
        + _remap_phase(ar.steps, "inter", P, M, C, base=n_rs,
                       frac_scale=1.0 / M)
        + _remap_phase(ag.steps, "intra", P, M, C, base=n_rs + n_ar)
    )
    return Schedule(
        name=hier_name(intra, inter), collective="allreduce",
        nranks=P * M, steps=tuple(steps), chunks=M * C, result="full",
        level_sizes=_levels(P, M),
    )


def hier_reduce_scatter(comm, intra: str = "ring", inter: str = "ring",
                        op: str = "add") -> Schedule:
    """Intra RS (ICI) -> inter RS of the 1/M shard (DCN). With C = P
    inter chunks, rank r = i*P + p lands on fine chunk i*P + p = r —
    the canonical flat shard layout."""
    P, M = _check_sizes(comm)
    rs_i = algorithms.GENERATORS[("reduce_scatter", intra)](comm.inner,
                                                            op=op)
    rs_o = algorithms.GENERATORS[("reduce_scatter", inter)](comm.outer,
                                                            op=op)
    C = rs_o.chunks
    inter_owned = rs_o.owned_chunk
    steps = (
        _remap_phase(rs_i.steps, "intra", P, M, C, base=0)
        + _remap_phase(rs_o.steps, "inter", P, M, C,
                       base=len(rs_i.steps), frac_scale=1.0 / M)
    )
    return Schedule(
        name=hier_name(intra, inter), collective="reduce_scatter",
        nranks=P * M, steps=tuple(steps), chunks=M * C, result="shard",
        owned_chunk=lambda r: (r // P) * C + inter_owned(r % P),
        level_sizes=_levels(P, M),
    )


def hier_allgather(comm, intra: str = "ring",
                   inter: str = "ring") -> Schedule:
    """Inter AG of each rank's shard (DCN, fills this slot's coarse
    chunk) -> intra AG of the coarse chunks (ICI). DCN carries each
    rank's 1/n shard P-1 hops instead of the whole buffer."""
    P, M = _check_sizes(comm)
    ag_o = algorithms.GENERATORS[("allgather", inter)](comm.outer)
    ag_i = algorithms.GENERATORS[("allgather", intra)](comm.inner)
    C = ag_o.chunks
    steps = (
        _remap_phase(ag_o.steps, "inter", P, M, C, base=0,
                     frac_scale=1.0 / M)
        + _remap_phase(ag_i.steps, "intra", P, M, C,
                       base=len(ag_o.steps))
    )
    return Schedule(
        name=hier_name(intra, inter), collective="allgather",
        nranks=P * M, steps=tuple(steps), chunks=M * C, result="full",
        level_sizes=_levels(P, M),
    )


def hier_bcast(comm, intra: str = "ring", inter: str = "binomial_tree",
               root: int = 0) -> Schedule:
    """Intra scatter in the root's pod (ICI) -> inter bcast of each
    coarse chunk across pods (DCN) -> intra allgather everywhere (ICI).

    The root keeps its full buffer; every other rank of the root's pod
    receives one coarse chunk, each inter group relays its chunk to all
    pods, and the closing intra allgather rebuilds the full buffer in
    every pod (ranks that already hold a chunk are overwritten with
    bitwise-identical data). DCN carries 1/M of the bytes per tree
    edge instead of the full message.

    The scatter runs in EVERY pod (level perms execute as one ppermute
    on the intra mesh axis, replicated across pods): pods other than
    the root's scatter stale data, which the inter bcast — whose every
    non-root rank receives — then overwrites. Deterministic on both
    executors, bitwise-equal to the flat oracle after the final
    allgather.
    """
    P, M = _check_sizes(comm)
    if root != 0:
        # The scatter below hands coarse chunk j to pod-mate j of the
        # root's pod; a non-zero root would need a rotated chunk->rank
        # map on every phase. The engine's selector path only requests
        # root=0 programs; other roots fall back to flat algorithms.
        raise ValueError("hierarchical bcast supports root=0 only")
    bc = algorithms.GENERATORS[("bcast", inter)](comm.outer, root=0)
    ag = algorithms.GENERATORS[("allgather", intra)](comm.inner)
    C = bc.chunks  # 1: the inter phase relays whole coarse chunks
    # Phase 1 — intra scatter: intra rank 0 sends coarse chunk j to
    # pod-mate j, j = 1..M-1 (in the root's pod that is the real
    # payload; elsewhere it is overwritten by phase 2).
    scatter = [
        Step(perm=_expand_intra_perm(((0, j),), P), op="copy",
             send_sel=Sel.chunk(lambda r, s, j=j: j),
             recv_sel=Sel.chunk(lambda r, s, j=j: j),
             bytes_frac=1.0 / M, mask_recv=True,
             level="intra", level_perm=((0, j),))
        for j in range(1, M)
    ]
    steps = scatter + _remap_phase(
        bc.steps, "inter", P, M, C, base=len(scatter),
        frac_scale=1.0 / M,
    ) + _remap_phase(
        ag.steps, "intra", P, M, C,
        base=len(scatter) + len(bc.steps),
    )
    return Schedule(
        name=hier_name(intra, inter), collective="bcast",
        nranks=P * M, steps=tuple(steps), chunks=M * C, result="full",
        level_sizes=_levels(P, M),
    )


_COMPOSERS = {
    "allreduce": hier_allreduce,
    "reduce_scatter": hier_reduce_scatter,
    "allgather": hier_allgather,
    "bcast": hier_bcast,
}


def hierarchical_schedule(collective: str, comm, intra: str = "ring",
                          inter: str = "ring", root: int = 0,
                          op: str = "add") -> Schedule:
    """Compose the two-level schedule for `collective` over a
    `ProductComm`. The uniform entry point the engine's generator
    lookup and the selector's candidate family both use."""
    composer = _COMPOSERS.get(collective)
    if composer is None:
        raise ValueError(
            f"no hierarchical composition for {collective!r}")
    if collective == "allreduce" or collective == "reduce_scatter":
        return composer(comm, intra=intra, inter=inter, op=op)
    if collective == "bcast":
        return composer(comm, intra=intra, inter=inter, root=root)
    return composer(comm, intra=intra, inter=inter)


def inter_candidates(collective: str, outer_size: int) -> tuple:
    """Inter-level algorithm names admissible at this pod count."""
    names = INTER_ALGOS.get(collective, ())
    pow2 = outer_size & (outer_size - 1) == 0
    return tuple(n for n in names
                 if pow2 or n not in INTER_POW2_ONLY)
