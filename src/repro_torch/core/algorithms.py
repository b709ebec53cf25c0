"""Collective algorithm library — schedule generators (the uC firmware).

Paper Table 1 algorithms, plus beyond-paper ones (Bruck all-to-all,
bidirectional ring, recursive halving) marked [+]:

  collective      eager (small msg)       rendezvous (large msg)
  --------------  ----------------------  --------------------------------
  bcast           one-to-all              binomial tree (recursive doubling)
  reduce          ring (unchunked relay)  all-to-one; binomial tree
  gather          ring                    all-to-one; binomial tree
  all-to-all      linear                  linear; [+] Bruck
  allreduce       recursive doubling      ring RS+AG; [+] bidirectional ring
  reduce-scatter  —                       ring; [+] recursive halving
  allgather       ring                    [+] recursive doubling

Every generator returns a `Schedule` (core/schedule.py) — pure data plus
rank-index closures. Nothing here touches jax; the engine interprets the
schedule, the simulator executes it in numpy, the selector prices it.
"""
from __future__ import annotations

import math

from repro_torch.core.schedule import Schedule, Sel, Step
from repro_torch.core.topology import Communicator


def _log2(n: int) -> int:
    k = int(math.log2(n))
    if (1 << k) != n:
        raise ValueError(f"power-of-two rank count required, got {n}")
    return k


# --------------------------------------------------------------------------
# Ring family (bandwidth-optimal chunked rings; paper's workhorse)
# --------------------------------------------------------------------------

def ring_reduce_scatter(comm: Communicator, op: str = "add") -> Schedule:
    """Chunked ring: n-1 steps, each moving 1/n of the buffer.

    Canonical layout (matches lax.psum_scatter tiled): after the schedule,
    rank r owns fully-reduced chunk r. Chunk c starts its journey at rank
    c+1 and lands at rank c after n-1 hops.

    The selector closures are shared across steps and pure in the step
    index (uniform=True), so the IR compiler rolls the whole ring into
    one LOOP micro-op — a single lax.scan with one live buffer.
    """
    n = comm.size
    perm = tuple(comm.ring_perm(1))
    send = Sel.chunk(lambda r, s: (r - s - 1) % n)
    recv = Sel.chunk(lambda r, s: (r - s - 2) % n)
    steps = tuple(
        Step(perm=perm, op=op, send_sel=send, recv_sel=recv,
             bytes_frac=1.0 / n, uniform=True)
        for _ in range(n - 1)
    )
    return Schedule(
        name="ring", collective="reduce_scatter", nranks=n, steps=steps,
        chunks=n, result="shard", owned_chunk=lambda r: r,
    )


def ring_allgather(comm: Communicator, own_shift: int = 0,
                   step_offset: int = 0) -> Schedule:
    """Chunked ring allgather; rank r initially owns chunk (r+own_shift)%n.

    `step_offset` is the global step index of this phase's first step when
    the steps are embedded in a composite schedule (ring allreduce): the
    shared uniform closures subtract it from the step index they receive.
    """
    n = comm.size
    perm = tuple(comm.ring_perm(1))
    send = Sel.chunk(
        lambda r, s, off=step_offset: (r + own_shift - (s - off)) % n)
    recv = Sel.chunk(
        lambda r, s, off=step_offset: (r + own_shift - 1 - (s - off)) % n)
    steps = tuple(
        Step(perm=perm, op="copy", send_sel=send, recv_sel=recv,
             bytes_frac=1.0 / n, uniform=True)
        for _ in range(n - 1)
    )
    return Schedule(
        name="ring", collective="allgather", nranks=n, steps=steps,
        chunks=n, result="full",
    )


def ring_allreduce(comm: Communicator, op: str = "add") -> Schedule:
    """Bandwidth-optimal ring allreduce: RS then AG, 2(n-1) steps."""
    n = comm.size
    rs = ring_reduce_scatter(comm, op)
    ag = ring_allgather(comm, own_shift=0, step_offset=n - 1)
    return Schedule(
        name="ring", collective="allreduce", nranks=n,
        steps=rs.steps + ag.steps, chunks=n, result="full",
    )


def bidi_ring_allreduce(comm: Communicator, op: str = "add") -> Schedule:
    """[+] Bidirectional ring: halves travel opposite directions (2 ICI links).

    Chunk space 2n: chunks [0, n) ride the clockwise ring, [n, 2n) the
    counter-clockwise ring. Steps alternate cw/ccw so XLA can schedule the
    two independent permutes concurrently; the cost model credits
    overlap_factor=2.
    """
    n = comm.size
    cw, ccw = tuple(comm.ring_perm(1)), tuple(comm.ring_perm(-1))
    # Steps interleave cw/ccw, so phase index = step_index // 2 (works for
    # both slots: global index 2s and 2s+1 floor-divide to s). Closures
    # are shared per direction and pure in (rank, step), so the compiler
    # coalesces each phase into one period-2 LOOP whose two slots write
    # disjoint chunk halves ([0, n) cw, [n, 2n) ccw) — XLA schedules the
    # two permutes on both ICI directions concurrently.
    rs_cw_send = Sel.chunk(lambda r, g: (r - g // 2 - 1) % n)
    rs_cw_recv = Sel.chunk(lambda r, g: (r - g // 2 - 2) % n)
    rs_ccw_send = Sel.chunk(lambda r, g: n + (r + g // 2 + 1) % n)
    rs_ccw_recv = Sel.chunk(lambda r, g: n + (r + g // 2 + 2) % n)
    ag_base = 2 * (n - 1)
    ag_cw_send = Sel.chunk(lambda r, g: (r - (g - ag_base) // 2) % n)
    ag_cw_recv = Sel.chunk(lambda r, g: (r - 1 - (g - ag_base) // 2) % n)
    ag_ccw_send = Sel.chunk(lambda r, g: n + (r + (g - ag_base) // 2) % n)
    ag_ccw_recv = Sel.chunk(
        lambda r, g: n + (r + 1 + (g - ag_base) // 2) % n)
    steps = []
    # reduce-scatter phase (canonical: rank r ends owning cw chunk r and
    # ccw chunk n + r, both fully reduced)
    for _ in range(n - 1):
        steps.append(Step(perm=cw, op=op, send_sel=rs_cw_send,
                          recv_sel=rs_cw_recv, bytes_frac=0.5 / n,
                          uniform=True))
        steps.append(Step(perm=ccw, op=op, send_sel=rs_ccw_send,
                          recv_sel=rs_ccw_recv, bytes_frac=0.5 / n,
                          uniform=True))
    # allgather phase (both halves owned at chunk r / n + r)
    for _ in range(n - 1):
        steps.append(Step(perm=cw, op="copy", send_sel=ag_cw_send,
                          recv_sel=ag_cw_recv, bytes_frac=0.5 / n,
                          uniform=True))
        steps.append(Step(perm=ccw, op="copy", send_sel=ag_ccw_send,
                          recv_sel=ag_ccw_recv, bytes_frac=0.5 / n,
                          uniform=True))
    return Schedule(
        name="bidi_ring", collective="allreduce", nranks=n,
        steps=tuple(steps), chunks=2 * n, result="full", overlap_factor=2.0,
    )


def ring_reduce(comm: Communicator, root: int = 0, op: str = "add") -> Schedule:
    """Eager ring reduce (paper Table 1): unchunked rotate-and-accumulate.

    Every rank relays what it received last step (not its accumulator), so
    after n-1 full-buffer rotations every rank — in particular the root —
    holds the complete reduction. relay='received'.
    """
    n = comm.size
    perm = tuple(comm.ring_perm(1))
    steps = tuple(
        Step(perm=perm, op=op, send_sel=Sel.all(), recv_sel=Sel.all(),
             bytes_frac=1.0, uniform=True)
        for _ in range(n - 1)
    )
    return Schedule(
        name="ring", collective="reduce", nranks=n, steps=steps,
        chunks=1, result="full", relay="received",
    )


def ring_gather(comm: Communicator, root: int = 0) -> Schedule:
    """Eager ring gather: chunks circulate until the root has all of them.

    Implemented as a full ring allgather (cost-identical; the paper's ring
    gather also moves every chunk n-1 hops); result marked 'root'.
    """
    g = ring_allgather(comm)
    return Schedule(
        name="ring", collective="gather", nranks=comm.size, steps=g.steps,
        chunks=comm.size, result="full",
    )


# --------------------------------------------------------------------------
# Hypercube family (log-step; paper's "recursive doubling" rendezvous algos)
# --------------------------------------------------------------------------

def recursive_doubling_allreduce(comm: Communicator, op: str = "add") -> Schedule:
    """log2(n) full-buffer pairwise exchanges; latency-optimal allreduce."""
    n = comm.size
    k = _log2(n)
    steps = tuple(
        Step(perm=tuple(comm.hypercube_perm(d)), op=op,
             send_sel=Sel.all(), recv_sel=Sel.all(), bytes_frac=1.0)
        for d in range(k)
    )
    return Schedule(
        name="recursive_doubling", collective="allreduce", nranks=n,
        steps=steps, chunks=1, result="full",
    )


def recursive_halving_reduce_scatter(comm: Communicator, op: str = "add") -> Schedule:
    """[+] log2(n) steps, halving the active range; rank r owns chunk r."""
    n = comm.size
    k = _log2(n)
    steps = []
    for j in range(k):
        d = n >> (j + 1)  # partner distance & half-size in chunks

        # Active range after j halvings starts at r & (n - n>>j) and has
        # length n >> j. Each step we keep the half selected by bit
        # log2(d) of r (send the other half, receive into the kept one).
        def send_range(r, s, d=d, j=j):
            off = r & (n - (n >> j))
            keep_upper = (r // d) % 2  # (r & d) != 0, written arithmetically
            return (off + (1 - keep_upper) * d, d)

        def recv_range(r, s, d=d, j=j):
            off = r & (n - (n >> j))
            keep_upper = (r // d) % 2
            return (off + keep_upper * d, d)

        steps.append(Step(
            perm=tuple(comm.hypercube_perm(int(math.log2(d)))),
            op=op,
            send_sel=Sel.range(send_range),
            recv_sel=Sel.range(recv_range),
            bytes_frac=d / n,
        ))
    return Schedule(
        name="recursive_halving", collective="reduce_scatter", nranks=n,
        steps=tuple(steps), chunks=n, result="shard",
        owned_chunk=lambda r: r,
    )


def recursive_doubling_allgather(comm: Communicator) -> Schedule:
    """[+] log2(n) steps, doubling the owned range; inverse of halving RS."""
    n = comm.size
    k = _log2(n)
    steps = []
    for j in range(k):
        d = 1 << j  # current owned length in chunks

        def send_range(r, s, d=d):
            return (r & ~(d - 1), d)

        def recv_range(r, s, d=d):
            return ((r ^ d) & ~(d - 1), d)

        steps.append(Step(
            perm=tuple(comm.hypercube_perm(j)),
            op="copy",
            send_sel=Sel.range(send_range),
            recv_sel=Sel.range(recv_range),
            bytes_frac=d / n,
        ))
    return Schedule(
        name="recursive_doubling", collective="allgather", nranks=n,
        steps=tuple(steps), chunks=n, result="full",
    )


def halving_doubling_allreduce(comm: Communicator, op: str = "add") -> Schedule:
    """[+] Rabenseifner: recursive-halving RS + recursive-doubling AG."""
    rs = recursive_halving_reduce_scatter(comm, op)
    ag = recursive_doubling_allgather(comm)
    return Schedule(
        name="halving_doubling", collective="allreduce", nranks=comm.size,
        steps=rs.steps + ag.steps, chunks=comm.size, result="full",
    )


# --------------------------------------------------------------------------
# Tree / star family (paper's bcast / reduce / gather algorithms)
# --------------------------------------------------------------------------

def binomial_tree_bcast(comm: Communicator, root: int = 0) -> Schedule:
    """Recursive-doubling broadcast: informed set doubles each round."""
    n = comm.size
    steps = tuple(
        Step(perm=tuple(pairs), op="copy", send_sel=Sel.all(),
             recv_sel=Sel.all(), bytes_frac=1.0, mask_recv=True)
        for pairs in comm.tree_rounds(root)
    )
    return Schedule(
        name="binomial_tree", collective="bcast", nranks=n, steps=steps,
        chunks=1, result="full",
    )


def one_to_all_bcast(comm: Communicator, root: int = 0) -> Schedule:
    """Eager linear broadcast: root sends to each rank in turn (n-1 steps)."""
    n = comm.size
    steps = tuple(
        Step(perm=((root, (root + i + 1) % n),), op="copy",
             send_sel=Sel.all(), recv_sel=Sel.all(), bytes_frac=1.0,
             mask_recv=True)
        for i in range(n - 1)
    )
    return Schedule(
        name="one_to_all", collective="bcast", nranks=n, steps=steps,
        chunks=1, result="full",
    )


def all_to_one_reduce(comm: Communicator, root: int = 0, op: str = "add") -> Schedule:
    """Rendezvous small-msg reduce: every rank sends straight to root.

    Serialized per-step single pairs model the paper's in-cast exposure.
    relay='original' — each rank wires its original contribution.
    """
    n = comm.size
    steps = tuple(
        Step(perm=(((root + i + 1) % n, root),), op=op,
             send_sel=Sel.all(), recv_sel=Sel.all(), bytes_frac=1.0,
             mask_recv=True)
        for i in range(n - 1)
    )
    return Schedule(
        name="all_to_one", collective="reduce", nranks=n, steps=steps,
        chunks=1, result="root", relay="original",
    )


def binomial_tree_reduce(comm: Communicator, root: int = 0, op: str = "add") -> Schedule:
    """Rendezvous large-msg reduce: binomial tree, leaves toward root."""
    n = comm.size
    rounds = comm.tree_rounds(root)
    steps = tuple(
        Step(perm=tuple((dst, src) for (src, dst) in pairs), op=op,
             send_sel=Sel.all(), recv_sel=Sel.all(), bytes_frac=1.0,
             mask_recv=True)
        for pairs in reversed(rounds)
    )
    return Schedule(
        name="binomial_tree", collective="reduce", nranks=n, steps=steps,
        chunks=1, result="root",
    )


def all_to_one_gather(comm: Communicator, root: int = 0) -> Schedule:
    """Each rank sends its chunk straight to the root (n-1 single pairs)."""
    n = comm.size
    steps = tuple(
        Step(perm=(((root + i + 1) % n, root),), op="copy",
             send_sel=Sel.chunk(lambda r, s: r),
             recv_sel=Sel.chunk(lambda r, s, i=i: (root + i + 1) % n),
             bytes_frac=1.0 / n, mask_recv=True)
        for i in range(n - 1)
    )
    return Schedule(
        name="all_to_one", collective="gather", nranks=n, steps=steps,
        chunks=n, result="root", relay="original",
    )


def binomial_tree_gather(comm: Communicator, root: int = 0) -> Schedule:
    """Binomial gather: owned ranges double as they climb toward the root.

    Chunk j (relative coordinates) holds rank (root+j)%n's data.
    """
    n = comm.size
    k = _log2(n)
    steps = []
    for j in range(k):
        d = 1 << j
        pairs = tuple(
            ((root + m * 2 * d + d) % n, (root + m * 2 * d) % n)
            for m in range(n // (2 * d))
        )

        def rng(r, s, d=d, root=root, n=n):
            # Sender rel has bit d set (rel | d == rel); receiver rel has it
            # clear (rel | d == rel + d). One branch-free formula covers both
            # so it traces cleanly on jax rank values.
            rel = (r - root) % n
            return (rel | d, d)

        steps.append(Step(
            perm=pairs, op="copy",
            send_sel=Sel.range(rng), recv_sel=Sel.range(rng),
            bytes_frac=d / n, mask_recv=True,
        ))
    return Schedule(
        name="binomial_tree", collective="gather", nranks=n,
        steps=tuple(steps), chunks=n, result="root", relay="buffer",
        chunk_coords="relative",
    )


# --------------------------------------------------------------------------
# All-to-all family
# --------------------------------------------------------------------------

def linear_alltoall(comm: Communicator) -> Schedule:
    """Paper's all-to-all: n-1 rotations, step s routes chunk (r+s)%n.

    Buffer convention: chunk j outbound = data for rank j; after the
    schedule chunk j holds data *from* rank j.

    Every step uses a different ring shift, so these steps can never
    coalesce into a LOOP micro-op. The compiler's stacked-receive
    peephole (`program.fuse_stacked_recv`) instead collapses the run
    into one STACKED_RECV: all n-1 permutes issue from the immutable
    original buffer and the arrivals land with a single chunk scatter,
    not n-1 full-buffer update-slices.
    """
    n = comm.size
    steps = tuple(
        Step(perm=tuple(comm.ring_perm(s)), op="copy",
             send_sel=Sel.chunk(lambda r, st, s=s: (r + s) % n),
             recv_sel=Sel.chunk(lambda r, st, s=s: (r - s) % n),
             bytes_frac=1.0 / n)
        for s in range(1, n)
    )
    return Schedule(
        name="linear", collective="alltoall", nranks=n, steps=steps,
        chunks=n, result="full", relay="original",
    )


def bruck_alltoall(comm: Communicator) -> Schedule:
    """[+] Bruck: log2(n) phases, each moving the chunks whose destination
    offset has bit k set, to rank r + 2^k. Needs pre-rotation (chunk j ->
    data for rank (r+j)%n) and post-rotation; the engine performs those as
    local rolls. Mask selectors are rank-independent (pure data).
    """
    n = comm.size
    k = _log2(n)
    steps = []
    for ph in range(k):
        d = 1 << ph
        mask = tuple(j for j in range(n) if j & d)

        def msel(r, s, mask=mask):
            return mask

        sel = Sel.mask(msel)
        steps.append(Step(
            perm=tuple(comm.ring_perm(d)), op="copy",
            # identical send/recv masks: the gathered payload segments on
            # the wire and scatters back (segmentable=True annotation)
            send_sel=sel, recv_sel=sel,
            bytes_frac=len(mask) / n, segmentable=True,
        ))
    return Schedule(
        name="bruck", collective="alltoall", nranks=n, steps=tuple(steps),
        chunks=n, result="full", pre_rotate="bruck", post_rotate="bruck",
    )


# --------------------------------------------------------------------------
# Registry (what the selector chooses from)
# --------------------------------------------------------------------------

GENERATORS = {
    ("allreduce", "ring"): ring_allreduce,
    ("allreduce", "bidi_ring"): bidi_ring_allreduce,
    ("allreduce", "recursive_doubling"): recursive_doubling_allreduce,
    ("allreduce", "halving_doubling"): halving_doubling_allreduce,
    ("reduce_scatter", "ring"): ring_reduce_scatter,
    ("reduce_scatter", "recursive_halving"): recursive_halving_reduce_scatter,
    ("allgather", "ring"): ring_allgather,
    ("allgather", "recursive_doubling"): recursive_doubling_allgather,
    ("bcast", "one_to_all"): one_to_all_bcast,
    ("bcast", "binomial_tree"): binomial_tree_bcast,
    ("reduce", "ring"): ring_reduce,
    ("reduce", "all_to_one"): all_to_one_reduce,
    ("reduce", "binomial_tree"): binomial_tree_reduce,
    ("gather", "ring"): ring_gather,
    ("gather", "all_to_one"): all_to_one_gather,
    ("gather", "binomial_tree"): binomial_tree_gather,
    ("alltoall", "linear"): linear_alltoall,
    ("alltoall", "bruck"): bruck_alltoall,
}
