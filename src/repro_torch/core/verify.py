"""Static verifier for compiled collective programs.

Every `Schedule.compile()` product is a linear micro-op `Program` that
three consumers trust blindly: the engine traces it, the simulator
executes it, the selector prices it. ACCL+'s extensibility story — new
collectives deploy through `plugins.register_collective` without
re-synthesizing anything — only holds if a malformed program is caught
*before* it deadlocks the fabric or silently corrupts a buffer ("up to
48 FPGAs" reports exactly that failure mode from mismatched send/recv
pairs). This module proves well-formedness statically, on the compiled
artifact, with typed rank/op-addressed diagnostics.

Passes (rule-id prefix → pass):

  ST_*  structural     every exchange is a well-shaped
                       load/[compress]/send/[decompress]/recv-combine
                       body; perms stay in-range and collision-free.
  XM_*  exchange       cross-rank matching: every SEND has its receive,
                       byte counts agree under segmentation and codec
                       (scale-block-consistent int8 wires).
  DL_*  deadlock       no rank waits on itself inside one bulk-
                       synchronous exchange; the Sequencer's request
                       DAG (deps + buffer-hazard edges, including
                       cross-axis `issue_multi` chains) is acyclic.
  LV_*  level          hierarchical consistency: `level` tags resolve
                       under `level_sizes`, level perms stay inside
                       their level's rank space and expand to exactly
                       the flat perm the simulator executes.
  DF_*  dataflow       per-rank symbolic buffer walk: no read-before-
                       write, no combine into an unwritten segment,
                       chunk-grid coverage per the collective's
                       postcondition, and STREAM/STREAM_CHAIN fusions
                       re-prove their reorder-safety regions.

Selector closures are pure (rank, step) arithmetic for every built-in;
the verifier evaluates them concretely, and — matching the fusion
passes' precedent — opts out of region-dependent checks (never errors)
when a user closure raises on plain ints. Structural, matching,
deadlock and level rules need no selector evaluation and are cheap
enough to run on every compile; the dataflow walk runs under
`verify="full"` (the registration probe, CI's verify lane, and
`REPRO_VERIFY=full`).

Verification levels: "off", "structural" (default on compile), "full".
"""
from __future__ import annotations

import math
from typing import Iterator, Optional

from repro_torch.core.program import (
    Copy, Compress, Decompress, Loop, Program, RecvCombine, SegLoop,
    Send, StackedRecv, Stream, StreamChain,
    SRC_ORIGINAL, SRC_RECEIVED,
    _chain_body_eligible, _regions_stream_safe, _stream_eligible,
    split_exchange,
)
from repro_torch.core.schedule import (
    COMBINE_OPS, SEL_ALL, SEL_CHUNK, SEL_MASK, SEL_RANGE, Sel,
)

VERIFY_LEVELS = ("off", "structural", "full")

# rule id -> (pass name, property proved). The README's rule table and
# the mutation tests in tests/test_verify.py are generated against this.
RULES = {
    "ST_BODY_SHAPE": (
        "structural",
        "exchange bodies are load/[compress]/send/[decompress]/"
        "recv-combine with a known combine op and paired codec stages"),
    "ST_PERM_RANGE": (
        "structural", "perm endpoints lie in [0, nranks)"),
    "ST_PERM_DUP": (
        "structural", "no rank appears twice as src or dst in one permute"),
    "ST_SEL_BOUNDS": (
        "dataflow", "selector results lie in [0, chunks) and are non-empty"),
    "XM_UNMATCHED_RECV": (
        "exchange",
        "unmasked exchanges deliver to every rank (no rank blocks on a "
        "receive that never arrives)"),
    "XM_DSTS_MISMATCH": (
        "exchange", "RECV_COMBINE.dsts equals the perm's destination set"),
    "XM_BYTES_MISMATCH": (
        "exchange", "send and receive regions agree in length per pair"),
    "XM_BYTES_FRAC": (
        "exchange", "Send.bytes_frac equals payload chunks / chunk grid"),
    "XM_SCALE_BLOCK": (
        "exchange",
        "compress/decompress codecs match across the wire and the "
        "program's declared codec (scale blocks land aligned)"),
    "DL_SELF_SEND": (
        "deadlock", "no rank sends to itself inside one exchange"),
    "DL_DEP_CYCLE": (
        "deadlock", "the Sequencer request DAG is acyclic"),
    "LV_ORPHAN_LEVEL": (
        "level",
        "level tags resolve under level_sizes (and flat programs carry "
        "no level perms)"),
    "LV_PERM_MISMATCH": (
        "level",
        "level perms stay inside their level's rank space and expand to "
        "exactly the flat perm"),
    "DF_READ_BEFORE_WRITE": (
        "dataflow", "payloads only read chunks already valid at the rank"),
    "DF_COMBINE_UNWRITTEN": (
        "dataflow", "non-copy combines only target valid chunks"),
    "DF_DOUBLE_WRITE": (
        "dataflow",
        "no two writes of one bulk-synchronous group collide; gather-"
        "family programs deliver each chunk exactly once"),
    "DF_COVERAGE": (
        "dataflow",
        "the chunk grid is covered per the collective's postcondition"),
    "DF_STREAM_UNSAFE": (
        "dataflow",
        "STREAM/STREAM_CHAIN fusions satisfy the region-overlap proof"),
}


class VerifyError(ValueError):
    """A verification failure, addressed to the offending op/rank/step."""

    def __init__(self, rule: str, message: str, *,
                 op_index: Optional[int] = None,
                 rank: Optional[int] = None,
                 step: Optional[int] = None):
        self.rule = rule
        self.op_index = op_index
        self.rank = rank
        self.step = step
        where = "".join(
            f" {k}={v}" for k, v in
            (("op", op_index), ("rank", rank), ("step", step))
            if v is not None)
        super().__init__(f"[{rule}]{where and ' at' + where}: {message}")


def _err(rule: str, message: str, **where) -> None:
    raise VerifyError(rule, message, **where)


# --------------------------------------------------------------------------
# IR walkers
# --------------------------------------------------------------------------

def _body_step(body: tuple) -> Optional[int]:
    head = body[0] if body else None
    return getattr(head, "step", None)


def _instance_groups(prog: Program) -> Iterator[tuple]:
    """Unrolled execution walk.

    Yields ("rot", op_index, kind) for Bruck rotations and
    ("group", op_index, [(step, body, k), ...]) for every bulk-
    synchronous write group — the unit whose reads all see the group-
    start buffer and whose writes land together (LOOP/STREAM iteration
    semantics, STACKED_RECV's one scatter). STREAM_CHAIN waves and
    plain unrolled exchanges are singleton groups in program order.
    """
    ops = prog.ops
    i, n_ops = 0, len(ops)
    while i < n_ops:
        op = ops[i]
        if isinstance(op, Copy) and op.kind in ("bruck_pre", "bruck_post"):
            yield ("rot", i, op.kind)
        elif isinstance(op, Loop):
            bodies = [split_exchange(slot) for slot in op.slots]
            for it in range(op.trip):
                yield ("group", i, [
                    (op.base + it * op.period + j, body, k)
                    for j, (body, k) in enumerate(bodies)])
        elif isinstance(op, Stream):
            for it in range(op.trip):
                yield ("group", i, [
                    (op.base + it * op.period + j, body, op.segments)
                    for j, body in enumerate(op.slots)])
        elif isinstance(op, StreamChain):
            for body in op.bodies:
                yield ("group", i, [(_body_step(body), body, op.segments)])
        elif isinstance(op, StackedRecv):
            yield ("group", i,
                   [(_body_step(b), b, 1) for b in op.bodies])
        elif isinstance(op, SegLoop):
            yield ("group", i,
                   [(_body_step(op.body), op.body, op.segments)])
        elif isinstance(op, Copy) and op.kind == "load":
            j = i
            while j < n_ops and not isinstance(ops[j], RecvCombine):
                j += 1
            if j >= n_ops:
                _err("ST_BODY_SHAPE",
                     "exchange run is not terminated by a RECV_COMBINE",
                     op_index=i)
            body = tuple(ops[i:j + 1])
            yield ("group", i, [(_body_step(body), body, 1)])
            i = j + 1
            continue
        else:
            _err("ST_BODY_SHAPE",
                 f"unexpected top-level micro-op {type(op).__name__}",
                 op_index=i)
        i += 1


def _unique_bodies(prog: Program) -> Iterator[tuple]:
    """(op_index, step, body, k) once per distinct exchange body — the
    walk for checks that need no per-iteration state (LOOP slots share
    one body tuple across all trips)."""
    seen: set = set()
    for kind, oi, payload in _instance_groups(prog):
        if kind != "group":
            continue
        for step, body, k in payload:
            if id(body) in seen:
                continue
            seen.add(id(body))
            yield oi, step, body, k


def _find(body: tuple, cls) -> Optional[object]:
    for op in body:
        if isinstance(op, cls):
            return op
    return None


def _parse_body(body: tuple, op_index: int) -> tuple:
    """Strict shape check; returns (load, send, recv, codec)."""
    if (not body or not isinstance(body[0], Copy)
            or body[0].kind != "load"
            or not isinstance(body[-1], RecvCombine)):
        _err("ST_BODY_SHAPE",
             "exchange body must start with COPY(load) and end with "
             "RECV_COMBINE", op_index=op_index)
    load, recv = body[0], body[-1]
    send = comp = decomp = None
    for op in body[1:-1]:
        if isinstance(op, Send):
            if send is not None:
                _err("ST_BODY_SHAPE", "two SENDs in one exchange body",
                     op_index=op_index)
            send = op
        elif isinstance(op, Compress):
            if comp is not None or send is not None:
                _err("ST_BODY_SHAPE",
                     "COMPRESS must appear exactly once, before SEND",
                     op_index=op_index)
            comp = op
        elif isinstance(op, Decompress):
            if decomp is not None or send is None:
                _err("ST_BODY_SHAPE",
                     "DECOMPRESS must appear exactly once, after SEND",
                     op_index=op_index)
            decomp = op
        else:
            _err("ST_BODY_SHAPE",
                 f"illegal op {type(op).__name__} inside exchange body",
                 op_index=op_index)
    if send is None:
        _err("ST_BODY_SHAPE", "exchange body has no SEND", op_index=op_index)
    if (comp is None) != (decomp is None):
        _err("ST_BODY_SHAPE",
             "COMPRESS without DECOMPRESS (or vice versa)",
             op_index=op_index)
    if recv.op not in COMBINE_OPS:
        _err("ST_BODY_SHAPE", f"unknown combine op {recv.op!r}",
             op_index=op_index)
    if load.sel is None:
        _err("ST_BODY_SHAPE", "COPY(load) carries no selector",
             op_index=op_index)
    return load, send, recv, (comp.codec if comp is not None else None)


# --------------------------------------------------------------------------
# Selector evaluation (concrete regions, with the fusion passes' opt-out)
# --------------------------------------------------------------------------

def _region(sel: Sel, rank: int, step: Optional[int], chunks: int,
            op_index: int) -> Optional[frozenset]:
    """Chunk set a selector touches at a concrete (rank, step); None when
    the closure is not pure (rank, step) arithmetic (region checks opt
    out, matching `program._sel_region`'s callers)."""
    if sel.kind == SEL_ALL:
        return frozenset(range(chunks))
    try:
        if sel.kind == SEL_CHUNK:
            reg = (int(sel.fn(rank, step)),)
        elif sel.kind == SEL_RANGE:
            off, length = sel.fn(rank, step)
            reg = tuple(range(int(off), int(off) + int(length)))
        elif sel.kind == SEL_MASK:
            reg = tuple(int(j) for j in sel.fn(rank, step))
        else:
            _err("ST_BODY_SHAPE", f"unknown selector kind {sel.kind!r}",
                 op_index=op_index)
    except VerifyError:
        raise
    except Exception:
        return None
    if not reg:
        _err("ST_SEL_BOUNDS", "selector produced an empty region",
             op_index=op_index, rank=rank, step=step)
    for c in reg:
        if not 0 <= c < chunks:
            _err("ST_SEL_BOUNDS",
                 f"selector chunk {c} outside grid [0, {chunks})",
                 op_index=op_index, rank=rank, step=step)
    return frozenset(reg)


# --------------------------------------------------------------------------
# Pass 0 — structural
# --------------------------------------------------------------------------

def structural_pass(prog: Program) -> None:
    n = prog.nranks
    for oi, step, body, k in _unique_bodies(prog):
        _, send, _, _ = _parse_body(body, oi)
        if k < 1:
            _err("ST_BODY_SHAPE", f"segment count {k} < 1", op_index=oi)
        seen_src: set = set()
        seen_dst: set = set()
        for s, d in send.perm:
            if not (0 <= s < n and 0 <= d < n):
                _err("ST_PERM_RANGE",
                     f"perm pair ({s}, {d}) outside [0, {n})",
                     op_index=oi, step=step)
            if s in seen_src:
                _err("ST_PERM_DUP", f"rank {s} sends twice in one permute",
                     op_index=oi, rank=s, step=step)
            if d in seen_dst:
                _err("ST_PERM_DUP",
                     f"rank {d} receives twice in one permute",
                     op_index=oi, rank=d, step=step)
            seen_src.add(s)
            seen_dst.add(d)


# --------------------------------------------------------------------------
# Pass 1 — cross-rank exchange matching
# --------------------------------------------------------------------------

def _codec_block(name: str) -> Optional[int]:
    """Scale-block size of a registered codec; None when the codec
    registry is unavailable (jax-free contexts keep this module usable)."""
    try:
        from repro_torch.core import plugins
    except Exception:
        return None
    spec = plugins.CODECS.get(name)
    if spec is None:
        _err("XM_SCALE_BLOCK", f"unknown codec {name!r}")
    return spec.block_elems


def exchange_pass(prog: Program, full: bool = True) -> None:
    """Every SEND has its matching receive; byte counts agree.

    The matching half (unmatched receives, dsts drift, codec pairing)
    is selector-free and runs at every compile; the byte-count half
    (`full=True`) evaluates regions concretely.
    """
    n, chunks = prog.nranks, prog.chunks
    for oi, step, body, k in _unique_bodies(prog):
        send = _find(body, Send)
        recv = _find(body, RecvCombine)
        if send is None or recv is None:
            continue  # structural_pass owns the shape diagnostics
        dsts = {d for _s, d in send.perm}
        if recv.dsts is None:
            missing = sorted(set(range(n)) - dsts)
            if missing:
                _err("XM_UNMATCHED_RECV",
                     f"ranks {missing} receive nothing but the exchange "
                     f"is unmasked (mask_recv=False) — every peer would "
                     f"block on an arrival that never comes",
                     op_index=oi, rank=missing[0], step=step)
        elif set(recv.dsts) != dsts:
            _err("XM_DSTS_MISMATCH",
                 f"RECV_COMBINE.dsts {sorted(recv.dsts)} != perm "
                 f"destinations {sorted(dsts)}", op_index=oi, step=step)
        comp = _find(body, Compress)
        decomp = _find(body, Decompress)
        names = {o.codec for o in (comp, decomp) if o is not None}
        if names:
            if len(names) > 1:
                _err("XM_SCALE_BLOCK",
                     f"compress codec differs across the wire: {sorted(names)}",
                     op_index=oi, step=step)
            name = names.pop()
            if prog.codec is not None and name != prog.codec:
                _err("XM_SCALE_BLOCK",
                     f"exchange codec {name!r} != program codec "
                     f"{prog.codec!r}", op_index=oi, step=step)
            _codec_block(name)
    if not full:
        return
    for kind, oi, payload in _instance_groups(prog):
        if kind != "group":
            continue
        for step, body, k in payload:
            load = _find(body, Copy)
            send = _find(body, Send)
            recv = _find(body, RecvCombine)
            if load is None or load.sel is None or send is None \
                    or recv is None:
                continue
            for s, d in send.perm:
                s_reg = _region(load.sel, s, step, chunks, oi)
                r_reg = _region(recv.sel, d, step, chunks, oi)
                if s_reg is None or r_reg is None:
                    continue
                if len(s_reg) != len(r_reg):
                    _err("XM_BYTES_MISMATCH",
                         f"rank {s} sends {len(s_reg)} chunk(s) but rank "
                         f"{d} receives {len(r_reg)}",
                         op_index=oi, rank=d, step=step)
                if not math.isclose(send.bytes_frac, len(s_reg) / chunks,
                                    rel_tol=1e-9, abs_tol=1e-12):
                    _err("XM_BYTES_FRAC",
                         f"Send.bytes_frac={send.bytes_frac!r} but the "
                         f"payload is {len(s_reg)}/{chunks} of the buffer "
                         f"— the cost walk would price a different wire "
                         f"volume than the executor moves",
                         op_index=oi, rank=s, step=step)


# --------------------------------------------------------------------------
# Pass 2 — deadlock freedom
# --------------------------------------------------------------------------

def deadlock_pass(prog: Program) -> None:
    """Within one bulk-synchronous exchange all sends progress together
    (ring cycles in one ppermute are fine); the only intra-exchange
    wait-for cycle a program can express is a rank waiting on itself."""
    for oi, step, body, k in _unique_bodies(prog):
        send = _find(body, Send)
        if send is None:
            continue
        for s, d in send.perm:
            if s == d:
                _err("DL_SELF_SEND",
                     f"rank {s} sends to itself — it would wait on its "
                     f"own uncombined receive", op_index=oi, rank=s,
                     step=step)


def check_request_dag(requests) -> None:
    """DL_DEP_CYCLE over Sequencer requests: edges are `Request.deps`
    plus operand-request chaining (the buffer WAR/WAW/RAW hazards the
    queue materializes as deps at issue time, including cross-axis
    `issue_multi` chains). Completed upstream requests no longer block,
    so only edges inside `requests` participate."""
    by_id = {id(r): r for r in requests}

    def _edges(req):
        for dep in (getattr(req, "deps", None) or ()):
            if id(dep) in by_id:
                yield dep
        operand = getattr(req, "operand", None)
        if operand is not None and id(operand) in by_id:
            yield operand

    WHITE, GREY, BLACK = 0, 1, 2
    color = {rid: WHITE for rid in by_id}
    for start in requests:
        if color[id(start)] != WHITE:
            continue
        stack = [(start, iter(list(_edges(start))))]
        color[id(start)] = GREY
        path = [start]
        while stack:
            node, it = stack[-1]
            nxt = next(it, None)
            if nxt is None:
                color[id(node)] = BLACK
                stack.pop()
                path.pop()
                continue
            c = color[id(nxt)]
            if c == GREY:
                cyc = [getattr(r, "rid", None) for r in path] + \
                    [getattr(nxt, "rid", None)]
                _err("DL_DEP_CYCLE",
                     f"request dependency cycle {cyc} — the queue would "
                     f"never drain")
            if c == WHITE:
                color[id(nxt)] = GREY
                path.append(nxt)
                stack.append((nxt, iter(list(_edges(nxt)))))


# --------------------------------------------------------------------------
# Pass 3 — level / fabric consistency
# --------------------------------------------------------------------------

def level_pass(prog: Program) -> None:
    sizes = dict(prog.level_sizes) if prog.level_sizes else None
    if sizes is not None:
        bad = sorted(set(sizes) - {"intra", "inter"})
        if bad:
            _err("LV_ORPHAN_LEVEL", f"unknown level name(s) {bad} in "
                 f"level_sizes {prog.level_sizes}")
        P, M = sizes.get("inter"), sizes.get("intra")
        if P is None or M is None or P * M != prog.nranks:
            _err("LV_ORPHAN_LEVEL",
                 f"level_sizes {prog.level_sizes} do not factor "
                 f"nranks={prog.nranks} as inter x intra")
    for oi, step, body, k in _unique_bodies(prog):
        send = _find(body, Send)
        if send is None:
            continue
        if send.level is None:
            if send.level_perm is not None:
                _err("LV_ORPHAN_LEVEL",
                     "level_perm without a level tag", op_index=oi,
                     step=step)
            continue
        if sizes is None or send.level not in sizes:
            _err("LV_ORPHAN_LEVEL",
                 f"level {send.level!r} does not resolve under "
                 f"level_sizes={prog.level_sizes}", op_index=oi, step=step)
        if send.level_perm is None:
            _err("LV_ORPHAN_LEVEL",
                 f"level {send.level!r} exchange carries no level_perm "
                 f"(the engine cannot ppermute it on the level's mesh "
                 f"axis)", op_index=oi, step=step)
        size = sizes[send.level]
        for s, d in send.level_perm:
            if not (0 <= s < size and 0 <= d < size):
                _err("LV_PERM_MISMATCH",
                     f"level perm pair ({s}, {d}) outside the "
                     f"{send.level} rank space [0, {size})",
                     op_index=oi, step=step)
        from repro_torch.core.hierarchical import (
            _expand_inter_perm, _expand_intra_perm)
        P, M = sizes["inter"], sizes["intra"]
        expanded = (_expand_intra_perm(send.level_perm, P)
                    if send.level == "intra"
                    else _expand_inter_perm(send.level_perm, P, M))
        if tuple(send.perm) != tuple(expanded):
            _err("LV_PERM_MISMATCH",
                 f"flat perm is not the {send.level} expansion of "
                 f"level_perm {send.level_perm} (simulator and engine "
                 f"would route different pairs)", op_index=oi, step=step)


# --------------------------------------------------------------------------
# Pass 4 — per-rank dataflow
# --------------------------------------------------------------------------

def _infer_root(prog: Program, schedule) -> int:
    """Best-effort root: bcast roots send first, 'root'-result
    collectives receive last. Falls back to 0 (every built-in default)."""
    groups = [p for kind, _oi, p in _instance_groups(prog)
              if kind == "group"]
    if not groups:
        return 0
    if prog.collective == "bcast":
        srcs = {s for _step, body, _k in groups[0]
                for (s, _d) in (_find(body, Send) or Send(())).perm}
        return min(srcs) if srcs else 0
    result = getattr(schedule, "result", None)
    if result == "root":
        dsts = {d for _step, body, _k in groups[-1]
                for (_s, d) in (_find(body, Send) or Send(())).perm}
        if len(dsts) == 1:
            return dsts.pop()
    return 0


def _initial_valid(prog: Program, schedule, root: int) -> list:
    """Chunk sets valid before op 0, per `simulator.run_collective`'s
    input conventions: gather-family programs on an n-chunk grid start
    with only the own shard in its slot; everything else starts from a
    full (or don't-care-but-initialized) buffer."""
    n, chunks = prog.nranks, prog.chunks
    full = frozenset(range(chunks))
    if prog.collective in ("allgather", "gather") and chunks == n:
        coords = getattr(schedule, "chunk_coords", "absolute")
        if prog.collective == "gather" and coords == "relative":
            return [{(r - root) % n} for r in range(n)]
        return [{r} for r in range(n)]
    return [set(full) for _ in range(n)]


def _rotate(sets: list, chunks: int, kind: str) -> list:
    """Permute per-rank chunk sets through a Bruck rotation (matching
    `simulator._bruck_pre/_bruck_post`): pre puts old chunk (j + r) % n
    at j; post puts old chunk (r - j) % n at j."""
    out = []
    for r, s in enumerate(sets):
        if kind == "bruck_pre":
            out.append({j for j in range(chunks) if (j + r) % chunks in s})
        else:
            out.append({j for j in range(chunks) if (r - j) % chunks in s})
    return out


def dataflow_pass(prog: Program, schedule=None) -> None:
    """Symbolic per-rank buffer walk over the unrolled program.

    Tracks, per rank, the set of *valid* chunks (initialized data) and —
    for bcast — the set of *fresh* chunks (derived from the root's
    payload), because `hier_bcast` legitimately overwrites stale scatter
    output with bitwise-identical fresh data: write-once is the wrong
    invariant there, root-freshness of every chunk is the right one.
    Gather-family copy collectives additionally prove exactly-once
    delivery (DF_DOUBLE_WRITE); within any bulk-synchronous group all
    writes must be disjoint on every executor.
    """
    n, chunks, coll = prog.nranks, prog.chunks, prog.collective
    root = _infer_root(prog, schedule)
    init = _initial_valid(prog, schedule, root)
    written: list = [set() for _ in range(n)]
    fresh: Optional[list] = None
    if coll == "bcast" and prog.relay != "received":
        fresh = [set(range(chunks)) if r == root else set()
                 for r in range(n)]
    deliver_once = coll in ("allgather", "gather")

    for kind, oi, payload in _instance_groups(prog):
        if kind == "rot":
            written = _rotate(written, chunks, payload)
            init = _rotate(init, chunks, payload)
            if fresh is not None:
                fresh = _rotate(fresh, chunks, payload)
            continue
        snap_valid = [init[r] | written[r] for r in range(n)]
        snap_fresh = [set(f) for f in fresh] if fresh is not None else None
        group_written: list = [set() for _ in range(n)]
        pending: list = []
        for step, body, k in payload:
            load = _find(body, Copy)
            send = _find(body, Send)
            recv = _find(body, RecvCombine)
            if load is None or load.sel is None or send is None \
                    or recv is None:
                continue
            for s, d in send.perm:
                s_reg = _region(load.sel, s, step, chunks, oi)
                r_reg = _region(recv.sel, d, step, chunks, oi)
                if s_reg is None and fresh is not None \
                        and load.source != SRC_ORIGINAL:
                    # Can't trace freshness through an opaque selector;
                    # drop the bcast taint analysis rather than report a
                    # false stale chunk.
                    fresh = None
                    snap_fresh = None
                if s_reg is not None:
                    if load.source == SRC_ORIGINAL:
                        pass  # the original operand is immutably valid
                    elif load.source == SRC_RECEIVED:
                        pass  # relay register is seeded with the input
                    elif not s_reg <= snap_valid[s]:
                        _err("DF_READ_BEFORE_WRITE",
                             f"rank {s} wires chunk(s) "
                             f"{sorted(s_reg - snap_valid[s])} it never "
                             f"received nor owned", op_index=oi, rank=s,
                             step=step)
                if r_reg is None:
                    continue
                if recv.op != "copy" and not r_reg <= snap_valid[d]:
                    _err("DF_COMBINE_UNWRITTEN",
                         f"rank {d} combines ({recv.op}) into "
                         f"uninitialized chunk(s) "
                         f"{sorted(r_reg - snap_valid[d])}",
                         op_index=oi, rank=d, step=step)
                if group_written[d] & r_reg:
                    _err("DF_DOUBLE_WRITE",
                         f"rank {d} receives chunk(s) "
                         f"{sorted(group_written[d] & r_reg)} twice "
                         f"inside one bulk-synchronous group (write "
                         f"order would be executor-dependent)",
                         op_index=oi, rank=d, step=step)
                group_written[d] |= r_reg
                if deliver_once and recv.op == "copy" \
                        and r_reg & (written[d] | init[d]):
                    _err("DF_DOUBLE_WRITE",
                         f"rank {d} is re-delivered chunk(s) "
                         f"{sorted(r_reg & (written[d] | init[d]))} it "
                         f"already holds", op_index=oi, rank=d, step=step)
                pay_fresh = False
                if snap_fresh is not None and s_reg is not None:
                    if load.source == SRC_ORIGINAL:
                        pay_fresh = s == root
                    else:
                        pay_fresh = s_reg <= snap_fresh[s]
                    if recv.op != "copy":
                        pay_fresh = pay_fresh and r_reg <= snap_fresh[d]
                pending.append((d, r_reg, pay_fresh))
        for d, r_reg, pay_fresh in pending:
            written[d] |= r_reg
            if fresh is not None:
                if pay_fresh:
                    fresh[d] |= r_reg
                else:
                    fresh[d] -= r_reg

    _coverage_check(prog, schedule, root, init, written, fresh)


def _coverage_check(prog: Program, schedule, root: int, init: list,
                    written: list, fresh: Optional[list]) -> None:
    n, chunks, coll = prog.nranks, prog.chunks, prog.collective
    full = set(range(chunks))
    have = [init[r] | written[r] for r in range(n)]
    if coll == "bcast":
        if fresh is None:
            return
        for r in range(n):
            if fresh[r] != full:
                _err("DF_COVERAGE",
                     f"rank {r} ends with chunk(s) {sorted(full - fresh[r])} "
                     f"not derived from the root's buffer", rank=r)
        return
    result = getattr(schedule, "result", None)
    if result is None and coll in ("allreduce", "allgather", "alltoall"):
        result = "full"
    if result == "full":
        for r in range(n):
            if have[r] != full:
                _err("DF_COVERAGE",
                     f"rank {r} never receives chunk(s) "
                     f"{sorted(full - have[r])}", rank=r)
    elif result == "shard":
        owned = getattr(schedule, "owned_chunk", None)
        if owned is None:
            return
        for r in range(n):
            try:
                oc = int(owned(r))
            except Exception:
                return
            if oc not in have[r]:
                _err("DF_COVERAGE",
                     f"rank {r} never receives its own shard chunk {oc}",
                     rank=r)
    elif result == "root":
        if have[root] != full:
            _err("DF_COVERAGE",
                 f"root {root} never receives chunk(s) "
                 f"{sorted(full - have[root])}", rank=root)


def stream_pass(prog: Program) -> None:
    """Re-prove the reorder-safety region of every STREAM/STREAM_CHAIN:
    a fused op whose regions fail `program._regions_stream_safe` would
    execute in a wave order that is not value-identical to the per-step
    order the simulator defines."""
    for oi, op in enumerate(prog.ops):
        if isinstance(op, Stream):
            loop = Loop(base=op.base, trip=op.trip, period=op.period,
                        slots=tuple((SegLoop(op.segments, b),)
                                    for b in op.slots))
            if not _stream_eligible(loop, op.segments, prog.nranks):
                _err("DF_STREAM_UNSAFE",
                     "STREAM fusion fails the cross-step region-overlap "
                     "proof (wave order would not be value-identical to "
                     "per-step order)", op_index=oi)
        elif isinstance(op, StreamChain):
            wrapped = [SegLoop(op.segments, b) for b in op.bodies]
            for w in wrapped:
                if not _chain_body_eligible(w, op.segments):
                    _err("DF_STREAM_UNSAFE",
                         "STREAM_CHAIN body is not chain-eligible at its "
                         "segment count", op_index=oi,
                         step=_body_step(w.body))
            seq = []
            for w in wrapped:
                load = _find(w.body, Copy)
                recv = _find(w.body, RecvCombine)
                seq.append((load.sel, recv.sel, load.source, load.step))
            for a, b in zip(seq, seq[1:]):
                if not _regions_stream_safe([a, b], op.segments,
                                            prog.nranks):
                    _err("DF_STREAM_UNSAFE",
                         "adjacent STREAM_CHAIN waves fail the region-"
                         "overlap proof", op_index=oi, step=b[3])


# --------------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------------

def verify_program(prog: Program, schedule=None,
                   level: str = "full") -> Program:
    """Run the static passes at `level` ("off" | "structural" | "full");
    raises `VerifyError` on the first violation, returns `prog`."""
    if level not in VERIFY_LEVELS:
        raise ValueError(
            f"verify level must be one of {VERIFY_LEVELS}, got {level!r}")
    if level == "off":
        return prog
    structural_pass(prog)
    exchange_pass(prog, full=(level == "full"))
    deadlock_pass(prog)
    level_pass(prog)
    if level == "full":
        dataflow_pass(prog, schedule)
        stream_pass(prog)
    return prog
