"""Rank-level numpy simulator — the ACCL+ ZMQ simulation platform analogue.

Executes the SAME micro-op `Program` the engine runs (a `Schedule` is
first compiled through `core/program.py`), over explicit per-rank buffers,
with no torch involved. Used for:
  * algorithm validation (tests compare against numpy oracles),
  * schedule/IR debugging without tracing/compiling,
  * the latency *model* evaluation in the fig10/fig12 benchmarks.

Because both executors interpret one compiled artifact, oracle parity here
covers the real engine code path (LOOP coalescing, SEG_LOOP segmentation,
Bruck rotations) — the simulator is the "bus functional model of the CCLO",
not a parallel reimplementation of the algorithms.

Wire codecs are engine-side plugins; the simulator executes uncompressed
programs only (compile with codec=None, the default).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.program import (
    Copy, Compress, Decompress, Program, Send, batches, compile_schedule,
    fit_segments,
)
from repro_torch.core.schedule import (
    SEL_ALL, SEL_CHUNK, SEL_MASK, SEL_RANGE, Schedule, Sel,
)

_COMBINE = {
    "copy": lambda old, new: new,
    "add": lambda old, new: old + new,
    "max": np.maximum,
    "min": np.minimum,
    "mul": lambda old, new: old * new,
}


def _chunk_view(buf: np.ndarray, chunks: int, idx: int, length: int = 1):
    """Slice chunks [idx, idx+length) of the flat leading dim."""
    csize = buf.shape[0] // chunks
    return buf[idx * csize:(idx + length) * csize]


def _select(buf: np.ndarray, chunks: int, sel: Sel, rank: int, step: int):
    if sel.kind == SEL_ALL:
        return buf.copy()
    if sel.kind == SEL_CHUNK:
        return _chunk_view(buf, chunks, int(sel.fn(rank, step))).copy()
    if sel.kind == SEL_RANGE:
        off, length = sel.fn(rank, step)
        return _chunk_view(buf, chunks, int(off), int(length)).copy()
    if sel.kind == SEL_MASK:
        idxs = sel.fn(rank, step)
        return np.concatenate(
            [_chunk_view(buf, chunks, int(j)) for j in idxs], axis=0)
    raise ValueError(sel.kind)


def _recv_region(buf: np.ndarray, chunks: int, sel: Sel, rank: int,
                 step: int):
    """(view_copy, elem_offset, mask_idxs) mirroring the engine's helper."""
    csize = buf.shape[0] // chunks
    if sel.kind == SEL_MASK:
        idxs = tuple(int(j) for j in sel.fn(rank, step))
        view = np.concatenate(
            [_chunk_view(buf, chunks, j) for j in idxs], axis=0)
        return view, None, idxs
    if sel.kind == SEL_ALL:
        return buf.copy(), None, None
    if sel.kind == SEL_CHUNK:
        off = int(sel.fn(rank, step)) * csize
        length = csize
    else:
        o, ln = sel.fn(rank, step)
        off, length = int(o) * csize, int(ln) * csize
    return buf[off:off + length].copy(), off, None


def _apply_write(buf: np.ndarray, chunks: int, off, mask_idxs,
                 new_val: np.ndarray) -> None:
    if mask_idxs is not None:
        csize = buf.shape[0] // chunks
        for k, j in enumerate(mask_idxs):
            buf[j * csize:(j + 1) * csize] = \
                new_val[k * csize:(k + 1) * csize]
        return
    if off is None:
        buf[...] = new_val
        return
    buf[off:off + new_val.shape[0]] = new_val


def _bruck_pre(bufs, n):
    """Rank r rotates chunks so chunk j holds data destined to (r+j)%n."""
    out = []
    for r, b in enumerate(bufs):
        csize = b.shape[0] // n
        parts = [b[((j + r) % n) * csize:(((j + r) % n) + 1) * csize]
                 for j in range(n)]
        out.append(np.concatenate(parts, axis=0))
    return out


def _bruck_post(bufs, n):
    """After the phases chunk j holds data from rank (r-j)%n; rearrange so
    chunk j holds data from rank j."""
    out = []
    for r, b in enumerate(bufs):
        csize = b.shape[0] // n
        parts = [b[((r - j) % n) * csize:(((r - j) % n) + 1) * csize]
                 for j in range(n)]
        out.append(np.concatenate(parts, axis=0))
    return out


# --------------------------------------------------------------------------
# Program execution
# --------------------------------------------------------------------------

class _State:
    """Per-run registers: buffers plus the relay sources."""

    def __init__(self, bufs):
        self.bufs = bufs
        self.origs = [b.copy() for b in bufs]
        self.prevs = [b.copy() for b in bufs]  # relay='received' step 0

    def source(self, which: str):
        return {"buffer": self.bufs, "original": self.origs,
                "received": self.prevs}[which]


def _exchange_writes(body: tuple, k_req: int, state: _State, chunks: int,
                     step: int, transport=None) -> list:
    """One exchange across all ranks, two-phase: every rank's payload and
    combine target are read from the current state, then the region
    writes are returned for the caller to apply.

    Mirrors the engine's `_exchange_update` + deferred `_apply_write`,
    including SEG_LOOP's per-segment combine granularity, so numerics
    match the XLA executor exactly.

    `transport` (a `faults.FaultyTransport`) is consulted once per
    (src, dst) wire crossing BEFORE any write is staged: a delivery that
    survives its retry budget retransmits the identical payload (so the
    final buffers are bitwise-equal to the fault-free run), and a
    terminal loss raises a typed error while every buffer still holds
    its pre-exchange state — no partial writes, no silent corruption.
    Returns [(rank, off, mask_idxs, new_val, raw_or_None), ...].
    """
    load, recv = body[0], body[-1]
    for op in body[1:-1]:
        if isinstance(op, (Compress, Decompress)):
            raise NotImplementedError(
                "the numpy simulator executes uncompressed programs only")
    send_op = next(op for op in body[1:-1] if isinstance(op, Send))

    n = len(state.bufs)
    srcs = state.source(load.source)
    payloads = {r: _select(srcs[r], chunks, load.sel, r, step)
                for r in range(n)}
    wire = {dst: payloads[src] for (src, dst) in send_op.perm}

    if transport is not None:
        for (src, dst) in send_op.perm:
            transport.deliver(src, dst)
        transport.advance()

    if recv.dsts is None:
        missing = set(range(n)) - set(wire.keys())
        if missing:
            raise ValueError(
                f"step {step}: ranks {missing} receive nothing but "
                f"mask_recv=False")

    writes = []
    for dst in range(n):
        incoming = wire.get(dst)
        if incoming is None:
            continue  # masked non-destination keeps its state
        view, off, mask_idxs = _recv_region(state.bufs[dst], chunks,
                                            recv.sel, dst, step)
        comb = _COMBINE[recv.op]
        k = 1
        if k_req > 1 and view.shape[0] == payloads[dst].shape[0]:
            row_elems = max(1, view.size // max(1, view.shape[0]))
            k = fit_segments(view.shape[0], k_req, row_elems)
        if k > 1:
            seg = view.shape[0] // k
            new_val = np.concatenate(
                [comb(view[i * seg:(i + 1) * seg],
                      incoming[i * seg:(i + 1) * seg].astype(view.dtype))
                 for i in range(k)], axis=0)
        else:
            new_val = comb(view, incoming.astype(view.dtype))
        raw = incoming if recv.track_recv else None
        writes.append((dst, off, mask_idxs, np.asarray(new_val), raw))
    return writes


def _apply(state: _State, chunks: int, writes: list) -> None:
    for rank, off, mask_idxs, new_val, raw in writes:
        _apply_write(state.bufs[rank], chunks, off, mask_idxs, new_val)
        if raw is not None:
            state.prevs[rank] = np.array(raw, copy=True)


def execute_program(prog: Program, inputs: list, transport=None) -> list:
    """Run a compiled Program over per-rank buffers; returns final buffers.

    The program runs batch by batch of the engine's walk
    (`program.batches`: a STREAM or STREAM_CHAIN as its unfused per-step
    exchanges, segment granularity included, which the fusion passes
    prove value-identical): every exchange of a batch reads the
    batch-start buffers, and the writes land at its end.

    `transport` (optional `faults.FaultyTransport`) injects the fault
    plan at every wire crossing; see `_exchange_writes`.
    """
    n = prog.nranks
    assert len(inputs) == n, f"need {n} rank buffers"
    for b in inputs:
        if b.shape[0] % prog.chunks:
            raise ValueError(
                f"leading dim {b.shape[0]} not divisible by {prog.chunks}")

    state = _State([np.array(b, copy=True) for b in inputs])
    for item in batches(prog):
        if isinstance(item, Copy) and item.kind == "bruck_pre":
            # the relay registers hold the rotated input
            state = _State(_bruck_pre(state.bufs, prog.chunks))
        elif isinstance(item, Copy):
            state.bufs = _bruck_post(state.bufs, prog.chunks)
        else:
            _apply(state, prog.chunks, [
                w for body, k_req, step in item.exchanges
                for w in _exchange_writes(body, k_req, state, prog.chunks,
                                          step, transport)])
    return state.bufs


def simulate(schedule: Schedule, inputs: list,
             segments: Optional[int] = None, stream: bool = True,
             stacked: bool = True, transport=None) -> list:
    """Compile `schedule` to its micro-op program and run it over per-rank
    buffers; returns final per-rank buffers. `segments` overrides the
    schedule's wire-segmentation knob; `stream`/`stacked` gate the
    optimization passes exactly as in `Schedule.compile`. `transport`
    (optional `faults.FaultyTransport`) injects fabric faults."""
    schedule.validate()
    prog = compile_schedule(schedule, segments=segments, stream=stream,
                            stacked=stacked)
    return execute_program(prog, inputs, transport)


def simulate_with_cost(schedule: Schedule, inputs: list, comm,
                       segments: Optional[int] = None,
                       elem_bytes: int = 4, stream: bool = True,
                       stacked: bool = True) -> tuple:
    """`simulate`, plus the predicted seconds of the SAME compiled program
    (`Program.cost`) — the simulator returns the split-model cost of
    exactly the program it executed, the fig10/fig12 model-evaluation
    contract. A streamed compile and a `stream=False` compile of the same
    schedule execute to identical buffers but price differently: only the
    streamed program earns the cross-step fill/drain credit."""
    schedule.validate()
    prog = compile_schedule(schedule, segments=segments, stream=stream,
                            stacked=stacked)
    bufs = execute_program(prog, inputs)
    msg_bytes = inputs[0].size * inputs[0].itemsize
    return bufs, prog.cost(msg_bytes, comm, elem_bytes=elem_bytes)


def _flatten_pad(x: np.ndarray, mult: int):
    """numpy mirror of the engine's `_flatten_pad` staging copy."""
    flat = np.asarray(x).reshape(-1)
    pad = (-flat.shape[0]) % mult
    if pad:
        flat = np.concatenate([flat, np.zeros((pad,), flat.dtype)])
    return flat, x.shape, x.size


def run_collective(collective: str, schedule: Schedule, prog: Program,
                   inputs: list, root: int = 0, transport=None) -> list:
    """Execute one ENGINE-CONVENTION collective call over per-rank numpy
    buffers: the same flatten/pad staging, result trimming, and
    shard/root slicing the `CollectiveEngine` wrappers apply around
    `execute_program`, so a simulated call is comparable element-for-
    element with the engine's return value. Used by the sequencer's
    `simulate_drain` to validate queue drains against the same compiled
    program the makespan model prices. Returns per-rank results."""
    n = prog.nranks
    if len(inputs) != n:
        raise ValueError(f"need {n} rank buffers, got {len(inputs)}")
    if collective == "alltoall":
        arrs = [np.asarray(b) for b in inputs]
        if arrs[0].shape[0] % n:
            raise ValueError(
                f"alltoall dim0 {arrs[0].shape[0]} % {n} != 0")
        return execute_program(prog, arrs, transport)
    if collective == "reduce_scatter":
        flats = [np.asarray(b).reshape(-1) for b in inputs]
        if flats[0].size % n:
            raise ValueError(
                f"reduce_scatter size {flats[0].size} % {n} != 0")
        outs = execute_program(prog, flats, transport)
        csize = flats[0].shape[0] // n
        return [outs[r][int(schedule.owned_chunk(r)) * csize:
                        (int(schedule.owned_chunk(r)) + 1) * csize]
                for r in range(n)]
    if collective in ("allgather", "gather"):
        flats = [np.asarray(b).reshape(-1) for b in inputs]
        fl = flats[0].shape[0]
        bufs = []
        for r in range(n):
            slot = r if (collective == "allgather"
                         or schedule.chunk_coords == "absolute") \
                else (r - root) % n
            buf = np.zeros((n * fl,), flats[r].dtype)
            buf[slot * fl:(slot + 1) * fl] = flats[r]
            bufs.append(buf)
        outs = execute_program(prog, bufs, transport)
        if collective == "gather" and schedule.chunk_coords == "relative":
            outs = [np.roll(o.reshape(n, fl), root, axis=0).reshape(-1)
                    for o in outs]
        return outs
    # allreduce / reduce / bcast / custom collectives: pad to the chunk
    # grid, run, then trim (full results) or slice the owned chunk
    staged = [_flatten_pad(b, prog.chunks) for b in inputs]
    outs = execute_program(prog, [s[0] for s in staged], transport)
    if schedule.result == "shard":
        if staged[0][2] % prog.chunks:
            raise ValueError(
                f"{collective} returns shards: input size {staged[0][2]} "
                f"must be divisible by {prog.chunks} chunks")
        csize = staged[0][0].shape[0] // prog.chunks
        return [outs[r][int(schedule.owned_chunk(r)) * csize:
                        (int(schedule.owned_chunk(r)) + 1) * csize]
                for r in range(n)]
    return [outs[r][:staged[r][2]].reshape(staged[r][1])
            for r in range(n)]


# ---------------------------------------------------------------------------
# Numpy oracles (what each collective should produce)
# ---------------------------------------------------------------------------

def oracle(collective: str, inputs: list, op: str = "add",
           root: int = 0):
    """Reference results, rank-indexed. For 'shard' results, returns the
    full reduction; callers slice per owned_chunk."""
    n = len(inputs)
    stack = np.stack(inputs)
    if collective in ("allreduce", "reduce", "reduce_scatter"):
        red = {"add": np.sum, "max": np.max, "min": np.min,
               "mul": np.prod}[op](stack, axis=0)
        return red
    if collective in ("allgather", "gather"):
        return np.concatenate(inputs, axis=0)
    if collective == "bcast":
        return inputs[root]
    if collective == "alltoall":
        # chunk j of rank r's output = chunk r of rank j's input
        csize = inputs[0].shape[0] // n
        return [
            np.concatenate([inputs[j][r * csize:(r + 1) * csize]
                            for j in range(n)], axis=0)
            for r in range(n)
        ]
    raise ValueError(collective)
