"""One rank per process: the per-rank data plane over `torch.distributed`.

Port of the reference's per-device execution: `repro/core/engine.py::
execute_program` runs inside `shard_map`, each device reads its own rank
(`lax.axis_index`), evaluates its own selectors and moves real bytes
between devices with `lax.ppermute` (`_send_chain`, `_exec_stacked`); a
two-level program permutes each level on that level's own mesh axis.
Here each process holds one rank's shard and runs the same compiled
`Program` with the same selectors:

  * `Transport` wraps one process group. One call posts every send and
    receive of an exchange — or of a whole LOOP iteration — as one
    `dist.batch_isend_irecv`, then waits. On a `gloo` group a CUDA
    payload is staged through pinned host buffers (gloo has no CUDA
    send/recv), counted in `stats` (`staged_bytes`, `staged_ms`); a
    group whose backend takes device tensors (NCCL) sends them as they
    are. The transport never changes backend. Messages are tagged by
    their (slot, part) within the call, so two slots of one LOOP
    iteration between the same pair of ranks never cross.
  * `execute_program_local(prog, buf, rank, transport)` walks the
    stacked executor's batches (`program.batches`) on one rank's
    `(L, ...)` shard, held as a stack of one row in the stacked
    executor's registers (`engine._State`: Bruck pre/post as a local
    chunk roll by `rank`, the `orig` / `prev` relay registers). Each
    batch — a LOOP iteration, a STACKED_RECV, or one exchange — posts
    every wire from the batch-start state, waits, and lands its writes
    in order after all waits; hierarchical programs run through their
    flat perms. A rank sends to `d` where `(rank, d)` is in the SEND's
    perm and `d` receives, and receives from `src_of[rank]`. Payload
    spans come from the sender's rank and target spans from the
    receiver's; both sides compute the exchange's segment count, and a
    disagreement raises.
  * Kernels per rank, on the stacked executor's paths
    (`engine.exchange_path`, never in place) and through its consume
    half (`engine._consume`) on the arrival: a plain combine launches K1
    (`ops.fused_combine_at`) once over the whole exchange, reading the
    local target in place and the arrival from the receive buffer; an
    int8 exchange launches K2 (`compress_at`) once over the local
    payload at send and K3 (`consume_at`) once into the local target at
    receive (a relay exchange adds one K3 copy for its raw arrival);
    bf16 keeps its per-segment gathered path. Copy receives launch
    nothing.
  * `ProcessGroupEngine` is the `CollectiveEngine` of one process: its
    inputs and outputs are this rank's local shard (no mesh dims lead,
    `stack_shape == ()`), `_resolve`, the selector, the schedule cache
    and every blocking and queued collective run unchanged, and
    `_execute` routes to `execute_program_local`. The engine's hooks
    become one `torch.distributed` call each: the native backend's
    (`_native*`: all_reduce, reduce_scatter, all_gather, broadcast,
    all_to_all_single on the axis's group, staged as the transport
    stages) and the streaming ops' ring step (`_ring_pass`: one
    `Transport.exchange` per step, every segment's block, k and v alike,
    posted in one batch under its own tag), so `allgather_matmul`,
    `matmul_reduce_scatter` and `ring_attention` run the stacked code on
    one row — the reference's per-device form, `ppermute` for
    `ppermute`, K4 once per local product — and differentiate as the
    stacked ops do: the matmuls through their adjoint Functions on local
    shards, the ring step through its reverse exchange (`_RingPass`).
    Every process must issue the
    same collectives, with the same arguments, in the same order — the
    SPMD contract of `shard_map`; a fingerprint of each new program, and
    of each new streaming-op signature, is all-gathered once, which
    turns a violation into an error where the call is new to every rank,
    and into a failure at the group timeout where it is not.

Numerics one rank per process: programs and the streaming ops are
bitwise the stacked engine's (the same kernels on the same operands in
the same order). A native sum is gloo's or NCCL's, which adds in its own
order — neither `t.sum(1)`'s nor `lax.psum`'s — so the native backend is
bitwise only where every order of sums is exact (integer-valued fp32);
elsewhere each element lies within (n - 1) u sum_r |x_r| of the exact
sum (u = 2^-24 in fp32), the bound of any order of n - 1 additions.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import math
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import autograd as _autograd
from repro_torch.core import telemetry
from repro_torch.core.engine import (
    CollectiveEngine, _apply, _consume, _ends, _Layout, _region_index,
    _segment_wire, _segments, _spans, _State, exchange_path,
)
from repro_torch.core.plugins import Compressed
from repro_torch.core.program import (
    SRC_RECEIVED, Copy, Program, RecvCombine, batches,
)
from repro_torch.kernels import ops as kops

#: the native backend's reductions as `torch.distributed` ops
_DIST_OP = {"add": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
            "min": dist.ReduceOp.MIN}


# --------------------------------------------------------------------------
# Transport: one process group's point-to-point exchanges
# --------------------------------------------------------------------------

class Transport:
    """Point-to-point exchanges among the processes of one communicator.

    `group` is the `torch.distributed` group of those processes and
    `ranks[i]` the global rank of communicator rank i. `exchange` posts
    every send and receive it is given as one `batch_isend_irecv` and
    waits for all of them; `collective` runs one collective call on the
    group (the native backend's). `stats` counts calls, messages, bytes
    and — on a gloo group with CUDA tensors only — the bytes staged
    through pinned host memory and the host time the staging copies
    took.
    """

    def __init__(self, group, ranks):
        self.group = group
        self.ranks = tuple(int(r) for r in ranks)
        self.backend = dist.get_backend(group)
        self.me = self.ranks.index(dist.get_rank())
        self.metrics = telemetry.MetricsRegistry()
        for name in ("exchanges", "collectives", "messages", "bytes",
                     "staged_bytes"):
            self.metrics.counter(name)
        self.metrics.counter("staged_ms", 0.0)
        self.stats = self.metrics.view()

    def _staged(self, t) -> bool:
        return self.backend == "gloo" and t.device.type == "cuda"

    def exchange(self, sends, recvs) -> None:
        """Post `sends` and `recvs` — lists of (communicator rank, tag,
        tensor) — as one batch, and wait. A receive tensor is filled in
        place."""
        if any(p == self.me for p, _tag, _t in sends + recvs):
            # a verified program never sends to itself (DL_SELF_SEND)
            raise ValueError(f"rank {self.me} cannot send to itself")
        if not sends and not recvs:
            return

        def post(w_out, w_in):
            ops = [dist.P2POp(dist.isend, w, self.ranks[p], self.group, tag)
                   for (p, tag, _t), w in zip(sends, w_out)]
            ops += [dist.P2POp(dist.irecv, w, self.ranks[p], self.group, tag)
                    for (p, tag, _t), w in zip(recvs, w_in)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()

        self._staged_call([t for _p, _tag, t in sends],
                          [t for _p, _tag, t in recvs], post)
        self.metrics.inc("exchanges")
        self.metrics.inc("messages", len(sends) + len(recvs))

    def collective(self, fn, send, recv=None) -> None:
        """One collective on the group, `fn(wire_send, wire_recv)`; `recv`
        (default `send`: in place) is filled from its wire after."""
        self._staged_call([send], [send if recv is None else recv],
                          lambda w_out, w_in: fn(w_out[0], w_in[0]))
        self.metrics.inc("collectives")

    def _staged_call(self, sends, recvs, fn) -> None:
        """`fn(wires of sends, wires of recvs)`, then each receive filled
        from its wire. On a gloo group a CUDA tensor's wire is a pinned
        host buffer (a receive that is also a send shares its wire);
        counts the wire bytes and the staging."""
        staged = [t for t in {id(t): t for t in sends + recvs}.values()
                  if self._staged(t)]
        t0 = time.perf_counter()
        wires = {id(t): self._to_host(t) for t in sends}
        w_out = [wires[id(t)] for t in sends]
        w_in = [wires[id(t)] if id(t) in wires else self._host_like(t)
                for t in recvs]
        if staged:
            torch.cuda.current_stream(staged[0].device).synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        fn(w_out, w_in)
        t0 = time.perf_counter()
        for t, w in zip(recvs, w_in):
            if w is not t:
                t.copy_(w, non_blocking=True)
        m = self.metrics
        if staged:
            torch.cuda.current_stream(staged[0].device).synchronize()
            m.inc("staged_ms", ms + (time.perf_counter() - t0) * 1e3)
            m.inc("staged_bytes", sum(t.numel() * t.element_size()
                                      for t in staged))
        m.inc("bytes", sum(w.numel() * w.element_size() for w in
                           {id(w): w for w in w_out + w_in}.values()))

    def _to_host(self, t):
        if not self._staged(t):
            return t.contiguous()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t, non_blocking=True)

    def _host_like(self, t):
        if not self._staged(t):
            return t
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


# --------------------------------------------------------------------------
# The per-rank executor
# --------------------------------------------------------------------------

def _whole(rows: int) -> tuple:
    return (((0, rows),),)


def _rows_of(t, spans):
    """The payload of `spans` (row_start, rows) of `t`, in payload order."""
    parts = [t[s:s + ln] for s, ln in spans]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _tensors(wire) -> tuple:
    """A wire's tensors, as they cross: the payload, or its fields."""
    return tuple(wire) if isinstance(wire, Compressed) else (wire,)


@dataclasses.dataclass
class _Xfer:
    """One exchange as this rank sees it: what it sends, what it
    receives, and how the arrival is consumed."""

    recv: RecvCombine
    codec: object
    path: str
    dst: Optional[int] = None            # the rank this one sends to
    out: tuple = ()                      # the wire tensors it sends
    src: Optional[int] = None            # the rank it receives from
    inbox: tuple = ()                    # receive buffers, filled in place
    arrival: object = None               # what `_consume` reads of them
    tgt_idx: object = None


def _plan(st: _State, body: tuple, k_req: int, step) -> _Xfer:
    """This rank's side of one exchange, before anything moves: the wire
    it sends (read from the current state) and the buffers it receives
    into. `st` holds this rank's shard as a stack of one row."""
    load, send, recv, codec, src_of, dsts = _ends(body, st.n, step)
    me, chunks = st.ranks[0], st.chunks
    dst_of = {s: d for (s, d) in send.perm}
    src_t, buf = st.source(load.source), st.buf
    row_elems = math.prod(buf.shape[2:])
    x = _Xfer(recv=recv, codec=codec,
              path=exchange_path(codec, recv, False))

    if dst_of.get(me) in dsts:                                 # at send
        spans = _spans(load.sel, chunks, src_t.shape[1], me, step)
        k = _segments(sum(ln for _s, ln in spans), k_req, row_elems, codec)
        x.dst = dst_of[me]
        if x.path == "codec":
            x.out = tuple(codec.compress_at(src_t, _region_index(
                (0,), (spans,), k, src_t.device)))
        else:
            x.out = _tensors(_segment_wire(codec, _rows_of(
                src_t[0], spans).reshape(k, 1, -1)))

    if me in dsts:                                             # at receive
        x.src = src_of[me]
        pay_rows = sum(ln for _s, ln in _spans(load.sel, chunks,
                                               src_t.shape[1], x.src, step))
        tgt_spans = _spans(recv.sel, chunks, buf.shape[1], me, step)
        view_rows = sum(ln for _s, ln in tgt_spans)
        if pay_rows != view_rows:
            raise ValueError(f"step {step}: payload of {pay_rows} rows "
                             f"cannot land in a region of {view_rows} rows")
        k = _segments(pay_rows, k_req, row_elems, codec)
        if _segments(view_rows, k_req, row_elems, codec) != k:
            raise ValueError(f"step {step}: rank {x.src} sends {k} segments "
                             f"but rank {me} expects another count")
        x.tgt_idx = _region_index((0,), (tgt_spans,), k, buf.device)
        if x.path == "codec":
            tmpl = tuple(codec.compress_at(
                torch.empty((1, pay_rows) + buf.shape[2:], dtype=buf.dtype,
                            device="meta"),
                _region_index((0,), _whole(pay_rows), k, "meta")))
        else:       # one segment's wire, k times
            tmpl = tuple(torch.empty((k,) + t.shape[1:], dtype=t.dtype,
                                     device="meta")
                         for t in _tensors(_segment_wire(codec, torch.empty(
                             (1, 1, pay_rows // k * row_elems),
                             dtype=buf.dtype, device="meta"))))
        x.inbox = tuple(torch.empty(t.shape, dtype=t.dtype,
                                    device=buf.device) for t in tmpl)
        if x.path in ("in_place", "indexed"):    # K1 reads it in place
            x.arrival = (x.inbox[0].reshape((1, pay_rows) + buf.shape[2:]),
                         _region_index((0,), _whole(pay_rows), k,
                                       buf.device))
        else:
            x.arrival = x.inbox[0] if codec is None else \
                Compressed(*x.inbox)
    return x


def _run(st: _State, transport: Transport, exchanges) -> None:
    """One batch: every exchange's wire leaves from the current state,
    everything is posted at once, then each arrival is consumed against
    the pre-batch state and the writes land in order (a LOOP iteration's
    two-phase semantics; one exchange alone is the sequential case)."""
    xs = [_plan(st, body, k_req, step) for body, k_req, step in exchanges]
    sends = [(x.dst, 2 * s + p, t) for s, x in enumerate(xs)
             if x.dst is not None for p, t in enumerate(x.out)
             if t.numel()]
    recvs = [(x.src, 2 * s + p, t) for s, x in enumerate(xs)
             if x.src is not None for p, t in enumerate(x.inbox)
             if t.numel()]
    transport.exchange(sends, recvs)
    writes = [(x.tgt_idx, *_consume(st.buf, x.tgt_idx, x.recv, x.codec,
                                    x.path, x.arrival))
              for x in xs if x.src is not None]
    for write in writes:
        _apply(st, *write)


def execute_program_local(prog: Program, buf, rank: int,
                          transport: Transport):
    """Execute a compiled micro-op Program on ONE rank's shard.

    `buf` is this rank's `(L, ...)` buffer (L divisible by prog.chunks),
    `rank` its rank in the program's communicator (the inner-major flat
    rank `intra * P + pod` for a two-level program) and `transport` the
    communicator's processes. Every process of the communicator calls
    this with the same program at the same time. Returns the final
    buffer (a new tensor; `buf` is not modified) — bitwise the row
    `rank` of `engine.execute_program` on the stacked buffers. Every
    write is deferred to its batch's end, whatever the program proves.
    """
    if buf.ndim < 1 or buf.shape[0] % prog.chunks:
        raise ValueError(f"buffer of shape {tuple(buf.shape)} is not cut "
                         f"into {prog.chunks} chunks")
    if not 0 <= rank < prog.nranks:
        raise ValueError(f"rank {rank} outside {prog.nranks} ranks")
    st = _State(prog, buf.contiguous().clone().unsqueeze(0), (rank,))
    for item in batches(prog):
        if isinstance(item, Copy):
            st.roll(item.kind)
        else:
            _run(st, transport, item.exchanges)
    return st.buf[0]


# --------------------------------------------------------------------------
# What a rank's share of a program launches
# --------------------------------------------------------------------------

def implied_launches(prog: Program, rank: int, shape) -> dict:
    """The kernel launches rank `rank`'s share of `prog` implies on a
    buffer of local shape `shape`, from the program alone, on the paths
    the per-rank executor takes (`exchange_path`, never in place): K1
    once for every plain combining exchange it receives (one launch over
    all its segments) and once per segment of any other combining
    exchange (a relay's or bf16's, at consume), K2 once per int8
    exchange it sends, K3 once per int8 exchange it consumes and once
    more where that exchange is a relay. Keys as `ops.launch_counts()`."""
    counts = dict.fromkeys(kops.KERNELS, 0)
    L, row_elems = int(shape[0]), math.prod(shape[1:])
    prev_len = L
    for item in batches(prog):
        for body, k_req, step in ([] if isinstance(item, Copy)
                                  else item.exchanges):
            load, send, recv, codec, src_of, dsts = _ends(body, prog.nranks,
                                                          step)
            path = exchange_path(codec, recv, False)
            if path == "codec" and dict(send.perm).get(rank) in dsts:
                counts["quantize_blocks"] += 1
            length = prev_len if load.source == SRC_RECEIVED else L
            rows = sum(ln for _s, ln in _spans(load.sel, prog.chunks, length,
                                               src_of.get(rank, rank), step))
            if recv.track_recv:
                prev_len = rows
            if rank not in dsts:
                continue
            if path == "codec":
                counts["dequantize_blocks"] += 1 + int(recv.track_recv)
            elif path == "indexed":
                counts["fused_combine"] += 1
            elif recv.op != "copy":
                counts["fused_combine"] += _segments(rows, k_req, row_elems,
                                                     codec)
    return counts


# --------------------------------------------------------------------------
# The per-process engine
# --------------------------------------------------------------------------

def _fingerprint(prog: Program, shape, dtype) -> str:
    """A digest of what every process of a communicator must run alike:
    the program's metadata and micro-ops (perms, ops, selector kinds,
    steps; selector closures are pure, so their kinds and steps name
    them) and the buffer's shape and dtype."""
    def walk(x):
        if isinstance(x, (tuple, list)):
            return tuple(walk(y) for y in x)
        if dataclasses.is_dataclass(x):
            fields = []
            for f in dataclasses.fields(x):
                v = getattr(x, f.name)
                if f.name == "sel":
                    v = None if v is None else v.kind
                fields.append((f.name, walk(v)))
            return (type(x).__name__, tuple(fields))
        return x
    meta = (prog.name, prog.collective, prog.nranks, prog.chunks,
            prog.relay, prog.segments, prog.codec, prog.level_sizes,
            tuple(shape), str(dtype))
    return hashlib.sha256(repr((meta, walk(prog.ops))).encode()).hexdigest()


@dataclasses.dataclass
class _LocalLayout(_Layout):
    """One rank's shard as a stack of one row."""

    rank: int = 0

    def restore(self, ys):
        return ys.reshape(tuple(ys.shape[1:]))

    def row_ranks(self) -> list:
        return [self.rank]


def _default_device():
    if not torch.cuda.is_available():
        return "cuda"                         # the base class raises
    local = int(os.environ.get("LOCAL_RANK", 0))
    return f"cuda:{local % torch.cuda.device_count()}"


def mesh_groups(mesh_shape: dict, members=None) -> tuple:
    """Create the process groups of a mesh laid over the global ranks
    `members` (row-major in mesh order; default the whole world): the
    whole mesh's, and one per live axis and per pair of live axes at every
    position of the other axes. `dist.new_group` is collective over the
    whole world, so every process of the world — inside the mesh or not —
    calls this with the same arguments, in the same order as the other
    processes make their own calls. Returns (the whole mesh's group —
    None for the whole world —, the members, {(axes, coords of the other
    axes): group}); a process outside a group holds a handle it cannot
    use. A process that has left the mesh keeps taking part through
    `follow_meshes`."""
    names = list(mesh_shape)
    sizes = tuple(mesh_shape[a] for a in names)
    world = dist.get_world_size()
    members = tuple(range(world)) if members is None else \
        tuple(int(g) for g in members)
    if len(members) != math.prod(sizes) or len(set(members)) != len(members):
        raise ValueError(f"{len(members)} processes cannot hold the mesh "
                         f"{dict(mesh_shape)}")
    if not all(0 <= g < world for g in members):
        raise ValueError(f"members {members} are not all ranks of the "
                         f"world of {world}")

    def glob(coords: dict) -> int:
        return members[int(np.ravel_multi_index(
            tuple(coords[a] for a in names), sizes))]

    whole = None if members == tuple(range(world)) else \
        dist.new_group(list(members))
    groups = {}
    live = [a for a in names if mesh_shape[a] > 1]
    for axes in [(a,) for a in live] + list(itertools.combinations(live, 2)):
        others = [a for a in names if a not in axes]
        for rest in itertools.product(*(range(mesh_shape[a])
                                        for a in others)):
            fixed = dict(zip(others, rest))
            groups[axes, rest] = dist.new_group(sorted(
                glob(dict(fixed, **dict(zip(axes, c))))
                for c in itertools.product(*(range(mesh_shape[a])
                                             for a in axes))))
    return whole, members, groups


def announce_mesh(root: int, mesh_shape=None, members=None):
    """Broadcast the next mesh whose groups the world creates — its shape
    and `members` — or None (no more meshes) from global rank `root` to
    every process of the world; returns what was sent. Each process of a
    mesh calls it with the same `root` (the mesh's first member), and so
    does each process in `follow_meshes`."""
    msg = [None if mesh_shape is None else (dict(mesh_shape),
                                            [int(g) for g in members])]
    dist.broadcast_object_list(msg, src=root)
    return msg[0]


def follow_meshes(root: int) -> None:
    """The loop of a process that has left the mesh (at an elastic
    shrink) while the others carry on: join the creation of every later
    mesh's groups (`mesh_groups` is collective over the whole world), as
    `announce_mesh` from each mesh's first member names them, until the
    last mesh's members announce None."""
    while (msg := announce_mesh(root)) is not None:
        mesh_shape, members = msg
        mesh_groups(mesh_shape, members)
        root = members[0]


@dataclasses.dataclass
class ProcessGroupEngine(CollectiveEngine):
    """The CCLO of ONE process: this rank's local shards in, its results
    out, over the processes of the world that hold the mesh.

    `members` are the global ranks of the mesh's positions in row-major
    order (the stacked engine's order): mesh rank i, at
    `np.unravel_index(i, mesh sizes)`, is global rank `members[i]`. The
    default is the whole world in rank order, so the world size must then
    equal the mesh's; a subset (the survivors of an elastic shrink) needs
    every process of the world, members or not, to create the groups in
    the same order: the others call `mesh_groups(mesh_shape, members)`
    (`follow_meshes`) while the members build the engine. Each axis's
    and each axis pair's process groups are created here, and the whole
    mesh's (`group`: the default group over the whole world, None).
    `device` defaults to `cuda:{LOCAL_RANK % device_count}` and raises
    without a card unless `device='cpu'` is passed. Every collective of
    both backends, the queue and the streaming ops run on local shards,
    and each differentiates as the stacked engine's does:
    `allgather_matmul` and `matmul_reduce_scatter` through the same
    adjoint Functions (`core/autograd.py`) on local shards, the ring step
    through `_RingPass`, whose adjoint is the reverse exchange (rank
    r + 1's gradient back to rank r), so `ring_attention`'s backward is
    the stacked one's row.
    """

    device: object = None
    members: Optional[tuple] = None

    def __post_init__(self):
        if self.device is None:
            self.device = _default_device()
        super().__post_init__()
        if not dist.is_initialized():
            raise RuntimeError(
                "ProcessGroupEngine needs an initialized process group "
                "(repro_torch.launch.procs.init_from_env or spawn)")
        self.group, self.members, groups = mesh_groups(self.mesh_shape,
                                                       self.members)
        self.global_rank = dist.get_rank()
        if self.global_rank not in self.members:
            raise ValueError(f"rank {self.global_rank} is not in the mesh's "
                             f"members {self.members}")
        #: this process's rank in the mesh (row-major): 0 writes checkpoints
        self.mesh_rank = self.members.index(self.global_rank)
        names = list(self.mesh_shape)
        self.coords = dict(zip(names, (int(c) for c in np.unravel_index(
            self.mesh_rank, tuple(self.mesh_shape[a] for a in names)))))
        self._transports: dict = {}
        self._checked: set = set()
        for (axes, rest), group in groups.items():
            others = [a for a in names if a not in axes]
            if any(self.coords[a] != c for a, c in zip(others, rest)):
                continue
            keys = [axes[0]] if len(axes) == 1 else [axes, axes[::-1]]
            for key in keys:
                self._transports[key] = Transport(
                    group, [self._global(self._position(key, r))
                            for r in range(self._axis_size(key))])

    # -- the process's place in the mesh -----------------------------------
    def _global(self, coords: dict) -> int:
        names = list(self.mesh_shape)
        return self.members[int(np.ravel_multi_index(
            tuple(coords[a] for a in names),
            tuple(self.mesh_shape[a] for a in names)))]

    def _position(self, axis, r: int) -> dict:
        """Mesh coordinates of communicator rank r of `axis` in this
        process's group (inner-major for an (outer, inner) pair)."""
        pos = dict(self.coords)
        if isinstance(axis, tuple):
            outer, inner = axis
            P = self.mesh_shape[outer]
            pos[inner], pos[outer] = r // P, r % P
        else:
            pos[axis] = r
        return pos

    def comm_rank(self, axis) -> int:
        """This process's rank in the communicator of `axis` (a name, or
        an (outer, inner) pair: `intra * P + pod`)."""
        if isinstance(axis, tuple):
            outer, inner = axis
            return self.coords[inner] * self.mesh_shape[outer] + \
                self.coords[outer]
        return self.coords[axis]

    def transport_stats(self) -> dict:
        """Every transport's `stats`, summed."""
        out: dict = {}
        for t in self._transports.values():
            for key, v in t.stats.items():
                out[key] = out.get(key, 0) + v
        return out

    @property
    def stack_shape(self) -> tuple:
        return ()

    # -- the hooks the collective methods run through -----------------------
    def _tensor(self, x):
        return torch.as_tensor(x, device=self.device)

    def _layout(self, x, axis):
        x = self._tensor(x)
        lay = _LocalLayout([], [], (), 1, self._axis_size(axis), axis=axis,
                           rank=self.comm_rank(axis))
        return x.unsqueeze(0), lay

    def _execute(self, sched, rows, lay, compression=None):
        prog = sched.compile(codec=compression, verify=self.verify)
        self._agree(prog, lay.axis, rows[0])
        out = execute_program_local(prog, rows[0], lay.rank,
                                    self._transports[lay.axis])
        return out.unsqueeze(0)

    def _agree(self, prog: Program, axis, buf) -> None:
        """Raise unless every process of the communicator runs this
        program on a buffer of this shape. Each process all-gathers a
        fingerprint the first time it meets one, so a divergence raises
        only where the programs are new on every rank; where one rank
        issues a program it has checked before and another a new one, the
        second waits alone and fails at the group timeout instead."""
        self._agree_on(axis, _fingerprint(prog, buf.shape, buf.dtype),
                       f"different programs ({prog.name}, {prog.segments} "
                       f"segments here)")

    def _agree_on(self, axis, fp: str, what: str) -> None:
        if (axis, fp) in self._checked:
            return
        t = self._transports[axis]
        got = [None] * len(t.ranks)
        dist.all_gather_object(got, fp, group=t.group)
        if len(set(got)) != 1:
            raise RuntimeError(
                f"ranks of {axis!r} run {what}: every process must issue "
                f"the same collectives with the same arguments")
        self._checked.add((axis, fp))

    def _streaming(self, name: str, axis, tensors, **args) -> list:
        """A streaming op's operands on this process's device, after every
        process of `axis` is found to call the op with the same signature
        (op, shapes, dtypes, arguments) — all-gathered the first time a
        signature is met, as `_agree` does for programs, so a mismatch
        raises instead of hanging in a ring step."""
        ts = [self._tensor(t) for t in tensors]
        if self._axis_size(axis) > 1:
            sig = (name, tuple((tuple(t.shape), str(t.dtype)) for t in ts),
                   tuple(sorted(args.items())))
            self._agree_on(axis, hashlib.sha256(repr(sig).encode())
                           .hexdigest(), f"different {name} calls ({sig} "
                           f"here)")
        return ts

    # -- what differs one rank per process -----------------------------------
    def send_recv(self, x, axis: str, shift: int = 1):
        """Rank (r + shift) % n receives rank r's x: one send, one
        receive, no program."""
        x = self._tensor(x).contiguous()
        n, r = self._axis_size(axis), self.comm_rank(axis)
        if shift % n == 0:
            return x.clone()
        out = torch.empty_like(x)
        self._transports[axis].exchange([((r + shift) % n, 0, x)],
                                        [((r - shift) % n, 0, out)])
        return out

    def allgather_matmul(self, x, w, axis: str, segments: int = 1,
                         keep_gathered: bool = False):
        if _autograd.needed(x, w):
            return _autograd.AllGatherMatmul.apply(self, x, w, axis,
                                                   segments)
        x, w = self._streaming("allgather_matmul", axis, (x, w),
                               segments=segments)
        return super().allgather_matmul(x, w, axis, segments, keep_gathered)

    def matmul_reduce_scatter(self, x, w, axis: str, segments: int = 1):
        if _autograd.needed(x, w):
            return _autograd.MatmulReduceScatter.apply(self, x, w, axis,
                                                       segments)
        x, w = self._streaming("matmul_reduce_scatter", axis, (x, w),
                               segments=segments)
        return super().matmul_reduce_scatter(x, w, axis, segments)

    def ring_attention(self, q, k, v, axis: str, *, causal: bool = True,
                       scale: Optional[float] = None, segments: int = 1):
        q, k, v = self._streaming("ring_attention", axis, (q, k, v),
                                  causal=causal, scale=scale,
                                  segments=segments)
        return super().ring_attention(q, k, v, axis, causal=causal,
                                      scale=scale, segments=segments)

    def _ring_pass(self, parts: list, lay: _Layout) -> list:
        """One ring step as one exchange: every block of `parts` (one row
        each) to rank r + 1 and a fresh block from rank r - 1, each under
        its own tag. Differentiable (`_RingPass`) where a block requires
        grad."""
        if _autograd.needed(*parts):
            return list(_RingPass.apply(self, lay, *parts))
        return self._ring_exchange(parts, lay, 1)

    def _ring_exchange(self, parts, lay: _Layout, shift: int) -> list:
        """Every block to rank r + shift, a fresh block from r - shift."""
        n, r = lay.n, lay.rank
        got = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
               for t in parts]
        self._transports[lay.axis].exchange(
            [((r + shift) % n, i, t[0]) for i, t in enumerate(parts)],
            [((r - shift) % n, i, t[0]) for i, t in enumerate(got)])
        return got

    # -- the native backend: one torch.distributed collective each ----------
    def _native(self, rows, lay: _Layout, op: str):
        t = self._transports[lay.axis]
        out = rows[0].clone(memory_format=torch.contiguous_format)
        t.collective(lambda w, _w: dist.all_reduce(
            w, op=_DIST_OP[op], group=t.group), out)
        return out.unsqueeze(0)

    def _native_reduce_scatter(self, flat, lay: _Layout, op: str):
        t = self._transports[lay.axis]
        out = flat.new_empty((flat.shape[1] // lay.n,))
        t.collective(lambda w, o: dist.reduce_scatter(
            o, list(w.chunk(lay.n)), op=_DIST_OP[op], group=t.group),
            flat[0], out)
        return out.unsqueeze(0)

    def _native_allgather(self, flat, lay: _Layout):
        t = self._transports[lay.axis]
        out = flat.new_empty((lay.n * flat.shape[1],))
        t.collective(lambda w, o: dist.all_gather(
            list(o.chunk(lay.n)), w, group=t.group), flat[0], out)
        return out.unsqueeze(0)

    def _native_bcast(self, rows, lay: _Layout, root: int):
        t = self._transports[lay.axis]
        out = rows[0].clone(memory_format=torch.contiguous_format)
        t.collective(lambda w, _w: dist.broadcast(
            w, src=t.ranks[root], group=t.group), out)
        return out.unsqueeze(0)

    def _native_alltoall(self, rows, lay: _Layout):
        t = self._transports[lay.axis]
        out = torch.empty_like(rows[0],
                              memory_format=torch.contiguous_format)
        t.collective(lambda w, o: dist.all_to_all_single(
            o, w, group=t.group), rows[0], out)
        return out.unsqueeze(0)


class _RingPass(torch.autograd.Function):
    """One ring step (`ProcessGroupEngine._ring_exchange`, shift 1) with
    its adjoint: the gradient of the block rank r received from r - 1
    goes back to r - 1, so the backward is the reverse exchange (shift
    -1) — what the stacked engine's index permutation transposes to."""

    @staticmethod
    def forward(ctx, engine, lay, *parts):
        ctx.engine, ctx.lay = engine, lay
        return tuple(engine._ring_exchange(parts, lay, 1))

    @staticmethod
    def backward(ctx, *grads):
        back = ctx.engine._ring_exchange([g.contiguous() for g in grads],
                                         ctx.lay, -1)
        return (None, None) + tuple(back)
