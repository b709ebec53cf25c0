"""CollectiveEngine — the CCLO on one device, every rank stacked.

Port of `repro/core/engine.py`. The control plane is unchanged: the
selector prices the compiled candidates, the generator emits a Schedule
(microcode) and the compiler lowers it to a verified micro-op Program.
The data plane is ONE executor, `execute_program`, over a RANK-STACKED
tensor: all ranks of a communicator live on one device as one tensor
whose leading dim is the rank. A SEND is then an index permutation along
that dim — the bulk-synchronous meaning of the reference's
`lax.ppermute`, and of its numpy model `repro/core/simulator.py`, whose
structure this executor follows:

  * every selector `sel.fn(rank, step)` is evaluated in Python per rank,
    and the per-rank regions become one gather / one scatter over all
    ranks (index tensors cached per region);
  * the program runs batch by batch of its walk (`program.batches`, the
    per-process executor's too): a LOOP iteration, a STACKED_RECV, or
    one exchange. Every exchange of a batch reads the batch-start state
    and the writes land at its end — or straight away, where the
    compiled program proves that no exchange reads what another writes;
  * STREAM and STREAM_CHAIN run as their unfused per-step equivalent at
    the program's segment granularity (the fusion passes prove the two
    orders value-identical);
  * the codec path is the reference's `_exchange_update`: compress at
    send, decompress at consume (fused into the combine, `plugins`),
    segment counts from `fit_segments` with the codec's block.

A plain combining exchange launches K1 once over all its segments and
ranks, reading both operands in place through the region indices. Where
the program proves it safe, K1 writes its result straight into the
buffer through the target index, and a plain copy exchange is one launch
of the indexed copy (the reference is pure: the port updates its own
clone of the input in place); elsewhere the result lands in a fresh
tensor that is scattered after, and a copy gathers its payload first. An
int8 exchange launches K2 once over all its segments and ranks, reading
the payload in place ("at send"), then K3 once, reading the combine
target in place ("at consume"); a relay exchange adds one K3 copy of the
wire for its raw arrivals. The streaming
API
(`allgather_matmul`, `matmul_reduce_scatter`) computes each ring step's
products for every rank in one K4 launch.

Inputs and outputs are stacked by MESH position: the engine's
`mesh_shape` dims lead every tensor, e.g. `(n, ...)` for `{"x": n}` and
`(P, M, ...)` for `{"pod": P, "data": M}`. A collective over one axis
runs every group along the other axes at once; a two-axis collective
over `(outer, inner)` uses the reference's inner-major flat rank
`r = intra * P + pod`. `backend="native"` computes the same results with
torch reductions over the rank dim — the software-MPI baseline role.

Training differentiates through the engine: `allreduce`,
`reduce_scatter`, `allgather`, `alltoall`, `allgather_matmul` and
`matmul_reduce_scatter` enter a `torch.autograd.Function`
(`core/autograd.py`) whenever grad is enabled and an input requires it,
whose backward issues the adjoint collective through this engine.

The non-blocking request API (`issue`, the `i*` helpers, `issue_multi`,
`itree_allreduce`) defers these same calls through the engine's
`Sequencer` (`core/sequencer.py`, the offload queue), on the same
mesh-stacked operands.

`core/procgroup.py` runs the same engine one rank per process: its
`ProcessGroupEngine` takes each process's local shard (`stack_shape`
is `()`), and its `execute_program_local` runs the same programs with
real point-to-point transfers.
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import autograd as _autograd
from repro_torch.core import hierarchical, plugins, telemetry
from repro_torch.core.algorithms import GENERATORS
from repro_torch.core.hw_spec import HwSpec, TPU_V5E
from repro_torch.core.plugins import Compressed
from repro_torch.core.program import (
    SRC_ORIGINAL, SRC_RECEIVED, Compress, Copy, Program, Send, batches,
    fit_segments,
)
from repro_torch.core.schedule import (
    SEL_ALL, SEL_CHUNK, SEL_MASK, SEL_RANGE, Schedule,
)
from repro_torch.core.selector import Selector
from repro_torch.core.topology import ProductComm, axis_comm, product_comm
from repro_torch.kernels import ops as kops
from repro_torch.kernels._index import gather_regions as _gather
from repro_torch.kernels._index import scatter_regions as _scatter


# --------------------------------------------------------------------------
# Region helpers (RxBuf manager placement), evaluated per rank
# --------------------------------------------------------------------------

def _spans(sel, chunks: int, length: int, rank: int, step) -> tuple:
    """((row_start, rows), ...) of the region `sel` names in one rank's
    buffer of `length` rows, in payload order."""
    if sel.kind == SEL_ALL:
        return ((0, length),)
    csize = length // chunks
    if sel.kind == SEL_CHUNK:
        return ((int(sel.fn(rank, step)) * csize, csize),)
    if sel.kind == SEL_RANGE:
        off, ln = sel.fn(rank, step)
        return ((int(off) * csize, int(ln) * csize),)
    if sel.kind == SEL_MASK:
        return tuple((int(j) * csize, csize) for j in sel.fn(rank, step))
    raise ValueError(sel.kind)


# (rows, spans, k, device) -> (unit, row index, unit index); bounded FIFO
_INDEX_CACHE: dict = {}
_INDEX_CACHE_MAX = 4096


def _region_index(rows: tuple, spans: tuple, k: int, device) -> tuple:
    """Gather indices for a region of many ranks cut into `k` segments.

    `rows[i]` is a stacked row and `spans[i]` its region. The buffer is
    viewed in units of `unit` rows (the gcd of every span and of the
    segment length), and the index is laid out (k, ranks, units/k) so
    that segment j of every rank is one contiguous block of the gather.
    """
    key = (rows, spans, k, str(device))
    hit = _INDEX_CACHE.get(key)
    live = telemetry.LIVE
    if hit is not None:
        if live is not None:
            live.count("region_index.hit")
        return hit
    if live is not None:
        live.count("region_index.miss")
    total = sum(ln for _s, ln in spans[0])
    unit = total // k
    for sp in spans:
        for start, ln in sp:
            unit = math.gcd(unit, math.gcd(start, ln))
    unit = max(unit, 1)
    units = np.stack([
        np.concatenate([np.arange(s // unit, (s + ln) // unit)
                        for s, ln in sp] or [np.zeros(0, np.int64)])
        for sp in spans])
    uidx = units.reshape(len(rows), k, -1).transpose(1, 0, 2)
    res = (unit,
           torch.as_tensor(np.asarray(rows, np.int64).reshape(1, -1, 1),
                           device=device),
           torch.as_tensor(np.ascontiguousarray(uidx), device=device))
    if len(_INDEX_CACHE) >= _INDEX_CACHE_MAX:
        _INDEX_CACHE.pop(next(iter(_INDEX_CACHE)))
    _INDEX_CACHE[key] = res
    return res


# --------------------------------------------------------------------------
# Wire pipeline (SEG_LOOP / COMPRESS / SEND / DECOMPRESS)
# --------------------------------------------------------------------------

def _split_wire(mid_ops: tuple):
    """Split the wire micro-ops at the SEND: ([COMPRESS?, SEND],
    [DECOMPRESS?]). The send half runs at transmit time; the decompress
    half runs at consume time, fused into the combine plugin."""
    for i, op in enumerate(mid_ops):
        if isinstance(op, Send):
            return mid_ops[:i + 1], mid_ops[i + 1:]
    raise ValueError("exchange without a SEND op")


def _fit_segments(seg_len: int, segments) -> int:
    """Largest k <= segments that divides seg_len (>= 1); see
    `program.fit_segments` (the reference's name for the streaming
    fusions)."""
    return fit_segments(seg_len, segments)


def _codec_of(send_ops: tuple):
    for op in send_ops:
        if isinstance(op, Compress):
            return plugins.get_codec(op.codec)
    return None


def _ends(body: tuple, n: int, step) -> tuple:
    """(COPY('load'), SEND, RECV_COMBINE, codec or None, {receiver:
    sender}, the receivers in rank order) of one exchange of an n-rank
    program."""
    load, recv = body[0], body[-1]
    send_ops, _dec_ops = _split_wire(body[1:-1])
    send = send_ops[-1]
    src_of = {d: s for (s, d) in send.perm}
    dsts = sorted(recv.dsts) if recv.dsts is not None else list(range(n))
    missing = [d for d in dsts if d not in src_of]
    if missing:
        raise ValueError(f"step {step}: ranks {missing} receive nothing "
                         f"but mask_recv=False")
    if recv.track_recv and len(dsts) != n:
        raise ValueError("relay='received' needs every rank to receive")
    return load, send, recv, _codec_of(send_ops), src_of, dsts


def _segments(rows: int, k_req: int, row_elems: int, codec) -> int:
    """An exchange's segment count: the largest k <= k_req that cuts its
    payload of `rows` rows into whole codec blocks (`fit_segments`)."""
    if k_req <= 1:
        return 1
    return fit_segments(rows, k_req, row_elems,
                        codec.block_elems if codec is not None else 1)


def exchange_path(codec, recv, in_place: bool) -> str:
    """The kernels an exchange runs on:

      'in_place'  a plain combine's K1 or a plain copy's indexed copy,
                  writing the buffer through the target index, where the
                  program proves it safe (`in_place`);
      'indexed'   a plain combine's K1, reading payload and target in
                  place into a fresh result;
      'codec'     the codec's whole-exchange hooks (int8: K2 at send, K3
                  at consume);
      'gather'    the operands copied out first: a relay register, bf16,
                  a deferred copy.

    A codec exchange, a relay register and an op K1 does not compute
    never write in place, whatever the program proves."""
    plain = codec is None and not recv.track_recv
    if plain and in_place and (recv.op == "copy" or
                               recv.op in kops.COMBINE_OPS):
        return "in_place"
    if plain and recv.op in kops.COMBINE_OPS:
        return "indexed"
    if codec is not None and codec.compress_at is not None and \
            codec.consume_at is not None:
        return "codec"
    return "gather"


def _segment_wire(codec, inc):
    """A payload gathered as (k, ranks, seg) as it crosses on the 'gather'
    path: itself, or each segment compressed, stacked in segment
    order."""
    if codec is None:
        return inc
    ws = [codec.compress(inc[j]) for j in range(inc.shape[0])]
    return Compressed(*(torch.stack([getattr(w, f) for w in ws])
                        for f in Compressed._fields))


def _consume(buf, tgt_idx, recv, codec, path, arrival):
    """An exchange's receiving half on `path` (`exchange_path`), into the
    region `tgt_idx` of the rank-stacked `buf`, for every rank the index
    holds. `arrival` is what the path reads: (tensor, region index) of
    the payload, read in place by K1 or the indexed copy ('in_place',
    'indexed'), else the wire: the codec's compressed exchange ('codec')
    or `_segment_wire`'s ('gather'). 'in_place' writes the buffer; every
    other path computes the new region values from the current state
    without writing it. Returns (new values (k, ranks, seg) or None where
    written, the raw arrival a relay register keeps or None)."""
    op, track = recv.op, recv.track_recv
    if path == "in_place":
        if op == "copy":
            kops.region_copy(*arrival, buf, tgt_idx)
        else:
            kops.fused_combine_at(buf, tgt_idx, *arrival, op, in_place=True)
        return None, None
    if path == "indexed":
        return kops.fused_combine_at(buf, tgt_idx, *arrival, op), None
    unit, _rows, uidx = tgt_idx
    k, seg = uidx.shape[0], uidx.shape[2] * unit * math.prod(buf.shape[2:])
    if path == "codec":
        raw = codec.decompress(arrival, (seg,), buf.dtype).reshape(
            k, -1, seg) if track else None
        return codec.consume_at(arrival, buf, tgt_idx, op), raw
    if codec is None:
        if op == "copy":
            return arrival, (arrival if track else None)
        out = _gather(buf, tgt_idx)
        for j in range(k):
            plugins.combine(op, out[j], arrival[j], out=out[j])
        return out, (arrival if track else None)
    out = _gather(buf, tgt_idx) if op != "copy" else \
        torch.empty((k, uidx.shape[1], seg), dtype=buf.dtype,
                    device=buf.device)
    raw = torch.empty_like(out) if track else None
    for j in range(k):
        wire = Compressed(arrival.payload[j], arrival.scale[j])
        if raw is not None:
            raw[j] = codec.decompress(wire, (seg,), buf.dtype)
        codec.consume(wire, out[j], op, out=out[j])          # at consume
    return out, raw


# --------------------------------------------------------------------------
# The executor (the DMP): one path for every collective
# --------------------------------------------------------------------------

def _chunk_permute(buf, chunks: int, ranks: tuple, src_chunk) -> torch.Tensor:
    """Local chunk rotation (the Bruck pre/post COPY micro-ops): row i,
    of rank ranks[i], gets as its chunk j its old chunk
    src_chunk(ranks[i], j)."""
    idx = np.array([[src_chunk(r, j) for j in range(chunks)] for r in ranks],
                   np.int64)
    grp = buf.reshape(buf.shape[0], chunks, -1)
    rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
    out = grp[rows, torch.as_tensor(idx, device=buf.device)]
    return out.reshape(buf.shape)


class _State:
    """Per-run registers: the rank-stacked buffer, whose row i holds rank
    `ranks[i]`, the relay registers, and the recorder of the run's
    exchange spans (`telemetry.NULL` when none records)."""

    def __init__(self, prog: Program, buf, ranks: tuple, tr=telemetry.NULL):
        self.n, self.chunks, self.relay = prog.nranks, prog.chunks, prog.relay
        self.ranks, self.tr, self.buf = ranks, tr, buf
        self._hold()

    def _hold(self) -> None:
        """The relay registers take the buffer as it stands before step 0
        (relay='received': step 0 forwards the input)."""
        self.orig = self.buf.clone() if self.relay == SRC_ORIGINAL else None
        self.prev = self.buf.clone() if self.relay == SRC_RECEIVED else None

    def roll(self, kind: str) -> None:
        """Bruck pre / post: each row's chunks rotated by its rank."""
        c = self.chunks
        if kind == "bruck_pre":
            self.buf = _chunk_permute(self.buf, c, self.ranks,
                                      lambda r, j: (j + r) % c)
            self._hold()
        else:
            self.buf = _chunk_permute(
                self.buf, c, self.ranks,
                lambda r, j: c - 1 - ((j - r - 1) % c))

    def source(self, which: str):
        if which == SRC_ORIGINAL:
            return self.orig
        if which == SRC_RECEIVED:
            return self.prev
        return self.buf


def _apply(st: _State, tgt_idx, new_val, raw) -> None:
    """Land one pending write: new region values (None: written in place
    already), and the raw arrival into the relay register."""
    if new_val is not None:
        _scatter(st.buf, tgt_idx, new_val)
    if raw is not None:
        # the relay register holds the raw arrival, payload-shaped
        st.prev = raw.transpose(0, 1).reshape(
            (st.buf.shape[0], -1) + tuple(st.buf.shape[2:]))


def _run_exchange(st: _State, body: tuple, k_req: int, step,
                  in_place: bool):
    """One exchange over every rank, under an `exchange` span tagged with
    its path (`exchange_path`), segments and whether it wrote in place.

    body = (Copy('load'), [Compress], Send, [Decompress], RecvCombine).
    Where `in_place` (the batch's proof) allows and a kernel can, the
    exchange writes the buffer as it runs; else it computes the new
    region values from the current state, so the writes of a batch land
    after every exchange of it has read. While a span records, counts
    the exchange into `exchange.in_place` or `exchange.deferred`. Returns
    the pending write: (target index, new values or None where written,
    raw arrivals or None)."""
    load, _send, recv, codec, src_of, dsts = _ends(body, st.n, step)
    path = exchange_path(codec, recv, in_place)
    with st.tr.span("exchange", track="engine", step=step, path=path) as sp:
        src_t, buf, n = st.source(load.source), st.buf, st.n
        pay_spans = tuple(_spans(load.sel, st.chunks, src_t.shape[1],
                                 src_of[d], step) for d in dsts)
        tgt_spans = tuple(_spans(recv.sel, st.chunks, buf.shape[1], d, step)
                          for d in dsts)
        pay_rows = sum(ln for _s, ln in pay_spans[0])
        view_rows = sum(ln for _s, ln in tgt_spans[0])
        if pay_rows != view_rows:
            raise ValueError(f"step {step}: payload of {pay_rows} rows "
                             f"cannot land in a region of {view_rows} rows")
        k = _segments(pay_rows, k_req, math.prod(buf.shape[2:]), codec)
        groups = range(buf.shape[0] // n)
        pay_idx = _region_index(
            tuple(g * n + src_of[d] for g in groups for d in dsts),
            pay_spans * len(groups), k, buf.device)
        tgt_idx = _region_index(tuple(g * n + d for g in groups
                                      for d in dsts),
                                tgt_spans * len(groups), k, buf.device)
        live = telemetry.LIVE
        if live is not None:
            live.count("exchange.in_place" if path == "in_place"
                       else "exchange.deferred")
        if path in ("in_place", "indexed"):
            arrival = (src_t, pay_idx)
        elif path == "codec":
            arrival = codec.compress_at(src_t, pay_idx)         # at send
        else:
            arrival = _segment_wire(codec, _gather(src_t, pay_idx))
        new_val, raw = _consume(buf, tgt_idx, recv, codec, path, arrival)
        sp.add(segments=k, in_place=new_val is None)
    return tgt_idx, new_val, raw


def execute_program(prog: Program, buf, *, groups: int = 1):
    """Execute a compiled micro-op Program on a rank-stacked buffer.

    `buf` is (groups * prog.nranks, L, ...): row g * nranks + r is rank r
    of group g, and every group runs the program independently (the
    other mesh axes of a one-axis collective). L must be divisible by
    prog.chunks. Hierarchical programs run through their flat perms.
    Returns the final buffer (a new tensor; `buf` is not modified: the
    run updates a clone of it, in place where the program proves it).

    This is the single data plane: every collective the engine issues —
    whatever the algorithm, codec, or segment count — runs through here,
    batch by batch of the program's walk (`program.batches`): every
    exchange of a batch through `_run_exchange`, then the batch's pending
    writes in order. While the wall-clock recorder records
    (`telemetry.wall()`), the run is an `execute_program` span and each
    exchange an `exchange` span.
    """
    if buf.ndim < 2 or buf.shape[0] != groups * prog.nranks:
        raise ValueError(f"buffer of shape {tuple(buf.shape)} is not "
                         f"{groups} x {prog.nranks} stacked ranks")
    if buf.shape[1] % prog.chunks:
        raise ValueError(
            f"buffer leading dim {buf.shape[1]} not divisible by "
            f"{prog.chunks} chunks")
    tr = telemetry.wall()
    with tr.span("execute_program", track="engine", program=prog.name,
                 segments=prog.segments, codec=prog.codec):
        st = _State(prog, buf.contiguous().clone(),
                    tuple(r % prog.nranks for r in range(buf.shape[0])), tr)
        for item in batches(prog):
            if isinstance(item, Copy):
                st.roll(item.kind)
                continue
            pending = [_run_exchange(st, body, k_req, step, item.in_place)
                       for body, k_req, step in item.exchanges]
            for write in filter(None, pending):
                _apply(st, *write)
        return st.buf


# --------------------------------------------------------------------------
# Engine
# --------------------------------------------------------------------------

def _flatten_pad(xs, mult: int):
    """Stacked (R, *local) -> (R, Lp) with each rank's flat local array
    zero-padded to a multiple of `mult`; also the local shape and size."""
    shape = tuple(xs.shape[1:])
    flat = xs.reshape(xs.shape[0], -1)
    size = flat.shape[1]
    pad = (-size) % mult
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat, shape, size


def _tree_leaves(tree) -> tuple:
    """(leaves, unflatten) for a pytree of dicts, lists and tuples of
    mesh-stacked tensors: the leaves in the reference's order (jax
    sorts dict keys, torch's pytree keeps insertion order), and the
    function that rebuilds `tree`'s structure from leaves in that
    order."""
    from torch.utils import _pytree as pytree
    pairs, spec = pytree.tree_flatten_with_path(tree)

    def key(path):
        return tuple(getattr(k, "key", getattr(k, "idx", None))
                     for k in path)

    order = sorted(range(len(pairs)), key=lambda i: key(pairs[i][0]))

    def unflatten(vals):
        out = [None] * len(vals)
        for j, i in enumerate(order):
            out[i] = vals[j]
        return pytree.tree_unflatten(out, spec)

    return [pairs[i][1] for i in order], unflatten


def _local_numel(leaf, lead: tuple) -> int:
    return leaf.numel() // math.prod(lead)


def _bucket_leaves(leaves, cap: int, lead: tuple) -> list:
    """dtype-grouped, size-capped buckets over leaf indices — the ONE
    bucketing rule both `tree_allreduce` and `itree_allreduce` apply.
    Caps count one rank's bytes, so the plan is the reference's for the
    same tree; dtypes group in the order each first appears."""
    groups: dict = {}
    for i, leaf in enumerate(leaves):
        groups.setdefault(leaf.dtype, []).append(i)
    buckets: list[list[int]] = []
    for dtype, idxs in groups.items():
        cur, cur_bytes = [], 0
        for i in idxs:
            nbytes = _local_numel(leaves[i], lead) * dtype.itemsize
            if cur and cur_bytes + nbytes > cap:
                buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += nbytes
        if cur:
            buckets.append(cur)
    return buckets


def _fuse_bucket(leaves, idxs, lead: tuple):
    """The bucket's leaves joined along each rank's flat local dims."""
    if len(idxs) == 1:
        return leaves[idxs[0]].reshape(lead + (-1,))
    return torch.cat([leaves[i].reshape(lead + (-1,)) for i in idxs],
                     dim=-1)


def _scatter_bucket(leaves, idxs, buf, out, lead: tuple) -> None:
    off = 0
    for i in idxs:
        leaf = leaves[i]
        n = _local_numel(leaf, lead)
        out[i] = buf[..., off:off + n].reshape(leaf.shape)
        off += n


@dataclasses.dataclass
class _TreeTicket:
    """Handle for an in-flight `itree_allreduce`: the bucket requests
    sit in the engine's queue until `wait()` drains them and scatters
    the fused buffers back into the tree."""

    unflatten: object
    leaves: list
    lead: tuple
    plan: list                      # [(leaf indices, Request), ...]

    def wait(self):
        out: list = [None] * len(self.leaves)
        for idxs, req in self.plan:
            _scatter_bucket(self.leaves, idxs, req.wait(), out, self.lead)
        return self.unflatten(out)


def _find_generator(collective: str, algorithm: str):
    gen = GENERATORS.get((collective, algorithm))
    if gen is None:
        gen = plugins.custom_generator(collective, algorithm)
    if gen is None:
        raise KeyError(
            f"no generator for ({collective!r}, {algorithm!r}); "
            f"register one via plugins.register_collective")
    return gen


def _gen_schedule(collective: str, algorithm: str, comm,
                  root: int = 0, op: str = "add") -> Schedule:
    levels = hierarchical.parse_hier_name(algorithm) \
        if isinstance(algorithm, str) else None
    if levels is not None:
        if not isinstance(comm, ProductComm):
            raise ValueError(
                f"{algorithm!r} needs a two-axis (ProductComm) "
                f"communicator, got {comm!r}")
        intra, inter = levels
        return hierarchical.hierarchical_schedule(
            collective, comm, intra=intra, inter=inter, root=root, op=op)
    if isinstance(comm, ProductComm):
        # a flat algorithm requested over the product group: generate over
        # the equivalent flat communicator — the engine executes it
        # sequentially per axis (level_sizes stays None)
        comm = comm.flat
    gen = _find_generator(collective, algorithm)
    params = inspect.signature(gen).parameters
    kw = {}
    if "root" in params:
        kw["root"] = root
    if "op" in params:
        kw["op"] = op
    return gen(comm, **kw)


def _api_span(fn):
    """A collective of the engine's API under a root span
    `engine.<name>` (the input's bytes; the algorithm and segments
    `_resolve` picks) while the wall-clock recorder records: one gate
    read a call."""
    name = "engine." + fn.__name__

    @functools.wraps(fn)
    def call(self, x, *args, **kwargs):
        with telemetry.wall().span(name, track="engine",
                                   bytes=int(getattr(x, "nbytes", 0))):
            return fn(self, x, *args, **kwargs)

    return call


def _engine_metrics() -> telemetry.MetricsRegistry:
    reg = telemetry.MetricsRegistry()
    reg.counter("gen_calls")
    reg.counter("sched_cache_hits")
    return reg


_NATIVE_REDUCE = {
    "add": lambda t: t.sum(1),
    "max": lambda t: t.amax(1),
    "min": lambda t: t.amin(1),
}


@dataclasses.dataclass
class _Layout:
    """How a mesh-stacked tensor maps onto (groups * n, *local) rows."""

    moved: list
    dst: list
    lead: tuple
    groups: int
    n: int
    axis: object = None          # the collective's axis (or axis pair)

    def restore(self, ys):
        ys = ys.reshape(self.lead + tuple(ys.shape[1:]))
        return ys.movedim(self.dst, self.moved)

    def row_ranks(self) -> list:
        """Each stacked row's rank inside its collective group."""
        return list(range(self.n)) * self.groups

    def rank_of_rows(self, device):
        """`row_ranks` as a tensor on `device`."""
        return torch.as_tensor(self.row_ranks(), device=device)


@dataclasses.dataclass
class CollectiveEngine:
    """ACCL+ CCLO analogue over a mesh of ranks stacked on one device.

    mesh_shape: {axis: size}, in the order the stacked tensors' leading
    dims follow. device: where the stacked tensors live; "cuda" (the
    default) runs the kernels and raises when no card is present, "cpu"
    runs their plain versions. backend: 'microcode' (our schedules — the
    CCLO) or 'native' (torch reductions — the software-MPI baseline).
    """

    mesh_shape: dict
    backend: str = "microcode"
    hw: HwSpec = TPU_V5E
    selector: Selector = dataclasses.field(default_factory=Selector)
    device: object = "cuda"
    # static-verifier level applied to every program this engine compiles
    # ("off" | "structural" | "full"; None = REPRO_VERIFY env default) —
    # see core/verify.py
    verify: Optional[str] = None
    # log of issued collectives (for tests / EXPERIMENTS tables)
    trace_log: list = dataclasses.field(default_factory=list)
    # schedule cache: (collective, algorithm, n, root, op) -> Schedule.
    # Repeated collectives hit this instead of re-running the generator
    # (the uC caches compiled microcode).
    _sched_cache: dict = dataclasses.field(default_factory=dict)
    # control-plane telemetry (`stats` below is the read-compatible
    # mapping view over this registry)
    metrics: telemetry.MetricsRegistry = dataclasses.field(
        default_factory=_engine_metrics)
    _queue: object = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        self.mesh_shape = dict(self.mesh_shape)
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CollectiveEngine: no CUDA device is available; pass "
                "device='cpu' to run the plain versions on the host")

    # -- infrastructure ------------------------------------------------------
    def comm(self, axis):
        """Communicator for one mesh axis, or a `ProductComm` for a
        two-axis tuple (outer pod-crossing axis first)."""
        if isinstance(axis, tuple):
            outer_ax, inner_ax = axis
            return product_comm(self.mesh_shape, outer_ax, inner_ax, self.hw)
        return axis_comm(self.mesh_shape, axis, self.hw)

    def _axis_size(self, axis) -> int:
        if isinstance(axis, tuple):
            n = 1
            for a in axis:
                n *= self.mesh_shape[a]
            return n
        return self.mesh_shape[axis]

    @property
    def queue(self):
        """The engine's `Sequencer` (created on first use)."""
        if self._queue is None:
            from repro_torch.core.sequencer import Sequencer
            self._queue = Sequencer(self)
        return self._queue

    @property
    def stack_shape(self) -> tuple:
        """The mesh dims that lead every operand and result: the mesh
        shape, ranks stacked (`core/procgroup.py`'s per-process engine:
        `()`, one rank's local shard)."""
        return tuple(self.mesh_shape.values())

    @property
    def stats(self) -> telemetry.StatsView:
        """Read-compatible mapping view over `metrics` (legacy name)."""
        return self.metrics.view()

    def _tensor(self, x):
        x = torch.as_tensor(x, device=self.device)
        lead = self.stack_shape
        if tuple(x.shape[:len(lead)]) != lead:
            raise ValueError(
                f"input of shape {tuple(x.shape)} is not stacked over the "
                f"mesh {self.mesh_shape}")
        return x

    def _layout(self, x, axis):
        """(rows, layout): `x` as (groups * n, *local) stacked rows, the
        collective's ranks innermost (inner-major for a two-axis tuple:
        row = group * n + intra * P + pod)."""
        x = self._tensor(x)
        names = list(self.mesh_shape)
        D = len(names)
        if isinstance(axis, tuple):
            outer_ax, inner_ax = axis
            moved = [names.index(inner_ax), names.index(outer_ax)]
        else:
            moved = [names.index(axis)]
        dst = list(range(D - len(moved), D))
        xt = x.movedim(moved, dst)
        lead = tuple(xt.shape[:D])
        n = self._axis_size(axis)
        groups = math.prod(lead) // n
        rows = xt.reshape((groups * n,) + tuple(xt.shape[D:]))
        return rows, _Layout(moved, dst, lead, groups, n, axis=axis)

    def _cached_schedule(self, collective: str, algorithm: str,
                         comm, root: int, op: str) -> Schedule:
        # a product communicator keys on its level split, not just the
        # flat rank count — a 4x4 product and a flat 16 must not collide
        shape = ((comm.outer.size, comm.inner.size)
                 if isinstance(comm, ProductComm) else comm.size)
        key = (collective, algorithm, shape, root, op)
        sched = self._sched_cache.get(key)
        live = telemetry.LIVE
        if sched is not None:
            self.metrics.inc("sched_cache_hits")
            if live is not None:
                live.count("schedule.cache_hit")
            return sched
        self.metrics.inc("gen_calls")
        if live is not None:
            live.count("schedule.gen")
        sched = _gen_schedule(collective, algorithm, comm, root, op)
        self._sched_cache[key] = sched
        return sched

    def _resolve(self, collective: str, x, axis, algorithm: str,
                 root: int = 0, op: str = "add",
                 segments: Optional[int] = None,
                 compression: Optional[str] = None) -> Schedule:
        """Pick algorithm + segment count; return the (cached) schedule.

        `x` is ONE rank's local array (the selector prices per-rank
        bytes). The returned schedule carries the chosen segment count in
        `.segments` (caller-supplied `segments` overrides the selector).
        While the wall-clock recorder records, the pick is an
        `engine.resolve` span and its outcome annotates the API's span.
        """
        tr = telemetry.wall()
        with tr.span("engine.resolve", track="engine") as sp:
            comm = self.comm(axis)
            nbytes = x.numel() * x.element_size()
            if algorithm in (None, "auto"):
                # alltoall executes on the caller's 2-D leading-dim grid,
                # so the selector clamps candidate segments on rows, not
                # the flat element count (priced k == executed k)
                lead = int(x.shape[0]) if collective == "alltoall" \
                    and x.ndim else None
                choice = self.selector.choose(
                    collective, nbytes, comm, codec=compression,
                    elem_bytes=x.element_size(), lead_dim=lead)
                algorithm = choice.algorithm
                if segments is None:
                    segments = choice.segments
                if root == 0 and op == "add":
                    # the auto pick already generated exactly this schedule
                    sched = choice.schedule
                else:
                    sched = self._cached_schedule(collective, algorithm,
                                                  comm, root, op)
            else:
                sched = self._cached_schedule(collective, algorithm, comm,
                                              root, op)
            sched = sched.with_segments(segments if segments else 1)
            sp.add(algorithm=algorithm, segments=sched.segments,
                   msg_bytes=int(nbytes))
        tr.annotate(algorithm=algorithm, segments=sched.segments)
        self.trace_log.append((collective, algorithm, axis, int(nbytes)))
        return sched

    def _execute(self, sched: Schedule, rows, lay: _Layout,
                 compression: Optional[str] = None):
        """Compile (memoized; an `engine.compile` span while the
        wall-clock recorder records) and run through the one data
        plane."""
        with telemetry.wall().span("engine.compile", track="engine"):
            prog = sched.compile(codec=compression, verify=self.verify)
        return execute_program(prog, rows, groups=lay.groups)

    def _own_chunks(self, sched: Schedule, out, lay: _Layout):
        """Each rank's owned chunk of a 'shard' result."""
        own = [sched.owned_chunk(r) for r in lay.row_ranks()]
        grp = out.reshape(out.shape[0], sched.chunks, -1)
        rows = torch.arange(out.shape[0], device=out.device)
        return grp[rows, torch.as_tensor(own, device=out.device)]

    def _place_own(self, flat, lay: _Layout, slots):
        """(R, n * F) zeros with each rank's flat input at its slot."""
        R, F = flat.shape
        buf = torch.zeros((R, lay.n, F), dtype=flat.dtype, device=flat.device)
        rows = torch.arange(R, device=flat.device)
        buf[rows, slots] = flat
        return buf.reshape(R, lay.n * F)

    # -- the native backend and the ring step: the hooks a per-process
    # engine (`core/procgroup.py`) overrides. Each takes and returns
    # stacked rows; `lay` names the collective's ranks and axis.
    def _native(self, rows, lay: _Layout, op: str):
        """Native allreduce (the reference's `lax.psum` / `pmax` /
        `pmin`): every rank ends with the reduction of its group."""
        g = rows.reshape((lay.groups, lay.n) + tuple(rows.shape[1:]))
        red = _NATIVE_REDUCE[op](g)
        return red.unsqueeze(1).expand(g.shape).reshape(rows.shape)

    def _native_reduce_scatter(self, flat, lay: _Layout, op: str):
        """Native reduce-scatter of flat (R, size) rows: rank r gets slice
        r of the reduction, (R, size / n) (`lax.psum_scatter`)."""
        n = lay.n
        g = flat.reshape(lay.groups, n, n, flat.shape[1] // n)
        return _NATIVE_REDUCE[op](g).reshape(lay.groups * n, -1)

    def _native_allgather(self, flat, lay: _Layout):
        """Native all-gather of flat (R, F) rows: every rank ends with the
        concat of its group's rows, (R, n * F) (`lax.all_gather`)."""
        g = flat.reshape(lay.groups, 1, lay.n * flat.shape[1])
        return g.expand(lay.groups, lay.n, g.shape[2]).reshape(
            lay.groups * lay.n, -1)

    def _native_bcast(self, rows, lay: _Layout, root: int):
        """Native broadcast: every rank ends with rank `root`'s rows."""
        g = rows.reshape((lay.groups, lay.n) + tuple(rows.shape[1:]))
        return g[:, root:root + 1].expand(g.shape).reshape(rows.shape)

    def _native_alltoall(self, rows, lay: _Layout):
        """Native all-to-all, tiled on each rank's leading dim: block j of
        rank r's result is block r of rank j's rows (`lax.all_to_all`)."""
        n = lay.n
        rest = tuple(rows.shape[2:])
        g = rows.reshape((lay.groups, n, n, rows.shape[1] // n) + rest)
        return g.transpose(1, 2).reshape(rows.shape)

    def _ring_pass(self, parts: list, lay: _Layout) -> list:
        """One step of a streaming op's ring (`ring_perm(1)`): rank r
        receives rank r - 1's block of every tensor in `parts` (one copy
        each: rank n - 1's block, then ranks 0 .. n - 2's)."""
        out = []
        for t in parts:
            g = t.reshape((lay.groups, lay.n) + tuple(t.shape[1:]))
            out.append(torch.cat([g[:, -1:], g[:, :-1]], dim=1)
                       .reshape(t.shape))
        return out

    # -- two-axis (hierarchical) dispatch ------------------------------------
    def _flatten_pad_mesh(self, x, mult: int):
        """Mesh-stacked x -> mesh-stacked flat local arrays padded to
        `mult`; also the local shape and size."""
        D = len(self.stack_shape)
        shape = tuple(x.shape[D:])
        flat = x.reshape(tuple(x.shape[:D]) + (-1,))
        size = flat.shape[-1]
        pad = (-size) % mult
        if pad:
            flat = torch.nn.functional.pad(flat, (0, pad))
        return flat, shape, size

    def _sequential_product(self, collective: str, x, axis: tuple, *,
                            op: str = "add", root: int = 0,
                            compression: Optional[str] = None):
        """Per-axis composition over (outer, inner): the fallback the
        engine executes when a FLAT algorithm wins the product pricing
        (or the backend is native) — one single-axis collective per
        level, each re-resolved on its own fabric."""
        outer_ax, inner_ax = axis
        P = self.mesh_shape[outer_ax]
        x = self._tensor(x)
        D = len(self.stack_shape)
        if collective == "allreduce":
            M = self.mesh_shape[inner_ax]
            flat, shape, size = self._flatten_pad_mesh(x, M)
            shard = self.reduce_scatter(flat, inner_ax, op=op,
                                        compression=compression)
            shard = self.allreduce(shard, outer_ax, op=op,
                                   compression=compression)
            full = self.allgather(shard, inner_ax)
            return full[..., :size].reshape(tuple(x.shape[:D]) + shape)
        if collective == "reduce_scatter":
            # inner-major rank map: slice r of (RS inner -> RS outer) is
            # exactly flat slice r = intra * P + pod
            shard = self.reduce_scatter(x, inner_ax, op=op,
                                        compression=compression)
            return self.reduce_scatter(shard, outer_ax, op=op,
                                       compression=compression)
        if collective == "allgather":
            part = self.allgather(x, outer_ax)
            return self.allgather(part, inner_ax)
        if collective == "bcast":
            # inner first: after it every member of the root's pod
            # (pod index root % P) holds the data; the outer bcast then
            # fans each intra slot's copy across pods
            y = self.bcast(x, inner_ax, root=root // P)
            return self.bcast(y, outer_ax, root=root % P)
        raise ValueError(f"no two-axis composition for {collective!r}")

    def _product_collective(self, collective: str, x, axis: tuple, *,
                            op: str = "add", root: int = 0,
                            algorithm: str = "auto",
                            compression: Optional[str] = None,
                            segments: Optional[int] = None):
        """Collective over a two-axis (outer, inner) product group.

        Resolves against the `ProductComm`: a hierarchical pick executes
        as ONE two-level program over the inner-major flat ranks; a flat
        pick executes as the sequential per-axis composition it was
        priced against. A size-1 level degenerates to the ordinary
        single-axis path.
        """
        outer_ax, inner_ax = axis

        def single(ax):
            if collective == "allreduce":
                return self.allreduce(x, ax, op=op, algorithm=algorithm,
                                      compression=compression,
                                      segments=segments)
            if collective == "reduce_scatter":
                return self.reduce_scatter(x, ax, op=op,
                                           algorithm=algorithm,
                                           compression=compression,
                                           segments=segments)
            if collective == "allgather":
                return self.allgather(x, ax, algorithm=algorithm,
                                      segments=segments)
            return self.bcast(x, ax, root=root, algorithm=algorithm,
                              segments=segments)

        if self.mesh_shape[outer_ax] == 1:
            return single(inner_ax)
        if self.mesh_shape[inner_ax] == 1:
            return single(outer_ax)
        if self.backend == "native" and algorithm in (None, "auto"):
            return self._sequential_product(collective, x, axis, op=op,
                                            root=root,
                                            compression=compression)
        if collective == "bcast" and root != 0:
            # the two-level bcast composition is root=0 only (see
            # hierarchical.hier_bcast); other roots run per axis
            return self._sequential_product("bcast", x, axis, root=root)
        rows, lay = self._layout(x, axis)
        sched = self._resolve(collective, rows[0], axis, algorithm,
                              root=root, op=op, segments=segments,
                              compression=compression)
        if sched.level_sizes is None:
            return self._sequential_product(collective, x, axis, op=op,
                                            root=root,
                                            compression=compression)
        if collective == "reduce_scatter":
            if rows[0].numel() % sched.chunks:
                raise ValueError(
                    f"reduce_scatter size {rows[0].numel()} % "
                    f"{sched.chunks} != 0")
            flat = rows.reshape(rows.shape[0], -1)
            out = self._execute(sched, flat, lay, compression)
            return lay.restore(self._own_chunks(sched, out, lay))
        if collective == "allgather":
            flat = rows.reshape(rows.shape[0], -1)
            buf = self._place_own(flat, lay, lay.rank_of_rows(flat.device))
            return lay.restore(self._execute(sched, buf, lay))
        # allreduce / bcast: full result, chunk-padded like the flat path
        flat, shape, size = _flatten_pad(rows, sched.chunks)
        out = self._execute(sched, flat, lay, compression)
        return lay.restore(out[:, :size].reshape((-1,) + shape))

    # -- MPI-like API (paper Listing 1) --------------------------------------
    @_api_span
    def allreduce(self, x, axis, op: str = "add",
                  algorithm: str = "auto",
                  compression: Optional[str] = None,
                  segments: Optional[int] = None):
        if _autograd.needed(x):
            return _autograd.AllReduce.apply(
                self, x, axis, op, dict(algorithm=algorithm,
                                        compression=compression,
                                        segments=segments))
        if isinstance(axis, tuple):
            return self._product_collective(
                "allreduce", x, axis, op=op, algorithm=algorithm,
                compression=compression, segments=segments)
        rows, lay = self._layout(x, axis)
        if lay.n == 1:
            return self._tensor(x)
        if self.backend == "native" and algorithm in (None, "auto") \
                and op in _NATIVE_REDUCE:
            return lay.restore(self._native(rows, lay, op))
        sched = self._resolve("allreduce", rows[0], axis, algorithm, op=op,
                              segments=segments, compression=compression)
        # Padding stays a function of chunks alone so the chunk layout —
        # and hence the elementwise reduction order — is identical at
        # every segment count.
        flat, shape, size = _flatten_pad(rows, sched.chunks)
        out = self._execute(sched, flat, lay, compression)
        return lay.restore(out[:, :size].reshape((-1,) + shape))

    @_api_span
    def reduce_scatter(self, x, axis, op: str = "add",
                       algorithm: str = "auto",
                       compression: Optional[str] = None,
                       segments: Optional[int] = None):
        """Tiled semantics on the flattened array: rank r gets slice r of
        the reduction. Input size must be divisible by the rank count."""
        if _autograd.needed(x):
            return _autograd.ReduceScatter.apply(
                self, x, axis, op, dict(algorithm=algorithm,
                                        compression=compression,
                                        segments=segments))
        if isinstance(axis, tuple):
            return self._product_collective(
                "reduce_scatter", x, axis, op=op, algorithm=algorithm,
                compression=compression, segments=segments)
        rows, lay = self._layout(x, axis)
        n = lay.n
        if n == 1:
            return self._tensor(x)
        size = rows[0].numel()
        if size % n:
            raise ValueError(f"reduce_scatter size {size} % {n} != 0")
        flat = rows.reshape(rows.shape[0], -1)
        if self.backend == "native" and algorithm in (None, "auto") \
                and op in _NATIVE_REDUCE:
            return lay.restore(self._native_reduce_scatter(flat, lay, op))
        sched = self._resolve("reduce_scatter", rows[0], axis, algorithm,
                              op=op, segments=segments,
                              compression=compression)
        out = self._execute(sched, flat, lay, compression)
        return lay.restore(self._own_chunks(sched, out, lay))

    @_api_span
    def allgather(self, x, axis, algorithm: str = "auto",
                  segments: Optional[int] = None):
        """Tiled: returns concat of every rank's flat x (own shard at
        position rank)."""
        if _autograd.needed(x):
            return _autograd.AllGather.apply(
                self, x, axis, dict(algorithm=algorithm, segments=segments))
        if isinstance(axis, tuple):
            return self._product_collective(
                "allgather", x, axis, algorithm=algorithm,
                segments=segments)
        rows, lay = self._layout(x, axis)
        flat = rows.reshape(rows.shape[0], -1)
        if lay.n == 1:
            return lay.restore(flat)
        if self.backend == "native" and algorithm in (None, "auto"):
            return lay.restore(self._native_allgather(flat, lay))
        sched = self._resolve("allgather", rows[0], axis, algorithm,
                              segments=segments)
        buf = self._place_own(flat, lay, lay.rank_of_rows(flat.device))
        return lay.restore(self._execute(sched, buf, lay))

    def bcast(self, x, axis, root: int = 0, algorithm: str = "auto",
              segments: Optional[int] = None):
        if isinstance(axis, tuple):
            return self._product_collective(
                "bcast", x, axis, root=root, algorithm=algorithm,
                segments=segments)
        rows, lay = self._layout(x, axis)
        if lay.n == 1:
            return self._tensor(x)
        if self.backend == "native" and algorithm in (None, "auto"):
            return lay.restore(self._native_bcast(rows, lay, root))
        sched = self._resolve("bcast", rows[0], axis, algorithm, root=root,
                              segments=segments)
        flat, shape, size = _flatten_pad(rows, sched.chunks)
        out = self._execute(sched, flat, lay)
        return lay.restore(out[:, :size].reshape((-1,) + shape))

    def reduce(self, x, axis: str, root: int = 0, op: str = "add",
               algorithm: str = "auto", segments: Optional[int] = None):
        """MPI semantics: result meaningful at `root` only (other ranks may
        hold partial reductions, depending on the algorithm)."""
        rows, lay = self._layout(x, axis)
        if lay.n == 1:
            return self._tensor(x)
        if self.backend == "native" and algorithm in (None, "auto"):
            return lay.restore(self._native(rows, lay, "add"))
        sched = self._resolve("reduce", rows[0], axis, algorithm, root=root,
                              op=op, segments=segments)
        flat, shape, size = _flatten_pad(rows, sched.chunks)
        out = self._execute(sched, flat, lay)
        return lay.restore(out[:, :size].reshape((-1,) + shape))

    def gather(self, x, axis: str, root: int = 0, algorithm: str = "auto"):
        """Root ends with concat of all ranks' flat x (others undefined)."""
        rows, lay = self._layout(x, axis)
        flat = rows.reshape(rows.shape[0], -1)
        n = lay.n
        if n == 1:
            return lay.restore(flat)
        if self.backend == "native" and algorithm in (None, "auto"):
            return lay.restore(self._native_allgather(flat, lay))
        sched = self._resolve("gather", rows[0], axis, algorithm, root=root)
        rank = lay.rank_of_rows(flat.device)
        slots = rank if sched.chunk_coords == "absolute" \
            else (rank - root) % n
        out = self._execute(sched, self._place_own(flat, lay, slots), lay)
        if sched.chunk_coords == "relative":
            grp = out.reshape(out.shape[0], n, -1)
            out = torch.roll(grp, root, dims=1).reshape(out.shape[0], -1)
        return lay.restore(out)

    @_api_span
    def alltoall(self, x, axis: str, algorithm: str = "auto",
                 segments: Optional[int] = None):
        """Tiled on leading dim: block j of the output came from rank j."""
        if _autograd.needed(x):
            return _autograd.AllToAll.apply(
                self, x, axis, dict(algorithm=algorithm, segments=segments))
        rows, lay = self._layout(x, axis)
        n = lay.n
        if n == 1:
            return self._tensor(x)
        if rows.shape[1] % n:
            raise ValueError(f"alltoall dim0 {rows.shape[1]} % {n} != 0")
        if self.backend == "native" and algorithm in (None, "auto"):
            return lay.restore(self._native_alltoall(rows, lay))
        sched = self._resolve("alltoall", rows[0], axis, algorithm,
                              segments=segments)
        return lay.restore(self._execute(sched, rows, lay))

    def collective(self, name: str, x, axis: str, *,
                   algorithm: str = "auto", root: int = 0, op: str = "add",
                   compression: Optional[str] = None,
                   segments: Optional[int] = None):
        """Run a collective registered via `plugins.register_collective`.

        The paper's "new collectives without re-synthesis" path: an
        out-of-tree schedule generator lowers through the same selector,
        compiler, and `execute_program` data plane as the built-ins.
        Result convention follows the schedule: 'shard' returns each
        rank's owned chunk, anything else the full (trimmed) buffer.
        """
        rows, lay = self._layout(x, axis)
        if lay.n == 1:
            return self._tensor(x)
        sched = self._resolve(name, rows[0], axis, algorithm, root=root,
                              op=op, segments=segments,
                              compression=compression)
        size = rows[0].numel()
        if sched.result == "shard" and size % sched.chunks:
            # a shard result returns one raw chunk — padding would hand
            # some rank silent zeros (reduce_scatter applies the same rule)
            raise ValueError(
                f"{name} returns shards: input size {size} must be "
                f"divisible by {sched.chunks} chunks")
        flat, shape, size = _flatten_pad(rows, sched.chunks)
        out = self._execute(sched, flat, lay, compression)
        if sched.result == "shard":
            return lay.restore(self._own_chunks(sched, out, lay))
        return lay.restore(out[:, :size].reshape((-1,) + shape))

    def send_recv(self, x, axis: str, shift: int = 1):
        """Neighbour exchange along a ring (the paper's send/recv pair):
        rank (r + shift) % n receives rank r's x."""
        rows, lay = self._layout(x, axis)
        g = rows.reshape((lay.groups, lay.n) + tuple(rows.shape[1:]))
        return lay.restore(torch.roll(g, shift, dims=1).reshape(rows.shape))

    def barrier(self, axis: str):
        """1-element allreduce, like the paper's barrier collective."""
        return self.allreduce(
            torch.zeros(self.stack_shape + (1,), dtype=torch.float32,
                        device=self.device), axis, algorithm="auto")

    def nop(self):
        """Engine invocation NOP (fig8 latency benchmark)."""
        return torch.zeros((), dtype=torch.int32, device=self.device)

    # -- non-blocking request API (the collective offload queue) -------------
    #
    # SIGNATURE CONTRACT: `CollectiveEngine.issue` / `issue_multi` are
    # thin delegates of `Sequencer.issue` / `Sequencer.issue_multi` and
    # accept the identical public call shapes — same parameter order,
    # same `after=None` / `timeout=None` keyword-only defaults (the
    # sequencer's `_pre`/`_post`/`_shape` hooks are private plumbing the
    # engine surface does not expose). The `i*` helpers fix the
    # collective name and otherwise take `issue`'s keywords.
    def issue(self, collective: str, x, axis: str, *, after=None,
              timeout: Optional[float] = None, **kwargs):
        """Enqueue a collective without executing it; returns a `Request`
        handle immediately (the CCLO request-queue contract — paper use
        case 1). `x` is a mesh-stacked tensor or another `Request` (a
        dependency edge: this call consumes that request's result).
        Materialize with `Request.wait()` or `engine.queue.drain()`; the
        queue keeps per-communicator FIFO order, infers conflict edges
        from tensor identity (override with `after=`), enforces `timeout`
        (virtual seconds) on the simulated drain's clock, and coalesces
        consecutive small same-(op, dtype) reductions into one bucketed
        program — see `core/sequencer.py`. Remaining keywords are those
        of the blocking method (`op`, `root`, `algorithm`,
        `compression`, `segments`).
        """
        return self.queue.issue(collective, x, axis, after=after,
                                timeout=timeout, **kwargs)

    def issue_multi(self, x, axes, op: str = "add",
                    algorithm: str = "auto",
                    compression: Optional[str] = None):
        """Non-blocking `allreduce_multi`: the hierarchical multi-axis
        allreduce as queued work (`Sequencer.issue_multi` — two live
        axes fold into one tuple-axis request; more chain RS ->
        recurse -> AG with dependency edges)."""
        return self.queue.issue_multi(x, axes, op=op, algorithm=algorithm,
                                      compression=compression)

    def iallreduce(self, x, axis: str, *, after=None,
                   timeout: Optional[float] = None, **kwargs):
        """Non-blocking `allreduce` (MPI_Iallreduce analogue)."""
        return self.issue("allreduce", x, axis, after=after,
                          timeout=timeout, **kwargs)

    def ireduce_scatter(self, x, axis: str, *, after=None,
                        timeout: Optional[float] = None, **kwargs):
        """Non-blocking `reduce_scatter`."""
        return self.issue("reduce_scatter", x, axis, after=after,
                          timeout=timeout, **kwargs)

    def iallgather(self, x, axis: str, *, after=None,
                   timeout: Optional[float] = None, **kwargs):
        """Non-blocking `allgather`."""
        return self.issue("allgather", x, axis, after=after,
                          timeout=timeout, **kwargs)

    def ibcast(self, x, axis: str, *, after=None,
               timeout: Optional[float] = None, **kwargs):
        """Non-blocking `bcast`."""
        return self.issue("bcast", x, axis, after=after,
                          timeout=timeout, **kwargs)

    def ireduce(self, x, axis: str, *, after=None,
                timeout: Optional[float] = None, **kwargs):
        """Non-blocking `reduce`."""
        return self.issue("reduce", x, axis, after=after,
                          timeout=timeout, **kwargs)

    def ialltoall(self, x, axis: str, *, after=None,
                  timeout: Optional[float] = None, **kwargs):
        """Non-blocking `alltoall`."""
        return self.issue("alltoall", x, axis, after=after,
                          timeout=timeout, **kwargs)

    def icollective(self, name: str, x, axis: str, *, after=None,
                    timeout: Optional[float] = None, **kwargs):
        """Non-blocking plugin-registered collective (`collective`)."""
        return self.issue(name, x, axis, after=after,
                          timeout=timeout, **kwargs)

    # -- hierarchical multi-axis collectives (multi-pod path) ----------------
    def allreduce_multi(self, x, axes: Sequence[str], op: str = "add",
                        algorithm: str = "auto",
                        compression: Optional[str] = None):
        """Hierarchical allreduce over several axes, fastest axis first.

        RS over axes[0] -> recurse over the rest on 1/n of the bytes -> AG
        back over axes[0]; two live axes run as ONE two-level program
        over the (outer, inner) product instead.
        """
        axes = [a for a in axes if self.mesh_shape[a] > 1]
        if not axes:
            return self._tensor(x)
        if len(axes) == 1:
            return self.allreduce(x, axes[0], op=op, algorithm=algorithm,
                                  compression=compression)
        if len(axes) == 2:
            # axes are ordered fastest first, so the slow pod-crossing
            # axis is the last one (the outer level of the product)
            return self.allreduce(x, (axes[1], axes[0]), op=op,
                                  algorithm=algorithm,
                                  compression=compression)
        x = self._tensor(x)
        D = len(self.stack_shape)
        n0 = self.mesh_shape[axes[0]]
        flat, shape, size = self._flatten_pad_mesh(x, n0)
        shard = self.reduce_scatter(flat, axes[0], op=op,
                                    algorithm=algorithm,
                                    compression=compression)
        shard = self.allreduce_multi(shard, axes[1:], op=op,
                                     algorithm=algorithm,
                                     compression=compression)
        full = self.allgather(shard, axes[0], algorithm=algorithm)
        return full[..., :size].reshape(tuple(x.shape[:D]) + shape)

    # -- gradient-bucket collectives (offload-engine H2H role) ---------------
    #: default gradient-bucket cap (one rank's bytes)
    BUCKET_BYTES = 4 << 20

    def tree_allreduce(self, tree, axes: Sequence[str], op: str = "add",
                       compression: Optional[str] = None,
                       algorithm: str = "auto",
                       bucket_bytes: Optional[int] = None):
        """Bucketed pytree allreduce: fused collectives over leaf groups.

        `tree` is a dict / list / tuple of mesh-stacked tensors. Leaves
        are grouped by dtype (a bf16 leaf ships 2 bytes per element, no
        upcast) and packed into buckets of at most `bucket_bytes` per
        rank; each bucket is one `allreduce_multi`.
        """
        leaves, unflatten = _tree_leaves(tree)
        if not leaves:
            return tree
        lead = self.stack_shape
        cap = bucket_bytes if bucket_bytes is not None else self.BUCKET_BYTES
        out: list = [None] * len(leaves)
        for idxs in _bucket_leaves(leaves, cap, lead):
            buf = self.allreduce_multi(_fuse_bucket(leaves, idxs, lead),
                                       axes, op=op, algorithm=algorithm,
                                       compression=compression)
            _scatter_bucket(leaves, idxs, buf, out, lead)
        return unflatten(out)

    def itree_allreduce(self, tree, axes: Sequence[str], op: str = "add",
                        compression: Optional[str] = None,
                        algorithm: str = "auto",
                        bucket_bytes: Optional[int] = None):
        """Non-blocking `tree_allreduce`: every bucket's hierarchical
        allreduce is ISSUED into the request queue up front and a ticket
        is returned; `ticket.wait()` drains the requests and rebuilds
        the tree. Tickets collected before any wait share the queue, so
        small same-dtype buckets coalesce into one program."""
        leaves, unflatten = _tree_leaves(tree)
        lead = self.stack_shape
        cap = bucket_bytes if bucket_bytes is not None else self.BUCKET_BYTES
        plan = []
        for idxs in _bucket_leaves(leaves, cap, lead):
            req = self.queue.issue_multi(_fuse_bucket(leaves, idxs, lead),
                                         axes, op=op, algorithm=algorithm,
                                         compression=compression)
            plan.append((idxs, req))
        return _TreeTicket(unflatten=unflatten, leaves=leaves, lead=lead,
                           plan=plan)

    # -- streaming API (paper Listing 2): compute fused with communication ---
    def _matmul(self, a, b, out_dtype=None):
        """Every rank's local product in one call: K4 on the card, its
        plain version on the CPU — fp32 accumulation either way (the
        reference's `preferred_element_type=f32`), cast to `out_dtype`
        (default a.dtype)."""
        return kops.matmul(a, b, out_dtype or a.dtype)

    @_api_span
    def allgather_matmul(self, x, w, axis: str, segments: int = 1,
                         keep_gathered: bool = False):
        """y = allgather(x, rows) @ w without staging the gathered buffer.

        Each ring step multiplies the resident shard of every rank (one
        K4 launch over the stack) while the next shard is on the wire.
        x: mesh-stacked (m, k) local rows; w: mesh-stacked (k, p); out:
        mesh-stacked (n*m, p). segments > 1 row-splits the shard into
        independent segment pipelines, as the reference does.
        keep_gathered also returns the shards the ring brought, placed as
        `allgather(x)` places them (n*m, k): the backward's dw reads them
        as the reference's transpose reads its saved ring residuals, with
        no second gather.
        """
        if _autograd.needed(x, w):
            return _autograd.AllGatherMatmul.apply(self, x, w, axis,
                                                   segments)
        x = self._tensor(x)
        w = self._tensor(w)
        rows, lay = self._layout(x, axis)
        n = lay.n
        if n == 1:
            y = self._matmul(x, w)
            return (y, x) if keep_gathered else y
        wrows, _ = self._layout(w, axis)
        R, m, p = rows.shape[0], rows.shape[1], wrows.shape[-1]
        segs = _fit_segments(m, segments)
        sub = m // segs
        parts = list(rows.split(sub, dim=1))
        out = torch.zeros((R, n, m, p), dtype=x.dtype, device=x.device)
        kept = torch.empty((R, n) + tuple(rows.shape[1:]), dtype=x.dtype,
                           device=x.device) if keep_gathered else None
        at = torch.arange(R, device=x.device)
        rank = lay.rank_of_rows(x.device)
        tr = telemetry.wall()
        for s in range(n):
            # at step s every rank holds rank (r - s) % n's shard
            with tr.span("exchange", track="engine", step=s, path="ring"):
                for j, part in enumerate(parts):
                    out[at, (rank - s) % n, j * sub:(j + 1) * sub] = \
                        self._matmul(part, wrows)
                    if kept is not None:
                        kept[at, (rank - s) % n, j * sub:(j + 1) * sub] = \
                            part
                if s < n - 1:
                    parts = self._ring_pass(parts, lay)
        self.trace_log.append(("allgather_matmul", "ring", axis,
                               int(rows[0].numel() * rows.element_size())))
        y = lay.restore(out.reshape(R, n * m, p))
        if kept is None:
            return y
        return y, lay.restore(kept.reshape((R, n * m)
                                           + tuple(rows.shape[2:])))

    @_api_span
    def matmul_reduce_scatter(self, x, w, axis: str, segments: int = 1):
        """Row-sharded output of (x @ w) with the partial-sum reduction
        streamed around the ring. x: mesh-stacked (m, k_local); w:
        mesh-stacked (k_local, p); out: mesh-stacked (m/n, p) — rank r
        holds row-chunk r, fully summed.

        Every rank's partial product is one K4 launch; the ring adds are
        plain adds in the reference's order (arriving accumulator +
        local chunk), so equal partials give bitwise equal results.
        segments > 1 splits the rotating accumulator into independent
        row-segment pipelines."""
        if _autograd.needed(x, w):
            return _autograd.MatmulReduceScatter.apply(self, x, w, axis,
                                                       segments)
        x = self._tensor(x)
        w = self._tensor(w)
        partial = self._matmul(x, w)
        rows, lay = self._layout(partial, axis)
        n = lay.n
        if n == 1:
            return partial
        R, m, p = rows.shape[0], rows.shape[1], rows.shape[2]
        if m % n:
            raise ValueError(f"matmul_reduce_scatter rows {m} % {n} != 0")
        c = m // n
        segs = _fit_segments(c, segments)
        sub = c // segs
        chunks = rows.reshape(R, n, c, p)       # [row, chunk]
        at = torch.arange(R, device=partial.device)
        rank = lay.rank_of_rows(partial.device)

        def chunk(s, j):
            """Every rank's local row-chunk (rank - 1 - s) % n, segment j."""
            return chunks[at, (rank - 1 - s) % n, j * sub:(j + 1) * sub]

        accs = [chunk(0, j) for j in range(segs)]
        tr = telemetry.wall()
        for s in range(1, n):
            with tr.span("exchange", track="engine", step=s, path="ring"):
                accs = [a + chunk(s, j)
                        for j, a in enumerate(self._ring_pass(accs, lay))]
        self.trace_log.append(("matmul_reduce_scatter", "ring", axis,
                               int(rows[0].numel() * rows.element_size())))
        out = accs[0] if segs == 1 else torch.cat(accs, dim=1)
        return lay.restore(out.reshape(R, c, p))

    def ring_attention(self, q, k, v, axis: str, *, causal: bool = True,
                       scale: Optional[float] = None, segments: int = 1):
        """Context-parallel attention: the streaming API generalized.

        q: mesh-stacked (B, S_local, H, hd); k, v: mesh-stacked (B,
        S_local, KV, hd), H % KV == 0. The SEQUENCE is sharded over
        `axis` (rank r holds positions [r S_local, (r + 1) S_local)).
        KV blocks rotate around the ring (`ring_perm(1)`: rank r receives
        r - 1's block, so at step s it holds rank (r - s) % n's) while
        every rank flash-accumulates attention for its local queries —
        one stacked einsum per step for all ranks. Scores and the PV
        accumulator are fp32 (q and k upcast exactly, as the reference's
        `preferred_element_type`); p is rounded to v's dtype before the
        PV product. `segments` splits each KV block into independent
        sequence segments, as the reference does. No kernel and no
        engine program runs: the rotation is `_ring_pass` (the
        reference's raw `lax.ppermute`). Returns mesh-stacked (B,
        S_local, H, hd) in q's dtype.
        """
        q, k, v = self._tensor(q), self._tensor(k), self._tensor(v)
        qrows, lay = self._layout(q, axis)
        krows, _ = self._layout(k, axis)
        vrows, _ = self._layout(v, axis)
        n = lay.n
        R, b, sl, h, hd = qrows.shape
        kv = krows.shape[3]
        g = h // kv
        if scale is None:
            scale = 1.0 / (hd ** 0.5)
        qr = qrows.reshape(R, b, sl, kv, g, hd).float()
        if n == 1:
            s = torch.einsum("rbqkgh,rbskh->rbkgqs", qr,
                             krows.float()) * scale
            if causal:
                mask = torch.ones((sl, sl), dtype=torch.bool,
                                  device=q.device).tril()
                s = torch.where(mask, s, -1e30)
            p = torch.softmax(s, dim=-1)
            out = torch.einsum("rbkgqs,rbskh->rbkgqh",
                               p.to(v.dtype).float(), vrows.float())
            out = out.to(v.dtype).permute(0, 1, 4, 2, 3, 5)
            return lay.restore(out.reshape(R, b, sl, h, hd))

        rank = lay.rank_of_rows(q.device)                      # (R,)
        q_pos = rank[:, None] * sl + torch.arange(sl, device=q.device)
        m = torch.full((R, b, kv, g, sl), -1e30, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((R, b, kv, g, sl), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((R, b, kv, g, sl, hd), dtype=torch.float32,
                          device=q.device)

        def accumulate(m, l, acc, kb, vb, owner, seg_off):
            k_pos = owner[:, None] * sl + seg_off + torch.arange(
                kb.shape[2], device=q.device)                  # (R, sub)
            s = torch.einsum("rbqkgh,rbskh->rbkgqs", qr, kb.float()) * scale
            if causal:
                mask = k_pos[:, None, :] <= q_pos[:, :, None]  # (R, sl, sub)
                s = torch.where(mask[:, None, None, None], s, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("rbkgqs,rbskh->rbkgqh", p.to(vb.dtype).float(),
                              vb.float())
            return m_new, l, acc * corr[..., None] + pv

        # KV blocks rotate as independent sequence segments (online
        # softmax is exact under any block split: only rounding differs)
        segs = _fit_segments(sl, segments)
        sub = sl // segs
        k_parts = list(krows.split(sub, dim=2))
        v_parts = list(vrows.split(sub, dim=2))
        for j in range(segs):
            m, l, acc = accumulate(m, l, acc, k_parts[j], v_parts[j], rank,
                                   j * sub)
        for step in range(1, n):
            moved = self._ring_pass(k_parts + v_parts, lay)
            k_parts, v_parts = moved[:segs], moved[segs:]
            owner = (rank - step) % n
            for j in range(segs):
                m, l, acc = accumulate(m, l, acc, k_parts[j], v_parts[j],
                                       owner, j * sub)
        out = (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)
        self.trace_log.append(("ring_attention", "ring", axis,
                               int(krows[0].numel() * krows.element_size())))
        out = out.permute(0, 1, 4, 2, 3, 5).reshape(R, b, sl, h, hd)
        return lay.restore(out)
