"""Counters of one eager step: the port's analogue of the HLO analyzer.

Port of `repro/launch/analysis.py`. The reference parses a compiled
module's HLO text (loop trip counts times loop bodies, because XLA's
`cost_analysis` counts a loop body once). The port compiles nothing: a
step runs eagerly, op by op, so the port counts the ops as they run —
on storage-free 'meta' tensors for the dry run (`launch/dryrun.py`),
or on the card around a real step. An eager run has no loop to
undercount: every layer and every ring step executes.

  flops        2 M N K per matrix product: aten's products by torch's
               own FLOP formulas (`torch.utils.flop_counter`), seen by a
               dispatch mode; K4, launched through ctypes and invisible
               to any dispatch mode, by its wrapper's own count
               (`kernels/ops.py::kernel_flops`). On 'meta' K4's plain
               version runs and is counted as an aten product: the two
               counts agree.
  bytes        every op's operand and result bytes, views excluded, an
               indexed read at the slice's size and an in-place update
               at the update's (`_op_bytes`) — the eager run's traffic,
               op by op (the reference's slice-aware per-instruction
               bytes), through the kernels' plain versions on 'meta'
  peak_bytes   the peak of the live bytes of the storages the call
               made, each counted from the op that made it until it is
               freed (autograd's saved tensors until the backward frees
               them)
  collectives  every program the engine executed (`_execute`), its
               wire bytes per rank by `Program.fabric_wire_bytes` on
               the executed buffer (ICI and DCN), a compressed program's
               by the bytes its exchanges send (`_coded_wire`: the int8
               codes padded to whole 256-element blocks and their
               scales, where `fabric_wire_bytes` prices 1 + 4/256 bytes
               an element); the streaming ring
               ops (`allgather_matmul`, `matmul_reduce_scatter`,
               `ring_attention`) from the engine's `trace_log`, whose
               raw permutations run no program; and every native
               collective (`backend='native'`: the engine's `_native*`
               hooks) by the reference's ring model of XLA's
               collectives (`NATIVE_WIRE`)
  reads        the storages some op or kernel entry point read, so
               `memory` can report the argument bytes a step never read
               (what jit drops from a compiled step)
  kernel calls the launches the kernel entry points imply
               (`KERNEL_ENTRIES`): on 'meta' what a run on the card
               launches

Every count is of the stacked run, all ranks together; per-rank values
divide by the rank count (`roofline_terms`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.core import engine as engine_mod
from repro_torch.kernels import ops as kops

# wire bytes per rank of a streaming ring op, from the bytes its
# trace_log entry gives and the ring size n: allgather_matmul rotates the
# x shard n - 1 times, matmul_reduce_scatter a 1/n row chunk of the
# partial product, ring_attention the k and the v block each
RING_WIRE = {
    "allgather_matmul": lambda nbytes, n: (n - 1) * nbytes,
    "matmul_reduce_scatter": lambda nbytes, n: (n - 1) * nbytes / n,
    "ring_attention": lambda nbytes, n: 2 * (n - 1) * nbytes,
}


# wire bytes per rank of a native collective, by the reference's ring
# model of the HLO collective that `lax` lowers it to
# (`repro/launch/analysis.py::analyze_hlo`: all-reduce 2 rb (g-1)/g,
# all-gather and all-to-all rb (g-1)/g, reduce-scatter rb (g-1), with
# rb one device's result bytes), from the hook's result bytes per rank
# and the group size g. A native bcast is the reference's all-gather of
# g copies (`lax.all_gather(x)[root]`), whose result is g times the
# hook's.
NATIVE_WIRE = {
    "_native": ("allreduce", lambda rb, g: 2 * rb * (g - 1) / g),
    "_native_reduce_scatter": ("reduce_scatter",
                               lambda rb, g: rb * (g - 1)),
    "_native_allgather": ("allgather", lambda rb, g: rb * (g - 1) / g),
    "_native_bcast": ("bcast", lambda rb, g: rb * (g - 1)),
    "_native_alltoall": ("alltoall", lambda rb, g: rb * (g - 1) / g),
}


def tensors(tree) -> list:
    """The tensors of a tree (dicts, lists, tuples), in order."""
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


# ops that read their first operand through indices: the slice read is
# the result's size, not the operand's
_INDEX_READS = (torch.ops.aten.index, torch.ops.aten.index_select,
                torch.ops.aten.gather, torch.ops.aten.take)


def _op_bytes(func, ins, in_keys, out, wrote: int) -> int:
    """Bytes one op moves: its operands read and its results written. An
    operand read through indices counts at the result's size; a buffer
    updated in place (or an `out=` buffer) counts at the size of the
    largest other operand (the update), or whole where there is none
    (`zero_`, `fill_`)."""
    if func._overloadpacket in _INDEX_READS:
        return 2 * wrote + sum(_nbytes(t) for t in ins[1:])
    out_keys = {t.untyped_storage()._cdata for t in tensors(out)}
    reads = [_nbytes(t) for t, k in zip(ins, in_keys) if k not in out_keys]
    if len(reads) == len(ins):
        return sum(reads) + wrote
    updated = max(reads, default=0) or sum(
        _nbytes(t) for t, k in zip(ins, in_keys) if k in out_keys)
    return sum(reads) + updated + wrote


@dataclasses.dataclass
class StepStats:
    """Counts of one call, all ranks together (see the module doc)."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    peak_bytes: int = 0          # live bytes made by the call, at peak
    end_bytes: int = 0           # ... still live when the call returned
    coll_ops: int = 0            # engine collectives (programs + rings)
    coll_wire_bytes: float = 0.0   # per rank
    coll_dcn_bytes: float = 0.0    # per rank
    coll_by_kind: dict = dataclasses.field(default_factory=dict)
    # (collective, schedule, executed buffer shape, codec, axis) per
    # program, in the order the engine ran them
    programs: list = dataclasses.field(default_factory=list)
    # keys of the storages some op or kernel entry point of the call read
    # (`memory`'s unread_argument_bytes)
    read: set = dataclasses.field(default_factory=set)
    # kernel (`kernels/ops.py::KERNELS`) -> the launches its entry points
    # imply: one per outermost call with a non-empty result, on any device
    kernel_calls: dict = dataclasses.field(default_factory=dict)


def _coded_wire(comm, body, tgt_idx, buf) -> tuple:
    """(fabric, bytes one rank sends) of one exchange of a compressed
    program: k segments of `seg` elements each (the region index the
    executor built); a compressed segment padded to whole codec blocks,
    as the codec's payload is (the int8 codes and one fp32 scale per 256
    elements), an uncompressed one (a ring's allgather phase) as it
    is."""
    send_ops, _ = engine_mod._split_wire(body[1:-1])
    codec = engine_mod._codec_of(send_ops)
    unit, _rows, uidx = tgt_idx
    seg = uidx.shape[2] * unit * math.prod(buf.shape[2:])
    if codec is None:
        nbytes = seg * buf.element_size()
    else:
        block = codec.block_elems
        nbytes = -(-seg // block) * block * codec.wire_bytes_per_elem
    level = getattr(send_ops[-1], "level", None)
    c = comm.level_comm(level) if hasattr(comm, "level_comm") else comm
    return "dcn" if c.is_dcn else "ici", uidx.shape[0] * nbytes


class _EngineTap:
    """Records the programs one engine executes and its native
    collectives. The engine resolves each program right before executing
    it, and the resolve appends its (collective, algorithm, axis, bytes)
    to `trace_log`, so the newest entry names the executed program's
    axis; a native hook's layout names its own."""

    def __init__(self, engine, stats: StepStats):
        self.engine, self.stats = engine, stats
        self.log0 = len(engine.trace_log)

    def __enter__(self):
        eng = self.engine
        self.saved = {name: eng.__dict__.get(name)
                      for name in ("_execute",) + tuple(NATIVE_WIRE)}
        real_execute = eng._execute

        def execute(sched, rows, lay, compression=None):
            axis = eng.trace_log[-1][2]
            if compression is None:
                self._program(sched, rows, axis)
                return real_execute(sched, rows, lay, compression)
            sent = {"ici": 0.0, "dcn": 0.0}
            real_exchange = engine_mod._run_exchange

            def exchange(st, body, k_req, step, in_place):
                res = real_exchange(st, body, k_req, step, in_place)
                fabric, nbytes = _coded_wire(eng.comm(axis), body, res[0],
                                             st.buf)
                sent[fabric] += nbytes
                return res

            engine_mod._run_exchange = exchange
            try:
                out = real_execute(sched, rows, lay, compression)
            finally:
                engine_mod._run_exchange = real_exchange
            self._program(sched, rows, axis, compression, sent)
            return out

        eng._execute = execute
        for name in NATIVE_WIRE:
            setattr(eng, name, self._native(name, getattr(eng, name)))
        return self

    def _native(self, name: str, real):
        kind, wire_of = NATIVE_WIRE[name]

        def hook(rows, lay, *args):
            out = real(rows, lay, *args)
            wire = wire_of(_nbytes(out[0]), lay.n)
            self._count(kind, wire,
                        wire if self.engine.comm(lay.axis).is_dcn else 0.0)
            return out
        return hook

    def __exit__(self, *exc):
        eng = self.engine
        for name, saved in self.saved.items():
            if saved is not None:
                setattr(eng, name, saved)
            else:
                delattr(eng, name)
        for name, _alg, axis, nbytes in eng.trace_log[self.log0:]:
            if name in RING_WIRE:
                n = eng._axis_size(axis)
                wire = RING_WIRE[name](nbytes, n)
                self._count(name, wire,
                            wire if eng.comm(axis).is_dcn else 0.0)
        return False

    def _count(self, kind: str, wire: float, dcn: float) -> None:
        st = self.stats
        st.coll_ops += 1
        st.coll_wire_bytes += wire
        st.coll_dcn_bytes += dcn
        k = st.coll_by_kind.setdefault(kind, [0, 0.0])
        k[0] += 1
        k[1] += wire

    def _program(self, sched, rows, axis, compression=None,
                 fab=None) -> None:
        eng = self.engine
        if fab is None:
            prog = sched.compile(codec=compression, verify=eng.verify)
            fab = prog.fabric_wire_bytes(_nbytes(rows[0]), eng.comm(axis),
                                         elem_bytes=rows.element_size())
        self.stats.programs.append((sched.collective, sched,
                                    tuple(rows.shape), compression, axis))
        self._count(sched.collective, fab["ici"] + fab["dcn"], fab["dcn"])


# the kernels' entry points (`kernels/ops.py`) and the kernel each
# launches once on the card when its result is not empty. A kernel reads
# its operands outside any dispatch mode (a ctypes launch on the card, the
# output alone on 'meta'), so `counting` marks them read at the call.
KERNEL_ENTRIES = {
    "fused_combine": "fused_combine", "fused_combine_at": "fused_combine",
    "quantize_int8": "quantize_blocks", "quantize_int8_at": "quantize_blocks",
    "dequantize_int8": "dequantize_blocks",
    "dequantize_int8_at": "dequantize_blocks", "matmul": "matmul_tiled",
    "embedding_gather": "gather_rows", "embedding_lookup_rows": "gather_rows",
    "region_copy": "region_copy",
}


@contextlib.contextmanager
def _kernel_calls(stats: StepStats):
    saved = {name: getattr(kops, name) for name in KERNEL_ENTRIES}
    depth = [0]

    def calling(name, fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            stats.read.update(t.untyped_storage()._cdata
                              for t in tensors((args, kwargs)))
            depth[0] += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                depth[0] -= 1
            res = tensors(out)
            if depth[0] == 0 and res and res[0].numel():
                kernel = KERNEL_ENTRIES[name]
                stats.kernel_calls[kernel] = \
                    stats.kernel_calls.get(kernel, 0) + 1
            return out
        return call

    for name, fn in saved.items():
        setattr(kops, name, calling(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(kops, name, fn)


class _Dispatch(TorchDispatchMode):
    """Sees every aten op of the call: products, traffic, live bytes."""

    def __init__(self, stats: StepStats):
        super().__init__()
        self.stats = stats
        self._live: dict = {}
        self._cur = 0

    def _free(self, key) -> None:
        self._cur -= self._live.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        st = self.stats
        formula = flop_registry.get(func._overloadpacket)
        if formula is None:
            # a composite op (matmul, einsum under inference_mode) runs
            # as the ops it decomposes into, each counted on its own
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if formula is not None:
            st.flops += formula(*args, **kwargs, out_val=out)
        if func.is_view:             # no data moves, no storage is made
            return out
        ins = tensors((args, kwargs))
        in_keys = [t.untyped_storage()._cdata for t in ins]
        st.read.update(in_keys)
        seen, wrote = set(in_keys), 0
        for t in tensors(out):
            storage = t.untyped_storage()
            key = storage._cdata
            if key in seen:          # an in-place or out= result
                continue
            seen.add(key)
            wrote += _nbytes(t)
            self._live[key] = storage.nbytes()
            self._cur += self._live[key]
            weakref.finalize(storage, self._free, key)
        st.bytes_accessed += _op_bytes(func, ins, in_keys, out, wrote)
        st.peak_bytes = max(st.peak_bytes, self._cur)
        return out


@contextlib.contextmanager
def counting(engines=()):
    """Counts what runs inside it; works the same on 'meta', CPU and
    CUDA tensors:

        with counting([ctx.engine]) as stats:
            step(...)
    """
    stats = StepStats()
    k4 = kops.kernel_flops()
    mode = _Dispatch(stats)
    with contextlib.ExitStack() as stack:
        for eng in engines:
            stack.enter_context(_EngineTap(eng, stats))
        stack.enter_context(_kernel_calls(stats))
        stack.enter_context(mode)
        yield stats
    stats.flops += kops.kernel_flops() - k4
    stats.end_bytes = mode._cur


def count(fn, engines=()):
    """(fn's result, StepStats of one call of `fn`)."""
    with counting(engines) as stats:
        out = fn()
    return out, stats


def arg_bytes(tree, mesh_shape: dict) -> tuple:
    """(bytes per rank, unstacked bytes) of a tree's distinct storages: a
    mesh-stacked tensor (the mesh dims leading, or behind one layer dim)
    holds every rank's copy, so one rank's share is its bytes over the
    rank count; a tensor that is not stacked (the optimizer's step count)
    is counted whole, once, as every rank would hold it."""
    lead = tuple(mesh_shape.values())
    D = len(lead)
    ranks = 1
    for s in lead:
        ranks *= s
    seen, stacked, single = set(), 0, 0
    for t in tensors(tree):
        key = t.untyped_storage()._cdata
        if key in seen:
            continue
        seen.add(key)
        shape = tuple(t.shape)
        if shape[:D] == lead or shape[1:D + 1] == lead:
            stacked += _nbytes(t)
        else:
            single += _nbytes(t)
    return stacked // ranks + single, single


def memory(args, out, st: StepStats, mesh_shape: dict) -> dict:
    """Per-rank memory of one call (the reference's `memory_analysis`
    fields): argument bytes of the inputs, output bytes of the result,
    alias bytes of the result's storages that are inputs' (the train step
    updates params and optimizer state in place, as the reference donates
    them), temp bytes the peak of the live bytes the call made less its
    new outputs, so peak_bytes_est = argument + that peak."""
    ranks = 1
    for s in mesh_shape.values():
        ranks *= s
    arg, single = arg_bytes(args, mesh_shape)
    outb, _ = arg_bytes(out, mesh_shape)
    in_keys = {t.untyped_storage()._cdata for t in tensors(args)}
    alias, _ = arg_bytes([t for t in tensors(out)
                          if t.untyped_storage()._cdata in in_keys],
                         mesh_shape)
    temp = st.peak_bytes // ranks - (outb - alias)
    unread, _ = arg_bytes([t for t in tensors(args)
                           if t.untyped_storage()._cdata not in st.read],
                          mesh_shape)
    return {"argument_bytes": arg, "output_bytes": outb, "temp_bytes": temp,
            "alias_bytes": alias,
            "peak_bytes_est": arg + outb + temp - alias,
            "unstacked_argument_bytes": single,
            "unread_argument_bytes": unread}


def roofline_terms(st: StepStats, mem: dict, hw, chips: int) -> dict:
    """Three-term roofline of one step, per rank, priced on `hw` (the
    reference's keys; `hw` names the spec). `mem` is the dry run's
    per-rank memory dict. The raw-cost keys equal the counted ones: an
    eager count has no loop undercount. A spec that is not the card's
    prices a model, not a time of the card."""
    flops_dev = st.flops / chips
    bytes_dev = st.bytes_accessed / chips
    t_compute = flops_dev / hw.peak_flops_bf16
    t_memory = bytes_dev / hw.hbm_bw
    arena = mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
    t_memory_floor = arena / hw.hbm_bw
    ici_bw = hw.ici_link_bw * hw.ici_links_per_chip
    t_coll = ((st.coll_wire_bytes - st.coll_dcn_bytes) / ici_bw
              + st.coll_dcn_bytes / hw.dcn_bw)
    dominant = max([("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)], key=lambda kv: kv[1])[0]
    return {
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "coll_wire_bytes_per_device": st.coll_wire_bytes,
        "coll_dcn_bytes_per_device": st.coll_dcn_bytes,
        "coll_ops": st.coll_ops,
        "coll_by_kind": {k: {"ops": v[0], "wire_bytes": v[1]}
                         for k, v in st.coll_by_kind.items()},
        "raw_cost_flops": flops_dev,
        "raw_cost_bytes": bytes_dev,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_memory_floor_s": t_memory_floor,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "global_flops": st.flops,
        "n_loops": 0,             # an eager run unrolls every loop
        "hw": hw.name,
    }
