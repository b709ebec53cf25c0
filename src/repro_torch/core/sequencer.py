"""Collective offload sequencer — the CCLO request queue (§5, use case 1).

Port of `repro/core/sequencer.py`. Operands are the engine's MESH-STACKED
tensors (the `mesh_shape` dims lead, one rank's local array after
them), so everything the queue prices — `Request.msg_bytes`, the
recorded result shapes, the coalescing cap, the bucket plan — counts ONE
rank's local shape, exactly what the reference sees inside `shard_map`
and what the engine's `_resolve` prices. A coalesced bucket joins its
members along the local dims, never across ranks. `simulate_drain`
keeps the reference's numpy interface (per-rank lists in and out), so
the two packages' drains compare directly.

ACCL+'s second headline role is the *collective offload engine*: a CPU
application enqueues non-blocking collective calls into the CCLO's
request queue and overlaps its own compute while the engine drains the
outstanding operations (the distributed vector-matrix use case). This
module is that queue for our reproduction:

  CollectiveEngine.issue(...) -> Request     enqueue, return immediately
  Request.wait() / Sequencer.drain()         materialize results
  Sequencer.makespan(axis)                   queue-level pricing

The `Sequencer` tracks outstanding requests per communicator (mesh axis)
with FIFO ordering — the CCLO pops its command queue in order — plus
cross-request dependency edges: two requests naming the same buffer
object conflict (the queue must not reorder them), a request whose
operand IS another `Request` depends on that request's result, and
`after=` overrides the inference. Materializing a request materializes
its FIFO prefix on the same communicator and the dependency closure
across communicators, so conflicting requests never reorder.

Coalescing (the paper's offload win for many tiny CPU-side calls):
consecutive queued small same-(axis, op, dtype) reductions collapse into
ONE bucketed program before compile — one alpha, one selector choice,
one wire crossing for the whole bucket. Coalescing is bitwise-neutral
by construction: a bucket forms only when every member AND the combined
bucket resolve to an algorithm whose elementwise combine order is
independent of element position and message size (`ORDER_SAFE` — the
SEL_ALL pairwise hypercube exchanges: every element is reduced by the
identical sequence of adds wherever it sits), so slicing the bucketed
result reproduces the unbucketed bits exactly.

Queue-level pricing (`makespan`) composes the per-program split cost
(`Program.cost_terms`) the same way the data plane's fill/drain model
prices segments: requests sharing one communicator serialize their WIRE
occupancy (one set of links), while the per-hop alpha/handshake half of
a *queued* request hides behind the wire time of the one in flight —
non-blocking issue keeps the queue primed, so the control plane never
re-enters the loop between requests. Nothing hides along a dependency
chain: dependent requests serialize their full costs, and the longest
chain lower-bounds the makespan:

    makespan = max( max over dependency chains of sum(full_i),
                    sum_i wire_i + max_i latency_i )

For a queue of independent requests this sits strictly below the sum of
blocking `Program.cost`s (all but one request's alpha is hidden); for a
fully serial chain it degenerates to exactly that sum — no credit the
drain cannot cash, mirroring the split segment-pricing model.

The numpy simulator executes drained queues over per-rank buffers
(`simulate_drain`) through the SAME compiled programs the pricing walks
(`simulator.run_collective`), so makespan and execution are validated
against one artifact. A sequencer drains either through its engine
(inside a trace) or through the simulator — not both.

The engine drain runs each request as the blocking engine call it
defers; results are rank-stacked tensors on the engine's device. On a
per-process engine (`core/procgroup.py`, `stack_shape == ()`) operands
and results are each process's local shard instead, and the contract is
SPMD: every process issues the same requests, with the same arguments,
in the same order, so that the drains plan, coalesce and run the same
programs on every rank.

Reliability (the ACCL+ fault story): every request ends in exactly one
typed terminal state — DONE, TIMED_OUT, CANCELLED, or PEER_FAILED —
never a hang. `simulate_drain` accepts a `FaultPlan` + `ReliabilityTier`
and executes the queue against the lossy fabric with a purely VIRTUAL
clock (priced program cost + retry alphas + deterministic backoff; no
wall-clock anywhere): a request whose tier-level retries recover
materializes bitwise-identical to the fault-free drain, one that cannot
ends typed, and failures cascade as CANCELLED to dependents. A
`FaultPlan` that kills a rank shrinks the communicator to the survivors
and the selector REPLANS the still-queued collectives on the degraded
fabric. `Sequencer.abort()` (or using the sequencer as a context
manager) cancels everything outstanding and provably empties the
engine's queue — no stale request survives an abandoned drain.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import numpy as np
import torch

from repro_torch.core import telemetry
from repro_torch.core.pricing import resolve_env


class RequestCancelled(RuntimeError):
    """Typed terminal error raised when a CANCELLED request is waited."""


class DrainModeError(RuntimeError):
    """A sequencer drains either through its engine or through the numpy
    simulator — never both. Mixing the two on one queue would interleave
    stacked device tensors with per-rank numpy buffers and silently
    corrupt whichever drain ran second; the first drain claims the queue
    and the other path raises this instead."""


def _size_of(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _result_shape(collective: str, shape: tuple, nranks: int) -> tuple:
    """Static LOCAL result shape of an engine collective (engine.py
    wrappers) from one rank's local operand shape.

    Custom (plugin-registered) collectives are priced/chained at their
    operand shape — good enough for the queue model; their materialized
    result follows the schedule's own convention."""
    size = _size_of(shape)
    if collective == "reduce_scatter":
        return (size // nranks,)
    if collective in ("allgather", "gather"):
        return (size * nranks,)
    return tuple(shape)


@dataclasses.dataclass(eq=False)
class Request:
    """Handle for one queued collective — the CCLO request-queue entry.

    `operand` is the issuing mesh-stacked tensor (or another Request, a
    dependency edge); `kwargs` are the engine-call keywords (op, root,
    algorithm, compression, segments). `shape`/`dtype` are the STATIC
    result signature — one rank's local result shape, known at issue
    time, so the queue prices and chains requests without materializing
    anything.

    `status` walks PENDING -> exactly one terminal state: DONE (result
    available), TIMED_OUT (deadline or retry budget exhausted),
    CANCELLED (explicit `cancel()`/`abort()` or a failed dependency),
    PEER_FAILED (a peer rank died). `timeout` is a VIRTUAL-seconds
    deadline enforced by the simulated drain's clock.
    """

    PENDING = "PENDING"
    DONE = "DONE"
    TIMED_OUT = "TIMED_OUT"
    CANCELLED = "CANCELLED"
    PEER_FAILED = "PEER_FAILED"

    rid: int
    collective: str
    axis: str
    operand: object
    kwargs: dict
    shape: tuple
    dtype: object
    deps: tuple = ()
    timeout: Optional[float] = None
    status: str = PENDING
    error: object = dataclasses.field(default=None, repr=False)
    _seq: object = dataclasses.field(default=None, repr=False)
    _pre: object = dataclasses.field(default=None, repr=False)
    _post: object = dataclasses.field(default=None, repr=False)
    _done: bool = dataclasses.field(default=False, repr=False)
    _result: object = dataclasses.field(default=None, repr=False)

    @property
    def done(self) -> bool:
        return self._done

    @property
    def failed(self) -> bool:
        return self.status in (self.TIMED_OUT, self.CANCELLED,
                               self.PEER_FAILED)

    @property
    def finished(self) -> bool:
        """Terminal (success OR typed failure) — never a hang."""
        return self._done or self.status != self.PENDING

    @property
    def msg_bytes(self) -> int:
        """Bytes of ONE rank's issued payload (the wire-pricing size).
        Works for tensor and Request operands alike — both carry a
        static shape."""
        return (_size_of(self._seq._local_shape(self.operand))
                * self.dtype.itemsize)

    @property
    def result(self):
        if self.failed:
            err = self.error if isinstance(self.error, BaseException) \
                else RequestCancelled(
                    f"request {self.rid} ended {self.status}")
            raise err
        if not self._done:
            raise ValueError(f"request {self.rid} not materialized; "
                             f"call wait() or Sequencer.drain()")
        return self._result

    def wait(self):
        """Materialize this request (and, by FIFO + dependency order,
        everything that must execute before it). Returns the result;
        raises the typed terminal error if the request failed."""
        if self.failed:
            return self.result  # raises the typed error
        return self._seq._materialize(self)

    def cancel(self) -> None:
        """Cancel this queued request and, transitively, every
        outstanding request that depends on it. Idempotent; a no-op on
        requests already in a terminal state."""
        self._seq._fail(self, self.CANCELLED,
                        RequestCancelled(f"request {self.rid} cancelled"))


@dataclasses.dataclass(frozen=True)
class PlanItem:
    """One drain step: a single request, or a coalesced bucket of >= 2."""

    requests: tuple

    @property
    def coalesced(self) -> bool:
        return len(self.requests) > 1

    @property
    def msg_bytes(self) -> int:
        return sum(r.msg_bytes for r in self.requests)


class Sequencer:
    """Outstanding-request tracker for one `CollectiveEngine`.

    Reached via `engine.queue`; `engine.issue(...)` / the `i`-prefixed
    conveniences (`iallreduce`, ...) enqueue here.
    """

    #: per-request coalescing cap: only reductions at or below this many
    #: payload bytes bucket (the offload win is many tiny CPU-side calls;
    #: large requests already amortize their alpha).
    COALESCE_BYTES = 64 * 1024

    #: algorithms whose elementwise combine order is independent of both
    #: element position and message size: every step exchanges and
    #: combines the FULL buffer pairwise (SEL_ALL), so element i of a
    #: coalesced bucket sees the identical sequence of fp adds it would
    #: see uncoalesced — the bitwise-neutrality precondition. Chunked
    #: algorithms (rings, halving/doubling) order each element's
    #: reduction by its chunk index and may NOT coalesce.
    ORDER_SAFE_ALGORITHMS = frozenset({"recursive_doubling"})

    def __init__(self, engine, coalesce_bytes: int = COALESCE_BYTES):
        self.engine = engine
        self.coalesce_bytes = int(coalesce_bytes)
        self._queues: dict = {}        # axis -> list[Request] (FIFO)
        self._rids = itertools.count()
        self._buffer_owner: dict = {}  # id(tensor) -> last touching Request
        # "engine" | "simulator" once a drain path has touched the queue;
        # the other path then raises DrainModeError
        self._drain_mode: Optional[str] = None
        # control-plane telemetry, asserted on by tests / trainer logs;
        # `stats` is the read-compatible live view over the registry
        self.metrics = telemetry.MetricsRegistry()
        for _name in ("issued", "executed",
                      "coalesced_buckets", "coalesced_requests"):
            self.metrics.counter(_name)
        self.stats = self.metrics.view()

    def _local_shape(self, x) -> tuple:
        """One rank's local shape: a Request's recorded result shape, or
        a mesh-stacked tensor's shape after its mesh dims."""
        if isinstance(x, Request):
            return tuple(x.shape)
        return tuple(x.shape[len(self.engine.stack_shape):])

    # -- enqueue -------------------------------------------------------------
    def issue(self, collective: str, x, axis: str, *, after=None,
              timeout: Optional[float] = None, _pre=None, _post=None,
              _shape=None, **kwargs) -> Request:
        """Enqueue a collective; returns a `Request` handle immediately.

        `x` is the mesh-stacked operand tensor, or another `Request` (its
        result feeds this call — a structural DATAFLOW edge the queue
        always keeps). Ordering conflicts are additionally inferred from
        buffer identity: a request whose operand IS the same tensor as an
        outstanding request's will not reorder past it. `after=` (an
        iterable of Requests) overrides that inference with explicit
        edges — it never removes a dataflow edge, since the drain must
        materialize the operand regardless and the makespan model may
        not credit overlap the drain cannot cash. `timeout` is a
        virtual-seconds deadline enforced by the simulated drain's
        clock (typed TIMED_OUT, never a hang). Remaining keywords are
        forwarded to the blocking engine call at drain time.
        """
        if isinstance(x, Request):
            if x._seq is not self:
                raise ValueError("operand request belongs to a different "
                                 "sequencer")
            in_shape, dtype = x.shape, x.dtype
            structural = () if x._done else (x,)
            inferred = ()
        else:
            in_shape, dtype = self._local_shape(x), x.dtype
            structural = ()
            owner = self._buffer_owner.get(id(x))
            inferred = (owner,) if owner is not None and not owner._done \
                else ()
        if after is None:
            deps = structural + inferred
        else:
            extra = tuple(r for r in after if not r._done)
            for r in extra:
                if r._seq is not self:
                    raise ValueError("after= request belongs to a "
                                     "different sequencer")
            deps = structural + tuple(r for r in extra
                                      if r not in structural)
        n = self.engine.comm(axis).size
        shape = tuple(_shape) if _shape is not None \
            else _result_shape(collective, in_shape, n)
        req = Request(rid=next(self._rids), collective=collective,
                      axis=axis, operand=x, kwargs=dict(kwargs),
                      shape=shape, dtype=dtype, deps=deps, timeout=timeout,
                      _seq=self, _pre=_pre, _post=_post)
        if not isinstance(x, Request):
            self._buffer_owner[id(x)] = req
        self._queues.setdefault(axis, []).append(req)
        self.metrics.inc("issued")
        tr = telemetry.current()
        if tr.enabled:
            tr.instant("request.issued",
                       track=f"queue:{telemetry.axis_label(axis)}",
                       rid=req.rid, collective=collective,
                       msg_bytes=req.msg_bytes,
                       deps=[d.rid for d in deps],
                       timeout_s=timeout)
        return req

    def issue_multi(self, x, axes, op: str = "add",
                    algorithm: str = "auto",
                    compression: Optional[str] = None) -> Request:
        """Non-blocking hierarchical allreduce: `engine.allreduce_multi`
        as queued work. Two live axes fold into ONE tuple-axis request
        (a single two-level hierarchical program); more than two fall
        back to the request chain (RS over axes[0] -> recurse -> AG
        back), each stage depending on the previous one. The returned
        request's wait() yields the fully reduced tensor in the operand's
        shape."""
        eng = self.engine
        axes = [a for a in axes if eng.mesh_shape[a] > 1]
        src_shape = self._local_shape(x)
        if not axes:
            # degenerate communicator: nothing moves. A Request operand
            # IS the answer (do not wait it here — issue never blocks);
            # a tensor operand is wrapped as an already-done request so
            # callers treat every leaf uniformly.
            if isinstance(x, Request):
                return x
            return Request(rid=next(self._rids), collective="allreduce",
                           axis="", operand=x, kwargs={},
                           shape=tuple(src_shape), dtype=x.dtype,
                           status=Request.DONE, _seq=self, _done=True,
                           _result=x)
        if len(axes) == 1:
            return self.issue("allreduce", x, axes[0], op=op,
                              algorithm=algorithm, compression=compression)
        if len(axes) == 2:
            # two-level case: ONE tuple-axis request — the engine runs it
            # as a single hierarchical program (or the priced flat
            # fallback), the queue prices it on the ProductComm's
            # per-level fabrics, and no pad/trim hooks are needed (so
            # simulate_drain can execute it)
            return self.issue("allreduce", x, (axes[1], axes[0]), op=op,
                              algorithm=algorithm, compression=compression)
        n0 = eng.mesh_shape[axes[0]]
        size = _size_of(src_shape)
        pad = (-size) % n0
        lead = eng.stack_shape

        def pre(v):
            # pad each rank's flat local array, never across ranks
            return eng._flatten_pad_mesh(v, n0)[0]

        r_rs = self.issue("reduce_scatter", x, axes[0], op=op,
                          algorithm=algorithm, compression=compression,
                          _pre=pre, _shape=((size + pad) // n0,))
        r_mid = self.issue_multi(r_rs, axes[1:], op=op,
                                 algorithm=algorithm,
                                 compression=compression)

        def post(v, size=size, shape=tuple(src_shape)):
            return v[..., :size].reshape(lead + shape)

        return self.issue("allgather", r_mid, axes[0],
                          algorithm=algorithm, _post=post,
                          _shape=tuple(src_shape))

    # -- queue inspection ----------------------------------------------------
    def outstanding(self, axis: Optional[str] = None) -> list:
        if axis is not None:
            return list(self._queues.get(axis, ()))
        return sorted((r for q in self._queues.values() for r in q),
                      key=lambda r: r.rid)

    def axes_outstanding(self) -> list:
        """Axis keys (str or tuple) with outstanding requests, in
        first-issue order — what `MeshMakespan.of` composes over."""
        return [a for a, q in self._queues.items() if q]

    def clear(self) -> None:
        """Drop every outstanding request WITHOUT executing (model-only
        uses: makespan sweeps over hypothetical queues)."""
        self._queues.clear()
        self._buffer_owner.clear()

    # -- cancellation / abort ------------------------------------------------
    def _fail(self, req: Request, status: str, error) -> None:
        """Move `req` to terminal `status`, drop it from its queue and
        the buffer-identity index, and cascade CANCELLED to every
        outstanding dependent (their operand can never materialize).
        Idempotent on already-terminal requests."""
        if req._done or req.status != Request.PENDING:
            return
        req.status = status
        req.error = error
        tr = telemetry.current()
        if tr.enabled:
            tr.instant("request.terminal",
                       track=f"queue:{telemetry.axis_label(req.axis)}",
                       rid=req.rid, status=status,
                       error=type(error).__name__)
        q = self._queues.get(req.axis)
        if q is not None and req in q:
            q.remove(req)
        if not isinstance(req.operand, Request) \
                and self._buffer_owner.get(id(req.operand)) is req:
            del self._buffer_owner[id(req.operand)]
        for r in self.outstanding():
            if req in r.deps or r.operand is req:
                self._fail(r, Request.CANCELLED, RequestCancelled(
                    f"request {r.rid} cancelled: dependency {req.rid} "
                    f"ended {req.status}"))

    def abort(self) -> list:
        """Cancel EVERY outstanding request and empty the queue — the
        guaranteed cleanup path for an abandoned trace. After abort the
        engine's queue holds no requests: the buffer-identity index is
        cleared, so the next collective issued
        through the engine starts from an empty sequencer state.
        Returns the cancelled requests (each in status CANCELLED)."""
        dropped = [r for r in self.outstanding() if not r.finished]
        for r in dropped:
            self._fail(r, Request.CANCELLED,
                       RequestCancelled(f"request {r.rid} aborted"))
        self._queues.clear()
        self._buffer_owner.clear()
        return dropped

    def __enter__(self) -> "Sequencer":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        """Context-manager cleanup: whatever the block left outstanding
        (normally or via an exception mid-drain) is aborted, so
        `engine.queue` is provably empty on exit."""
        self.abort()
        return False

    # -- coalescing ----------------------------------------------------------
    def _coalescible(self, r: Request) -> bool:
        kw = r.kwargs
        return (r.collective == "allreduce"
                and not r.deps and r._pre is None and r._post is None
                and not isinstance(r.operand, Request)
                and kw.get("compression") is None
                and kw.get("segments") is None
                and getattr(self.engine, "backend", "microcode")
                == "microcode"
                and r.msg_bytes <= self.coalesce_bytes)

    @staticmethod
    def _coalesce_key(r: Request) -> tuple:
        # str(dtype) names each dtype once: the same grouping as the
        # reference's np.dtype(...).str
        return (r.kwargs.get("op", "add"), str(r.dtype),
                r.kwargs.get("algorithm", "auto"))

    def _resolved_algorithm(self, collective: str, msg_bytes: int,
                            comm, algorithm, codec, elem_bytes) -> str:
        if algorithm in (None, "auto"):
            return self.engine.selector.choose(
                collective, msg_bytes, comm, codec=codec,
                elem_bytes=elem_bytes).algorithm
        return algorithm

    def _bucket_safe(self, group: list, comm) -> bool:
        """Bitwise-neutrality check: every member AND the combined
        bucket must resolve to one ORDER_SAFE algorithm (see class
        docstring). Resolution goes through the memoized selector, so
        the check prices nothing new. `comm` is the communicator the
        plan is being built FOR — the engine's own fabric when
        draining, the caller's override when pricing a hypothetical
        cluster — so coalescing decisions and pricing never diverge."""
        algo_kw = group[0].kwargs.get("algorithm", "auto")
        elem = group[0].dtype.itemsize
        algos = {self._resolved_algorithm("allreduce", r.msg_bytes, comm,
                                          algo_kw, None, elem)
                 for r in group}
        total = sum(r.msg_bytes for r in group)
        algos.add(self._resolved_algorithm("allreduce", total, comm,
                                           algo_kw, None, elem))
        return len(algos) == 1 and algos <= self.ORDER_SAFE_ALGORITHMS

    def _head_item(self, q, comm) -> PlanItem:
        """The next drain step of queue `q`: its head request, extended
        over the maximal run of consecutive coalescible same-key
        followers when the bucket passes `_bucket_safe`. The greedy scan
        is prefix-stable (a group never depends on what follows it), so
        draining head items one at a time yields exactly the groups
        `_partition` plans — without re-planning the whole queue per
        executed item."""
        r = q[0]
        if self._coalescible(r):
            key = self._coalesce_key(r)
            j = 1
            while (j < len(q) and self._coalescible(q[j])
                   and self._coalesce_key(q[j]) == key):
                j += 1
            if j >= 2 and self._bucket_safe(q[:j], comm):
                return PlanItem(requests=tuple(q[:j]))
        return PlanItem(requests=(r,))

    def _partition(self, axis: str, comm=None) -> list:
        """The drain plan for one communicator: the FIFO queue, with
        maximal runs of consecutive coalescible same-key requests folded
        into buckets (consecutive => no conflicting request can sit
        between members, so bucketing never reorders). `comm` defaults
        to the engine's own fabric (the drain plan); pricing against a
        different cluster passes its communicator so the plan matches
        what THAT hardware would coalesce."""
        comm = comm if comm is not None else self.engine.comm(axis)
        q = list(self._queues.get(axis, ()))
        items = []
        while q:
            item = self._head_item(q, comm)
            items.append(item)
            q = q[len(item.requests):]
        return items

    def plan(self, axis: str, comm=None) -> list:
        """The `PlanItem` sequence `drain` will execute for `axis` —
        the artifact `makespan` prices and `simulate_drain` runs."""
        return self._partition(axis, comm)

    # -- pricing -------------------------------------------------------------
    def _resolve_item(self, item: PlanItem, comm):
        """(schedule, program, msg_bytes, elem_bytes) for one plan item.

        The ONE resolver pricing, simulation, and chaining share: the
        program is the same compiled artifact the drain's blocking
        engine call memoizes (selector choice for auto, cached schedule
        + memoized compile for explicit algorithms); the schedule rides
        along for the simulator's result/owned_chunk conventions."""
        r = item.requests[0]
        kw = r.kwargs
        collective = r.collective if not item.coalesced else "allreduce"
        nbytes = item.msg_bytes
        elem = r.dtype.itemsize
        algorithm = kw.get("algorithm", "auto")
        codec = kw.get("compression")
        root, op = kw.get("root", 0), kw.get("op", "add")
        if algorithm in (None, "auto"):
            # alltoall's segment grid is the LOCAL leading dim (the
            # stacked operand's first dim is the rank)
            local = self._local_shape(r.operand)
            lead = int(local[0]) if collective == "alltoall" \
                and len(local) else None
            choice = self.engine.selector.choose(
                collective, nbytes, comm, codec=codec, elem_bytes=elem,
                lead_dim=lead)
            if root == 0 and op == "add":
                return choice.schedule, choice.program, nbytes, elem
            # the selector priced the root=0/op='add' schedule; the
            # drain executes the chosen ALGORITHM rebuilt for this
            # request's root/op (the same rule as engine._resolve)
            algorithm, segments = choice.algorithm, choice.segments
        else:
            segments = kw.get("segments") or 1
        sched = self.engine._cached_schedule(
            collective, algorithm, comm, root, op)
        sched = sched.with_segments(segments)
        return sched, sched.compile(codec=codec), nbytes, elem

    def _priced_plan(self, axis: str, env) -> tuple:
        """(comm, items, recs) for `axis`'s outstanding queue under a
        `PricingEnv`: `items` is the drain's `PlanItem` partition and
        `recs[i] = (full_s, lat_s, wire_s, links)` prices item i off the
        same compiled program the drain executes (`links` is the
        per-physical-link wire attribution from
        `Program.cost_terms(per_link=True)`). The shared source of
        truth for the single-queue `makespan` and the mesh-level
        composition (`core/mesh_cost.py`) — the latter never re-walks
        programs."""
        comm = env.comm if env.comm is not None else self.engine.comm(axis)
        items = self._partition(axis, comm)
        recs = []
        for it in items:
            _sched, prog, nbytes, elem = self._resolve_item(it, comm)
            full = prog.cost(nbytes, comm, elem_bytes=elem, env=env)
            lat, wire, links = prog.cost_terms(
                nbytes, comm, elem_bytes=elem, env=env, per_link=True)
            recs.append((full, lat, wire, links))
        return comm, items, recs

    @staticmethod
    def _compose(items: list, recs: list) -> float:
        """The queue-level pipelining composition over priced items:
        wire occupancy serializes across the plan, queued requests'
        alpha halves hide behind it, dependency chains serialize their
        full costs and lower-bound the result. Exactly the historical
        `makespan` arithmetic (values and summation order), so the
        refactor is bitwise-neutral."""
        pos = {r: i for i, it in enumerate(items) for r in it.requests}
        fulls = [rec[0] for rec in recs]
        lats = [rec[1] for rec in recs]
        wires = [rec[2] for rec in recs]
        chain = [0.0] * len(items)
        for i, it in enumerate(items):
            best = 0.0
            for r in it.requests:
                for d in r.deps:
                    j = pos.get(d)
                    if j is not None and j < i:
                        best = max(best, chain[j])
            chain[i] = best + fulls[i]
        return max(max(chain), sum(wires) + max(lats))

    def makespan(self, axis: str, comm=None,
                 tier=None, drop_prob: float = 0.0, env=None) -> float:
        """Predicted seconds to drain `axis`'s outstanding queue.

        The queue-level pipelining model (module docstring), priced off
        the same compiled programs the drain executes.
        Cross-communicator dependencies are priced on their own axis's
        makespan and treated as satisfied here — `core/mesh_cost.py`
        composes ALL axes' queues (shared-link contention + cross-axis
        chains) when that isolation is too optimistic.

        Pricing parameters arrive in a `pricing.PricingEnv` (`env=`):
        a comm override and the reliability surcharge
        (`Program.cost`/`cost_terms`), so the queue's price reflects
        the chosen reliability contract. The bare `comm=`/`tier=`/
        `drop_prob=` kwargs are a deprecation shim with identical
        semantics; the default env is bitwise-neutral fault-free
        pricing."""
        env = resolve_env(env, comm=comm, tier=tier, drop_prob=drop_prob)
        _comm, items, recs = self._priced_plan(axis, env)
        if not items:
            return 0.0
        return self._compose(items, recs)

    def serial_cost(self, axis: str, comm=None) -> float:
        """Sum of the blocking `Program.cost`s of the outstanding
        requests, priced individually (no coalescing, no overlap) — the
        serial-blocking reference makespan is measured against."""
        comm = comm if comm is not None else self.engine.comm(axis)
        total = 0.0
        for r in self._queues.get(axis, ()):
            _sched, prog, nbytes, elem = self._resolve_item(
                PlanItem(requests=(r,)), comm)
            total += prog.cost(nbytes, comm, elem_bytes=elem)
        return total

    # -- engine drain ---------------------------------------------------------
    def _operand_value(self, r: Request):
        if isinstance(r.operand, Request):
            val = self._materialize(r.operand)
        else:
            val = r.operand
        return r._pre(val) if r._pre is not None else val

    def _dispatch(self, r: Request, val):
        eng = self.engine
        if r.collective in ("allreduce", "reduce_scatter", "allgather",
                            "bcast", "reduce", "gather", "alltoall"):
            out = getattr(eng, r.collective)(val, r.axis, **r.kwargs)
        else:
            out = eng.collective(r.collective, val, r.axis, **r.kwargs)
        return r._post(out) if r._post is not None else out

    def _finish(self, r: Request, result) -> None:
        r._result = result
        r._done = True
        r.status = Request.DONE
        self.metrics.inc("executed")
        tr = telemetry.current()
        if tr.enabled:
            tr.instant("request.done",
                       track=f"queue:{telemetry.axis_label(r.axis)}",
                       rid=r.rid)
        if not isinstance(r.operand, Request) \
                and self._buffer_owner.get(id(r.operand)) is r:
            del self._buffer_owner[id(r.operand)]

    def _claim_drain(self, mode: str) -> None:
        if self._drain_mode is None:
            self._drain_mode = mode
        elif self._drain_mode != mode:
            raise DrainModeError(
                f"this sequencer already drained through the "
                f"{self._drain_mode}; it cannot also drain through the "
                f"{mode} (use a fresh Sequencer per drain path)")

    def _check_dag(self) -> None:
        """DL_DEP_CYCLE (core/verify.py): prove the outstanding request
        DAG acyclic before draining. `issue` keeps it acyclic by
        construction (deps always point at earlier rids), so this guards
        tampered handles and future edge sources — including cross-axis
        `issue_multi` chains, whose stage edges all live in `deps`."""
        from repro_torch.core.verify import check_request_dag
        check_request_dag(
            [r for q in self._queues.values() for r in q if not r._done])

    def _run_item(self, item: PlanItem) -> None:
        tr = telemetry.current()
        if not tr.enabled:
            return self._run_item_inner(item)
        with tr.span(
                "drain.item",
                track=f"queue:{telemetry.axis_label(item.requests[0].axis)}",
                rids=[r.rid for r in item.requests],
                coalesced=item.coalesced):
            return self._run_item_inner(item)

    def _run_item_inner(self, item: PlanItem) -> None:
        self._claim_drain("engine")
        for r in item.requests:
            for d in r.deps:
                self._materialize(d)
        q = self._queues[item.requests[0].axis]
        if not item.coalesced:
            r = item.requests[0]
            out = self._dispatch(r, self._operand_value(r))
            self._finish(r, out)
            q.remove(r)
            return
        # bucketed reduction: ONE program for the whole run — compiled,
        # priced, and executed at the concatenated size; bitwise-neutral
        # by the ORDER_SAFE eligibility check. Members join along each
        # rank's flat local dims, never across ranks.
        lead = self.engine.stack_shape
        flats = [self._operand_value(r).reshape(lead + (-1,))
                 for r in item.requests]
        buf = torch.cat(flats, dim=-1)
        r0 = item.requests[0]
        out = self.engine.allreduce(buf, r0.axis, **r0.kwargs)
        off = 0
        for r, flat in zip(item.requests, flats):
            n = flat.shape[-1]
            self._finish(r, out[..., off:off + n].reshape(r.operand.shape))
            off += n
            q.remove(r)
        self.metrics.inc("coalesced_buckets")
        self.metrics.inc("coalesced_requests", len(item.requests))

    def _materialize(self, req: Request):
        if req._seq is not self:
            raise ValueError("request belongs to a different sequencer")
        if req.failed:
            return req.result  # raises the typed terminal error
        if not req._done and req not in self._queues.get(req.axis, ()):
            raise ValueError(f"request {req.rid} is not outstanding")
        while not req._done:
            if req.failed:
                return req.result  # raises the typed terminal error
            comm = self.engine.comm(req.axis)
            self._run_item(self._head_item(self._queues[req.axis], comm))
        return req._result

    def drain(self, axis: Optional[str] = None) -> list:
        """Materialize every outstanding request (on `axis`, or all
        communicators in global issue order). Returns the drained
        requests; results hang off each `Request.result`."""
        drained = []
        self._check_dag()
        if axis is not None:
            comm = self.engine.comm(axis)
            while self._queues.get(axis):
                item = self._head_item(self._queues[axis], comm)
                drained.extend(item.requests)
                self._run_item(item)
            return drained
        for r in self.outstanding():
            if not r._done:
                self._materialize(r)
            drained.append(r)
        return drained

    # -- simulator drain (numpy validation path) -----------------------------
    def simulate_drain(self, feeds: dict, fault_plan=None, tier=None,
                       degrade: bool = False) -> dict:
        """Drain the whole queue in the numpy simulator.

        `feeds` maps each leaf request (tensor operand) to its per-rank
        list of numpy local arrays; requests whose operand is another
        Request consume that request's simulated per-rank results. Executes plan items
        in global issue order — per-communicator FIFO plus dependency
        order, exactly the engine drain's discipline — through
        `simulator.run_collective` on the SAME compiled programs
        `makespan` prices. Returns {request: per-rank result list} and
        marks the requests done (a simulated sequencer is spent; use a
        fresh one per engine drain).

        `fault_plan` (a `faults.FaultPlan`, with `tier` defaulting to
        tcp-like) executes the drain against the lossy fabric: a request
        whose tier-level retries recover materializes bitwise-identical
        to the fault-free drain; one that cannot ends in a TYPED
        terminal state (TIMED_OUT on loss/deadline, PEER_FAILED on a
        dead rank) with its dependents CANCELLED — never a hang, never
        a partial write. Per-request `timeout`s are enforced on the
        VIRTUAL clock (priced program cost + retry alphas + the tier's
        deterministic backoff); no wall-clock is consulted anywhere.
        With `degrade=True` a dead rank additionally shrinks the
        communicator to the survivors (`Communicator.without_ranks` — the
        degraded comm's rank table keeps every survivor's ORIGINAL id,
        so mid-mesh, non-contiguous survivors keep their data shards),
        the selector replans every still-queued collective on the
        degraded fabric, and surviving ranks' feeds carry on — the
        shrink-and-continue path the trainer demo rides."""
        from repro_torch.core import simulator as sim
        from repro_torch.core.faults import (
            FaultyTransport, PeerFailedError, TIERS, TransportError,
            TransportTimeout,
        )
        if any(r._pre is not None or r._post is not None
               for q in self._queues.values() for r in q):
            raise NotImplementedError(
                "simulate_drain does not execute issue_multi chains "
                "(their pad/trim hooks are torch closures)")
        if any(self._queues.values()):
            self._claim_drain("simulator")
        self._check_dag()
        transport = None
        if fault_plan is not None:
            transport = FaultyTransport(
                plan=fault_plan,
                tier=tier if tier is not None else TIERS["tcp-like"])
        results: dict = {}
        comm_override: dict = {}   # axis -> degraded communicator
        # virtual drain clock — trace-only state: pricing never reads it,
        # and none of it is computed unless a tracer is installed
        tr = telemetry.current()
        clock = 0.0                # serial virtual clock (priced seconds)
        done_at: dict = {}         # rid -> virtual completion time
        occ = None                 # FabricOccupancy, lazily built
        while any(self._queues.values()):
            # global issue order: among queue heads, run the item whose
            # head request was issued first — dependencies always point
            # at earlier rids, so their communicator's head is scheduled
            # before the dependent request can reach its own head slot
            axis = min((a for a, q in self._queues.items() if q),
                       key=lambda a: self._queues[a][0].rid)
            comm = comm_override.get(axis)
            if comm is None:
                comm = self.engine.comm(axis)
            item = self._head_item(self._queues[axis], comm)
            # a failed dependency cancels the dependent before it runs
            bad = next(
                (d for r in item.requests
                 for d in (r.deps + ((r.operand,) if isinstance(
                     r.operand, Request) else ()))
                 if d.failed), None)
            if bad is not None:
                for r in item.requests:
                    self._fail(r, Request.CANCELLED, RequestCancelled(
                        f"request {r.rid} cancelled: dependency "
                        f"{bad.rid} ended {bad.status}"))
                continue
            sched, prog, nbytes, elem = self._resolve_item(item, comm)

            def _fit(v, comm=comm):
                # a feed recorded at the pre-shrink size is sliced to
                # the survivors' ORIGINAL rank ids (the degraded comm's
                # rank table); post-shrink results already fit.
                # ProductComm has no rank table (degradation is flat-
                # comm only), so tuple axes pass through.
                if getattr(comm, "ranks", None) is not None \
                        and len(v) != comm.size:
                    return [v[g] for g in comm.global_ranks]
                return list(v)

            vals = []
            for r in item.requests:
                if isinstance(r.operand, Request):
                    vals.append(_fit(results[r.operand]))
                else:
                    vals.append(_fit(feeds[r]))
            q = self._queues[axis]
            pre_retries = transport.retries if transport else 0
            pre_backoff = transport.backoff_s if transport else 0.0
            try:
                results_item = self._sim_item(
                    sim, item, sched, prog, vals, comm, transport)
            except PeerFailedError as e:
                if degrade:
                    # e.rank is local to the CURRENT comm; the rank
                    # table composes the original ids across repeated
                    # shrinks
                    comm_override[axis] = comm.without_ranks([e.rank])
                    if transport is not None:
                        # rank-keyed schedule entries do not survive the
                        # renumbering; background loss (drop_prob) does
                        transport = FaultyTransport(
                            plan=dataclasses.replace(
                                fault_plan, drops=frozenset(),
                                flaps=(), dead=()),
                            tier=transport.tier,
                            exchange=transport.exchange,
                            retries=transport.retries,
                            backoff_s=transport.backoff_s)
                for r in item.requests:
                    self._fail(r, Request.PEER_FAILED, e)
                continue
            except TransportError as e:
                for r in item.requests:
                    self._fail(r, Request.TIMED_OUT, e)
                continue
            # virtual clock for this item: priced cost + retry penalty
            elapsed = prog.cost(nbytes, comm, elem_bytes=elem)
            if transport is not None:
                elapsed += ((transport.retries - pre_retries)
                            * comm.hop_latency
                            + transport.backoff_s - pre_backoff)
            late = [r for r in item.requests
                    if r.timeout is not None and elapsed > r.timeout]
            if tr.enabled:
                # request-lifecycle attribution on the virtual clock:
                # dep_stall = waiting on dependencies, queue_wait = the
                # rest of the time between issue (t=0) and dispatch
                if occ is None:
                    from repro_torch.core.topology import FabricOccupancy
                    occ = FabricOccupancy()
                dep_ready = max((done_at.get(d.rid, 0.0)
                                 for r in item.requests for d in r.deps),
                                default=0.0)
                lat_s, wire_s, links = prog.cost_terms(
                    nbytes, comm, elem_bytes=elem, per_link=True)
                tr.interval(
                    "request", f"queue:{telemetry.axis_label(axis)}",
                    clock, clock + elapsed,
                    rids=[r.rid for r in item.requests],
                    collective=item.requests[0].collective,
                    queue_wait_s=clock - dep_ready, dep_stall_s=dep_ready,
                    wire_s=wire_s, lat_s=lat_s,
                    retries=(transport.retries - pre_retries
                             if transport else 0),
                    backoff_s=(transport.backoff_s - pre_backoff
                               if transport else 0.0),
                    status="TIMED_OUT" if late else "DONE",
                    coalesced=item.coalesced)
                for lkey, w in links.items():
                    ck = occ.canonical(lkey)
                    tr.interval(
                        "wire", "link:" + "/".join(str(p) for p in ck),
                        clock, clock + w,
                        rids=[r.rid for r in item.requests])
                if not late:
                    for r in item.requests:
                        done_at[r.rid] = clock + elapsed
                clock += elapsed
            if late:
                for r in item.requests:
                    self._fail(r, Request.TIMED_OUT, TransportTimeout(
                        f"request {r.rid}: drain step took "
                        f"{elapsed:.3e}s virtual > timeout"))
                continue
            for r, per in results_item:
                results[r] = per
                self._finish(r, per)
                q.remove(r)
            if item.coalesced:
                self.metrics.inc("coalesced_buckets")
                self.metrics.inc("coalesced_requests", len(item.requests))
        return results

    def _sim_item(self, sim, item: PlanItem, sched, prog, vals, comm,
                  transport) -> list:
        """Run one plan item through `simulator.run_collective`;
        returns [(request, per_rank_results), ...] without touching
        queue state (the caller commits or converts a typed failure)."""
        if item.coalesced:
            n = comm.size
            cat = [np.concatenate([v[rank].reshape(-1) for v in vals])
                   for rank in range(n)]
            r0 = item.requests[0]
            outs = sim.run_collective(
                "allreduce", sched, prog, cat,
                root=r0.kwargs.get("root", 0), transport=transport)
            pairs = []
            off = 0
            for r, v in zip(item.requests, vals):
                ln = v[0].size
                per = [outs[rank][off:off + ln].reshape(v[rank].shape)
                       for rank in range(n)]
                pairs.append((r, per))
                off += ln
            return pairs
        r = item.requests[0]
        for d in r.deps:
            if not d._done:
                raise AssertionError(
                    "global-order drain reached a request before "
                    "its dependency — sequencer invariant broken")
        outs = sim.run_collective(
            r.collective, sched, prog, vals[0],
            root=r.kwargs.get("root", 0), transport=transport)
        return [(r, outs)]
