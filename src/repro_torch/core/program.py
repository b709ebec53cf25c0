"""Micro-op IR — the fixed primitive set of the collective data plane.

ACCL+'s central design point (§4.2–4.4) is that collectives are software-
defined microprograms executed by ONE fixed engine over a small set of
DMA/packetizer primitives; new collectives deploy without re-synthesizing
the circuit. This module is that contract for our reproduction:

  Schedule  (algorithm layer: what moves where, pure data + rank closures)
     |  compile_schedule()                (the "firmware assembler")
     v
  Program   (this module: a linear list of micro-ops)
     |  engine.execute_program()          (XLA data plane)
     |  simulator.execute_program()       (numpy bus-functional model)

The primitive set:

  COPY          local DMA move: stage a selected region ("load"), or the
                Bruck pre/post chunk rotations.
  COMPRESS      unary streaming plugin: staged payload -> wire format.
  SEND          the Tx/Rx system crossing: ppermute every wire leaf.
  DECOMPRESS    wire format -> payload (receiver side of the codec).
  RECV_COMBINE  binary streaming plugin: combine the arrived payload into
                the local buffer region named by recv_sel.
  SEG_LOOP      Rx-buffer pipelining (§4.4.3): run one exchange's ops per
                wire segment, double-buffered — segment s+1 rides the wire
                while segment s runs through the combine plugin.
  LOOP          rolled execution of a uniform run of steps (one lax.scan
                in the XLA executor). This is what keeps O(n)-step rings
                at O(1) live buffers: unrolling a 16-rank ring produces 15
                full-buffer dynamic-update-slice chains whose arenas XLA
                cannot always alias.
  STREAM        cross-step segment streaming (§4.4.3, the CCLO's hop-to-hop
                pipelining): a uniform run of segmented exchanges fused
                into ONE skewed software pipeline — step s+1's segment 0
                rides the wire before step s's tail segment combines. The
                `fuse_streams` pass rewrites eligible LOOPs of SEG_LOOP
                slots into this; it is bitwise-equal to the unfused form.
  STREAM_CHAIN  the same hop-to-hop pipeline over a run of DISTINCT
                unrolled segmented steps (recursive halving/doubling,
                linear all-to-all): the `fuse_chains` pass proves, per
                rank and per step boundary, that the out-of-order head
                segment never reads a region the previous step's missing
                tail write would have changed (the SEL_RANGE region-
                overlap proof), then chains the steps into one wave
                pipeline — also bitwise-equal to the unfused form.
  STACKED_RECV  the stacked-receive peephole: a run of relay='original'
                copy exchanges (explicit linear all-to-all) whose arrivals
                are written back with ONE chunk scatter instead of n-1
                full-buffer dynamic-update-slices.

Both executors run the same Program object, so oracle parity in the numpy
simulator covers the real code path, not a parallel reimplementation.

The Program is also the unit of COST: `Program.cost(msg_bytes, comm)`
walks the compiled ops (LOOP trip counts, per-op codec wire bytes,
per-fabric alpha and Rx segment floors) under a SPLIT pipelining model:

  * exchanges inside a STREAM / STREAM_CHAIN region earn the cross-step
    fill/drain credit — per region, sum_i t_i + (k - 1) * max_i t_i with
    t_i = alpha + wire_i / (k * bw) — because the executor really does
    send step s+1's head segment before step s's tail combine there;
  * every other exchange (SEG_LOOP, rolled-but-unstreamed LOOP slots,
    unrolled steps) pipelines only WITHIN its step — the SEG_LOOP scan
    carry is a per-step barrier — so it is priced serialized:
    k * t_seg = k * alpha + wire / bw per step, never cheaper than
    unsegmented.

The selector therefore stops auto-picking segmentation where execution
cannot cash the overlap; the credit is earned exactly where a fusion pass
proved the reorder safe. The schedule-walk `predict_time` is retired.

Per-segment scale reuse (codecs): block codecs (int8) quantize in fixed
element blocks. `fit_segments` only admits segment counts whose per-
segment flat length is a whole number of codec blocks, so every scale
block is computed from exactly the elements it would see unsegmented —
segmented compressed wires are bitwise-identical to unsegmented ones.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import telemetry
from repro_torch.core.schedule import (
    SEL_ALL, SEL_CHUNK, SEL_MASK, SEL_RANGE, Schedule, Sel, Step,
)

# Payload sources a COPY("load") may read (the schedule's relay modes).
SRC_BUFFER = "buffer"
SRC_ORIGINAL = "original"
SRC_RECEIVED = "received"


# --------------------------------------------------------------------------
# Micro-ops
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Copy:
    """Local DMA move. kind='load' stages `sel` of `source` as the wire
    payload; kind='bruck_pre'/'bruck_post' rotate the buffer's chunks."""

    kind: str                      # 'load' | 'bruck_pre' | 'bruck_post'
    sel: Optional[Sel] = None      # load only
    source: str = SRC_BUFFER       # load only
    step: Optional[int] = None     # static step index; None inside a LOOP


@dataclasses.dataclass(frozen=True)
class Compress:
    codec: str


@dataclasses.dataclass(frozen=True)
class Send:
    perm: tuple                    # (src, dst) pairs, one collective-permute
    # fraction of the full message this crossing moves per rank — the
    # static cost term the alpha-beta walk (`Program.cost`) prices.
    bytes_frac: float = 1.0
    # Two-level programs: which level's fabric this crossing rides
    # ("intra" | "inter", None = the communicator's own fabric) and the
    # permutation in that level's rank space (the engine ppermutes this
    # on the level's own mesh axis; `perm` stays the flat-rank pairs the
    # simulator executes).
    level: Optional[str] = None
    level_perm: Optional[tuple] = None


@dataclasses.dataclass(frozen=True)
class Decompress:
    codec: str


@dataclasses.dataclass(frozen=True)
class RecvCombine:
    op: str
    sel: Sel
    step: Optional[int] = None     # static step index; None inside a LOOP
    dsts: Optional[tuple] = None   # mask_recv: ranks that actually receive
    track_recv: bool = False       # relay='received': keep the raw arrival


@dataclasses.dataclass(frozen=True)
class SegLoop:
    """One exchange pipelined over `segments` wire segments.

    body = (Copy('load'), [Compress], Send, [Decompress], RecvCombine).
    The executor clamps `segments` to a divisor of the payload that keeps
    codec scale blocks intact (see `fit_segments`) and falls back to a
    single segment when the recv region cannot mirror the payload.
    """

    segments: int
    body: tuple


@dataclasses.dataclass(frozen=True)
class Loop:
    """`trip` iterations of `period` interleaved exchange slots.

    Iteration i, slot j executes the exchange for schedule step
    `base + i * period + j` with a *traced* step index. Semantics: every
    slot's payload and combine target are read from the iteration-start
    buffer and all region writes are applied at iteration end — uniform
    runs must therefore write disjoint regions within one iteration
    (rings do: each direction owns its chunk half), which is what lets
    XLA schedule the slots' permutes on independent links concurrently.
    """

    base: int
    trip: int
    period: int
    slots: tuple                   # tuple[tuple[micro-op, ...], ...]


@dataclasses.dataclass(frozen=True)
class Stream:
    """Cross-step segment streaming: a uniform run of `trip` iterations of
    `period` segmented exchanges fused into one skewed software pipeline.

    Each slot's body is the PLAIN (unsegmented) exchange tuple — the
    segment count lives on the Stream. Execution order is by segment
    wave g = iteration * segments + segment: wave g's arrivals combine
    while wave g+1's payloads are already on the wire, so step s+1's
    segment 0 crosses the Tx/Rx system before step s's tail combine —
    the hop-to-hop pipelining of the CCLO (§4.4.3) that SEG_LOOP alone
    cannot reach (its scan carry is a per-step barrier).

    `fuse_streams` only emits a Stream when the wave order is provably
    value-identical to the per-step order (chunk-aligned regions, or
    payloads read from the immutable original / the relay register), so
    streamed programs are bitwise-equal to their unfused form.
    """

    base: int
    trip: int
    period: int
    segments: int
    slots: tuple                   # tuple[tuple[micro-op, ...], ...]


@dataclasses.dataclass(frozen=True)
class StreamChain:
    """Cross-step segment streaming over a run of DISTINCT unrolled steps.

    Where STREAM fuses a *uniform* run (one slot body, a traced step
    index), STREAM_CHAIN fuses a run of unrolled segmented exchanges that
    differ per step — recursive halving/doubling's shrinking/growing
    SEL_RANGE windows, linear all-to-all's per-step ring shifts. Each
    body is the PLAIN (unsegmented) exchange tuple with its static step
    index; the segment count lives on the chain. Execution order is the
    wave sequence [(step, segment)] in step-major order with a skew of
    one: wave w+1's payload goes on the wire before wave w's combine, so
    step s+1's segment 0 crosses the Tx/Rx system while step s's tail
    segment is still in the combine plugin.

    `fuse_chains` only emits a chain when the compile-time region-overlap
    proof holds for EVERY rank: each step's payload region is disjoint
    from its own combine region, and the head segment of step s+1's
    payload is disjoint from the tail segment of step s's combine region
    (the only write the skew leaves unapplied). The executor re-verifies
    the proof at trace time against the segment counts the payload
    actually admits and falls back to per-step execution when clamping
    invalidated it — streamed chains are bitwise-equal to their unfused
    form.
    """

    segments: int
    bodies: tuple                  # tuple[tuple[micro-op, ...], ...]


@dataclasses.dataclass(frozen=True)
class StackedRecv:
    """A run of relay='original' copy exchanges with one stacked write.

    Every body is a plain (Copy('load'), Send, RecvCombine) triple whose
    payload reads the immutable original buffer, so all sends are
    independent of the receive order: the executor issues every permute,
    stacks the arrivals, and scatters them into the chunk grid in ONE
    gather-style update instead of n-1 full-buffer update-slices (the
    retired hand-written linear all-to-all's trick, now a compiler
    peephole). The pass verifies the receive chunks are distinct per
    rank, so the scatter is write-disjoint.
    """

    bodies: tuple                  # tuple[(Copy, Send, RecvCombine), ...]


@dataclasses.dataclass(frozen=True)
class Program:
    """A compiled collective: schedule metadata + linear micro-op list."""

    name: str
    collective: str
    nranks: int
    chunks: int
    relay: str
    segments: int
    codec: Optional[str]
    ops: tuple
    # >1 when uniform slots use independent links concurrently (bidi ring);
    # carried from the schedule so the cost walk needs no schedule access.
    overlap_factor: float = 1.0
    # Two-level programs: (("inter", P), ("intra", M)) level rank counts,
    # carried from the schedule; None for flat programs.
    level_sizes: Optional[tuple] = None

    def describe(self) -> str:
        """One line per op — the firmware disassembly (tests, debugging)."""
        out = []
        for op in self.ops:
            if isinstance(op, Loop):
                inner = "; ".join(
                    ",".join(type(o).__name__ for o in slot)
                    for slot in op.slots)
                out.append(f"LOOP x{op.trip} period={op.period} [{inner}]")
            elif isinstance(op, Stream):
                inner = "; ".join(
                    ",".join(type(o).__name__ for o in slot)
                    for slot in op.slots)
                out.append(f"STREAM x{op.trip} k={op.segments} "
                           f"period={op.period} [{inner}]")
            elif isinstance(op, StreamChain):
                out.append(f"STREAM_CHAIN k={op.segments} "
                           f"m={len(op.bodies)}")
            elif isinstance(op, StackedRecv):
                out.append(f"STACKED_RECV m={len(op.bodies)}")
            elif isinstance(op, SegLoop):
                inner = ",".join(type(o).__name__ for o in op.body)
                out.append(f"SEG_LOOP k={op.segments} [{inner}]")
            else:
                out.append(type(op).__name__.upper())
        return "\n".join(out)

    # ---- program-level pricing (the alpha-beta walk) ---------------------
    def exchange_terms(self):
        """Yield (multiplicity, segments, body, region) per wire exchange.

        The one IR-shape walk `cost` prices: LOOP/STREAM slots repeat
        `trip` times, SEG_LOOP carries its segment count, stacked and
        unrolled exchanges run once. `region` identifies the cross-step
        pipelining region the exchange belongs to — the index of its
        STREAM / STREAM_CHAIN op, or None for exchanges whose pipeline
        has a per-step barrier (SEG_LOOP, unstreamed LOOP slots, unrolled
        and stacked exchanges). Bruck pre/post rotations are local DMA
        and free, matching the retired schedule-walk model.
        """
        ops = self.ops
        i = 0
        while i < len(ops):
            op = ops[i]
            if isinstance(op, Loop):
                for slot in op.slots:
                    body, k = split_exchange(slot)
                    yield op.trip, k, body, None
                i += 1
            elif isinstance(op, Stream):
                for body in op.slots:
                    yield op.trip, op.segments, body, i
                i += 1
            elif isinstance(op, StreamChain):
                for body in op.bodies:
                    yield 1, op.segments, body, i
                i += 1
            elif isinstance(op, StackedRecv):
                for body in op.bodies:
                    yield 1, 1, body, None
                i += 1
            elif isinstance(op, SegLoop):
                yield 1, op.segments, op.body, None
                i += 1
            elif isinstance(op, Copy) and op.kind != "load":
                i += 1
            else:
                j = i
                while not isinstance(ops[j], RecvCombine):
                    j += 1
                yield 1, 1, tuple(ops[i:j + 1]), None
                i = j + 1

    def cost(self, msg_bytes: float, comm, elem_bytes: int = 4,
             tier=None, drop_prob: float = 0.0, env=None) -> float:
        """Predicted seconds for THIS compiled program on `comm`'s fabric.

        The SPLIT pipelining model, priced off the ops that will actually
        execute. Every exchange's per-segment time is
        t = alpha + wire_bytes / (k_eff * bw); then

          * exchanges inside a STREAM / STREAM_CHAIN region contribute
            mult * t and the region drains once in (k - 1) * max t over
            its exchanges — the cross-step fill/drain credit, earned
            because the executor keeps the wire busy across step
            boundaries there;
          * every other exchange pipelines only within its own step (the
            SEG_LOOP scan carry is a per-step barrier), so it contributes
            the serialized mult * k_eff * t = mult * (k_eff * alpha +
            wire / bw) — at k > 1 that is never cheaper than unsegmented,
            so the selector cannot be lured into segmentation the data
            plane cannot cash.

        The total divides by `overlap_factor` when slots ride independent
        links. Wire bytes come from each SEND's `bytes_frac`, scaled by
        the codec ratio when the exchange COMPRESSes (copy phases ship
        uncompressed — visible directly in the ops). `comm` supplies the
        per-fabric alpha, bandwidth, and Rx segment floor: a segment
        count that would cut an exchange's wire payload below the floor
        is clamped, so sub-floor tuning pins price what the Rx buffers
        can hold.

        For a k=1 program, and for any k>1 program that fuses into a
        single cross-step region, this walk returns the identical number
        to the retired schedule-walk `predict_time` — asserted (with the
        intentional divergences) by the golden pricing tests.

        A `pricing.PricingEnv` (`env=`) is the preferred way to carry
        the reliability surcharge (and a comm override): `env.tier` /
        `env.drop_prob` scale every alpha and wire term by the tier's
        expected transmissions under that loss rate and add the expected
        exponential backoff per wire crossing. The bare `tier=` /
        `drop_prob=` kwargs are a deprecation shim with identical
        semantics; mixing them with `env=` raises. A default env (or
        `tier=None`) is bitwise-neutral — fault-free pricing unchanged.
        """
        if env is not None:
            comm, tier, drop_prob = env.apply(comm, tier, drop_prob)
        total, _lat, _wir, crossings, _links = \
            self._cost_walk(msg_bytes, comm, elem_bytes)
        total = total / self.overlap_factor
        if tier is not None:
            total = (total * tier.expected_transmissions(drop_prob)
                     + crossings * tier.expected_backoff(drop_prob))
        return total

    def cost_terms(self, msg_bytes: float, comm,
                   elem_bytes: int = 4, tier=None,
                   drop_prob: float = 0.0, env=None,
                   per_link: bool = False) -> tuple:
        """`cost` decomposed as (latency_s, wire_s).

        latency_s collects every per-hop alpha term of the walk; wire_s
        collects the bandwidth-occupancy terms (bytes / bw). Their sum is
        `cost` up to summation rounding (the same multiplicities, floors,
        and region drains apply to both halves, each already divided by
        `overlap_factor`). The queue-level makespan model
        (`core/sequencer.py`) composes these: wire occupancy of requests
        sharing one communicator's links serializes, while the alpha
        half of a QUEUED request hides behind the wire time of the one
        in flight.

        With `per_link=True` the return grows a third element: a dict
        attributing wire_s across the physical links the bytes cross —
        keys are `("ici"|"dcn", axis)` from the exchange's
        `level_comm`, values sum (over a single-link program, bitwise)
        to wire_s. The mesh-level composition (`core/mesh_cost.py`)
        serializes THESE per shared link across queues, so it never
        re-walks programs.

        A reliability tier (via `env=PricingEnv(tier=..., drop_prob=...)`
        or the deprecated bare kwargs) scales both halves — and every
        link's share — by the tier's expected transmissions; the
        expected backoff lands in the latency half (backoff occupies no
        wire). The default is bitwise-neutral.
        """
        if env is not None:
            comm, tier, drop_prob = env.apply(comm, tier, drop_prob)
        _total, lat, wire, crossings, links = \
            self._cost_walk(msg_bytes, comm, elem_bytes)
        lat = lat / self.overlap_factor
        wire = wire / self.overlap_factor
        links = {key: v / self.overlap_factor for key, v in links.items()}
        if tier is not None:
            e = tier.expected_transmissions(drop_prob)
            lat = lat * e + crossings * tier.expected_backoff(drop_prob)
            wire = wire * e
            links = {key: v * e for key, v in links.items()}
        if per_link:
            return lat, wire, links
        return lat, wire

    def _level_fabrics(self, comm) -> dict:
        """level tag -> (alpha, bw, floor, link) for this comm. A flat
        communicator resolves every level to itself (`level_comm`), so
        flat pricing is bitwise-unchanged; a `ProductComm` routes "intra"
        exchanges to the ICI group and "inter" ones to the DCN group.
        `link` is the physical-link attribution key — `("dcn"|"ici",
        axis)` — that `cost_terms(per_link=True)` reports wire seconds
        under (see `topology.FabricOccupancy` for canonicalization)."""
        fabrics = {}
        for level in (None, "intra", "inter"):
            c = comm.level_comm(level) if hasattr(comm, "level_comm") \
                else comm
            link = ("dcn" if c.is_dcn else "ici", c.axis)
            fabrics[level] = (c.hop_latency, c.link_bw,
                              c.min_segment_bytes, link)
        return fabrics

    def fabric_wire_bytes(self, msg_bytes: float, comm,
                          elem_bytes: int = 4) -> dict:
        """Per-fabric wire bytes per rank: {"ici": ..., "dcn": ...}.

        The honest byte accounting behind the hierarchical claim — the
        priced DCN bytes of a two-level allreduce are exactly
        flat / ici_size. Segmentation does not change wire bytes; codec
        compression does (same scaling as `cost`)."""
        out = {"ici": 0.0, "dcn": 0.0}
        for mult, _k, body, _region in self.exchange_terms():
            scale = 1.0
            send = None
            for op in body:
                if isinstance(op, Compress):
                    from repro_torch.core import plugins  # lazy: import cycle
                    scale = (plugins.get_codec(op.codec).wire_bytes_per_elem
                             / float(elem_bytes))
                elif isinstance(op, Send):
                    send = op
            c = comm.level_comm(send.level) if hasattr(comm, "level_comm") \
                else comm
            fabric = "dcn" if c.is_dcn else "ici"
            out[fabric] += mult * float(msg_bytes) * send.bytes_frac * scale
        return out

    def _cost_walk(self, msg_bytes: float, comm, elem_bytes: int) -> tuple:
        """(total, latency, wire, crossings, links) over the ops. `total`
        accumulates in the exact historical order (golden parity is
        asserted bitwise); the split halves accumulate alongside it.
        `crossings` counts per-segment wire crossings (mult * k_eff) —
        the unit the retransmission surcharge is charged per. Each
        exchange prices on `comm.level_comm(send.level)`'s fabric, so a
        two-level program's intra steps ride ICI alpha/bandwidth/floor
        and its inter steps ride DCN's; flat programs (level=None)
        resolve to `comm` itself and price bitwise-identically to the
        single-fabric walk. `links` splits the wire half by physical
        link key (see `_level_fabrics`); it is a PARALLEL accumulator —
        the total/lat/wire float-op sequence is untouched, so adding it
        cannot perturb golden parity."""
        fabrics = self._level_fabrics(comm)
        total = 0.0
        lat = 0.0
        wir = 0.0
        crossings = 0.0
        links: dict = {}
        # region id -> [k_max, t_max, a_max, b_max, link_of_max]
        drains: dict = {}
        for mult, k, body, region in self.exchange_terms():
            scale = 1.0
            send = None
            for op in body:
                if isinstance(op, Compress):
                    from repro_torch.core import plugins  # lazy: import cycle
                    scale = (plugins.get_codec(op.codec).wire_bytes_per_elem
                             / float(elem_bytes))
                elif isinstance(op, Send):
                    send = op
            alpha, bw, floor, link = fabrics[send.level]
            wire = float(msg_bytes) * send.bytes_frac * scale
            k_eff = int(k)
            while k_eff > 1 and wire / k_eff < floor:
                k_eff -= 1
            b = wire / (k_eff * bw)
            t = alpha + b
            crossings += mult * k_eff
            if region is not None:
                total += mult * t
                lat += mult * alpha
                wir += mult * b
                links[link] = links.get(link, 0.0) + mult * b
                d = drains.setdefault(region, [1, 0.0, 0.0, 0.0, link])
                d[0] = max(d[0], k_eff)
                if t > d[1]:
                    d[1], d[2], d[3], d[4] = t, alpha, b, link
            else:
                total += mult * k_eff * t
                lat += mult * k_eff * alpha
                wir += mult * k_eff * b
                links[link] = links.get(link, 0.0) + mult * k_eff * b
        total += sum((k_r - 1) * t_r
                     for k_r, t_r, _a, _b, _l in drains.values())
        lat += sum((k_r - 1) * a_r
                   for k_r, _t, a_r, _b, _l in drains.values())
        wir += sum((k_r - 1) * b_r
                   for k_r, _t, _a, b_r, _l in drains.values())
        drain_by_link: dict = {}
        for k_r, _t, _a, b_r, l_r in drains.values():
            drain_by_link.setdefault(l_r, []).append((k_r - 1) * b_r)
        for l_r, vals in drain_by_link.items():
            # sum-then-add mirrors wir's association, so a single-link
            # program's links[key] stays bitwise-equal to wir
            links[l_r] = links.get(l_r, 0.0) + sum(vals)
        return total, lat, wir, crossings, links


# --------------------------------------------------------------------------
# Segment fitting (shared by both executors)
# --------------------------------------------------------------------------

def fit_segments(seg_len: int, segments, row_elems: int = 1,
                 block: int = 1) -> int:
    """Largest k <= segments that divides seg_len (>= 1), such that each
    segment's flat element count (seg_len/k * row_elems) is a whole number
    of codec `block`s.

    Segment counts come from the selector as a preference; the data plane
    clamps to a divisor of the payload length so segments stay equal-sized
    (halving mirrors the pow2 candidate ladder). The block constraint is
    the per-segment scale-reuse rule: a scale block never straddles a
    segment boundary, so segmented codec numerics == unsegmented.
    """
    k = max(1, int(segments or 1))
    k = min(k, max(1, seg_len))
    while k > 1 and (seg_len % k
                     or (seg_len // k * row_elems) % block):
        k -= 1
    return k


# --------------------------------------------------------------------------
# Compiler
# --------------------------------------------------------------------------

def _step_segmentable(step: Step, relay: str) -> bool:
    if step.segmentable is False:
        return False
    send_k, recv_k = step.send_sel.kind, step.recv_sel.kind
    if SEL_MASK in (send_k, recv_k):
        # non-contiguous regions segment only when the algorithm asserts
        # the send/recv masks are identical (Step.segmentable=True): the
        # gathered payload is then cut into wire segments and the combined
        # segments scattered back chunk-by-chunk.
        return bool(step.segmentable) and send_k == recv_k == SEL_MASK
    return True


def _exchange_ops(step: Step, relay: str, step_idx: Optional[int],
                  k_req: int, codec: Optional[str]) -> tuple:
    """The micro-op sequence for one schedule step."""
    ops = [Copy("load", sel=step.send_sel, source=relay, step=step_idx)]
    send = Send(tuple(step.perm), bytes_frac=step.bytes_frac,
                level=step.level,
                level_perm=(tuple(step.level_perm)
                            if step.level_perm is not None else None))
    if codec is not None and step.op != "copy":
        # codecs compress the wire of combine exchanges (the RS phase);
        # copy-only relays ship already-reduced chunks uncompressed, the
        # same rule the hand-written rings applied.
        ops.append(Compress(codec))
        ops.append(send)
        ops.append(Decompress(codec))
    else:
        ops.append(send)
    dsts = tuple(sorted(d for (_s, d) in step.perm)) if step.mask_recv \
        else None
    ops.append(RecvCombine(op=step.op, sel=step.recv_sel, step=step_idx,
                           dsts=dsts, track_recv=(relay == SRC_RECEIVED)))
    seq = tuple(ops)
    if k_req > 1 and _step_segmentable(step, relay):
        return (SegLoop(k_req, seq),)
    return seq


def _detect_run(steps: tuple, i: int) -> Optional[tuple]:
    """Maximal uniform run at `steps[i:]` -> (trip, period) or None.

    A run of trip >= 2 iterations of `period` slots coalesces into a LOOP
    when every participating step is `uniform` (traceable step-indexed
    selectors shared across the run), does not mask receivers, and — for
    period > 1 — writes an offset region (chunk/range) so the deferred
    per-iteration writes stay well-defined.
    """
    for period in (1, 2):
        if i + 2 * period > len(steps):
            continue
        slots = steps[i:i + period]
        if not all(s.uniform and not s.mask_recv for s in slots):
            continue
        if period > 1 and any(s.recv_sel.kind not in (SEL_CHUNK, SEL_RANGE)
                              for s in slots):
            continue
        sigs = [s.signature() for s in slots]
        trip = 1
        while True:
            base = i + trip * period
            if base + period > len(steps):
                break
            if all(steps[base + j].signature() == sigs[j]
                   for j in range(period)):
                trip += 1
            else:
                break
        if trip >= 2:
            return trip, period
    return None


def split_exchange(node) -> tuple:
    """(body, k_req) of an exchange node — a SegLoop (possibly the sole
    element of a LOOP slot tuple) or a plain micro-op tuple. The one
    IR-shape helper of the program's walks (`batches`, `exchange_terms`)
    and of the verifier."""
    if isinstance(node, tuple) and len(node) == 1 \
            and isinstance(node[0], SegLoop):
        node = node[0]
    if isinstance(node, SegLoop):
        return node.body, node.segments
    return node, 1


# --------------------------------------------------------------------------
# Optimization passes
# --------------------------------------------------------------------------

def _sel_region(sel: Sel, r: int, step: int):
    """Concrete (offset, length) in chunk units for a contiguous selector
    evaluated at a concrete rank/step. Selector closures are pure
    (rank, step) arithmetic, so they evaluate on plain ints at compile
    time; anything fancier raises and the caller opts out."""
    if sel.kind == SEL_CHUNK:
        return int(sel.fn(r, step)), 1
    if sel.kind == SEL_RANGE:
        off, length = sel.fn(r, step)
        return int(off), int(length)
    raise ValueError(f"non-contiguous selector {sel.kind}")


def _overlaps(a0, a1, b0, b1) -> bool:
    return max(a0, b0) < min(a1, b1)


def _regions_stream_safe(seq, k: int, nranks: int) -> bool:
    """The SEL_RANGE/SEL_CHUNK region-overlap proof for a step sequence.

    `seq` is [(send_sel, recv_sel, source, step), ...] in execution
    order. The skewed wave order differs from the per-step order in
    exactly one read: the HEAD segment of step s+1's payload is fetched
    while step s's TAIL segment is still uncombined (every earlier wave
    has landed, every later one has not happened). The reorder is
    value-invisible — hence streamable — iff for EVERY rank:

      1. each step's payload region is disjoint from its own combine
         region and of equal length (payloads never observe their own
         step's writes — the unfused executor reads the payload at step
         start), and
      2. the first 1/k of step s+1's payload region is disjoint from the
         last 1/k of step s's combine region (the one missing write).

    Payloads reading the immutable original buffer skip both read-side
    checks. Segment boundaries are exact rationals of the chunk grid
    (`Fraction`), so the proof never rounds. Recursive halving/doubling
    pass for k >= 3 and genuinely fail at k = 2, where the half-range
    head segment really does reach into the missing tail write.
    """
    from fractions import Fraction
    try:
        for r in range(nranks):
            regions = []
            for send_sel, recv_sel, source, step in seq:
                s_off, s_len = _sel_region(send_sel, r, step)
                r_off, r_len = _sel_region(recv_sel, r, step)
                if s_len != r_len:
                    # the executor mirrors the payload segmentation onto
                    # the combine region; unequal lengths cannot stream
                    return False
                if source == SRC_BUFFER and _overlaps(
                        s_off, s_off + s_len, r_off, r_off + r_len):
                    return False
                regions.append((source, s_off, s_len, r_off, r_len))
            for i in range(1, len(regions)):
                source, s_off, s_len, _ro, _rl = regions[i]
                if source != SRC_BUFFER:
                    continue  # immutable payload: no read-side hazard
                _src0, _so0, _sl0, r_off, r_len = regions[i - 1]
                head_end = s_off + Fraction(s_len, k)
                tail_start = r_off + Fraction(r_len * (k - 1), k)
                if _overlaps(Fraction(s_off), head_end,
                             tail_start, Fraction(r_off + r_len)):
                    return False
    except Exception:
        return False  # non-arithmetic closure: cannot prove, do not fuse
    return True


def _stream_eligible(loop: Loop, k_req: int, nranks: int) -> bool:
    """Can this uniform run execute as one cross-step segment stream?

    Wave order differs from per-step order in exactly one place: step
    s+1's segment 0 is sent before step s's tail segment (k-1) combines.
    That reordering is value-invisible when every payload either

      * reads the immutable original buffer (relay='original'),
      * reads the relay register (relay='received'), whose segment j was
        recorded k waves earlier,
      * reads whole chunks (SEL_CHUNK send AND recv): chunk regions are
        equal or disjoint, and equal regions slice into the same k
        segments — segment 0 never overlaps the missing tail write, or
      * reads contiguous chunk ranges (SEL_RANGE, period-1 runs only)
        whose concrete per-rank regions pass the region-overlap proof
        (`_regions_stream_safe`) across the whole run.

    mask_recv slots never coalesce into LOOPs; track_recv (the relay
    register) is a single shared register, so it streams only at
    period 1.
    """
    if k_req < 2 or loop.trip < 2:
        return False
    track = False
    needs_proof = False
    levels = set()
    for slot in loop.slots:
        if not (len(slot) == 1 and isinstance(slot[0], SegLoop)):
            return False
        seg = slot[0]
        if seg.segments != k_req:
            return False
        levels.add(next(o for o in seg.body
                        if isinstance(o, Send)).level)
        load, recv = seg.body[0], seg.body[-1]
        if recv.dsts is not None:
            return False
        track = track or recv.track_recv
        if recv.sel.kind not in (SEL_CHUNK, SEL_ALL, SEL_RANGE):
            return False
        if load.source == SRC_BUFFER:
            if not (load.sel.kind in (SEL_CHUNK, SEL_RANGE)
                    and recv.sel.kind in (SEL_CHUNK, SEL_RANGE)):
                return False
            if SEL_RANGE in (load.sel.kind, recv.sel.kind):
                needs_proof = True
        elif load.source == SRC_RECEIVED:
            if not (load.sel.kind == SEL_ALL and recv.sel.kind == SEL_ALL):
                return False
        else:  # SRC_ORIGINAL payloads never read mutable state
            if recv.sel.kind == SEL_RANGE:
                needs_proof = True
    if len(levels) > 1:
        # cross-step streaming only within one level: a region spanning
        # fabrics would earn a drain credit priced on one fabric while
        # its exchanges ride another
        return False
    if track and loop.period != 1:
        return False
    if needs_proof:
        if loop.period != 1 or track:
            return False  # multi-slot range interleavings are unproven
        body = loop.slots[0][0].body
        load, recv = body[0], body[-1]
        seq = [(load.sel, recv.sel, load.source, loop.base + i)
               for i in range(loop.trip)]
        return _regions_stream_safe(seq, k_req, nranks)
    return True


def fuse_streams(ops: tuple, k_req: int, nranks: int) -> tuple:
    """Rewrite eligible LOOPs of SEG_LOOP slots into STREAM micro-ops —
    the cross-step software pipeline the cost model credits."""
    out = []
    for op in ops:
        if isinstance(op, Loop) and _stream_eligible(op, k_req, nranks):
            out.append(Stream(
                base=op.base, trip=op.trip, period=op.period,
                segments=k_req,
                slots=tuple(slot[0].body for slot in op.slots)))
        else:
            out.append(op)
    return tuple(out)


def _chain_body_eligible(op, k_req: int) -> bool:
    """One unrolled segmented exchange `fuse_chains` may chain: static
    step index, contiguous send/recv regions, unmasked receivers, no
    relay register, payload from the buffer or the immutable original."""
    if not isinstance(op, SegLoop) or op.segments != k_req:
        return False
    load, recv = op.body[0], op.body[-1]
    return (isinstance(load, Copy) and load.kind == "load"
            and load.step is not None
            and load.source in (SRC_BUFFER, SRC_ORIGINAL)
            and load.sel.kind in (SEL_CHUNK, SEL_RANGE)
            and recv.sel.kind in (SEL_CHUNK, SEL_RANGE)
            and recv.dsts is None and not recv.track_recv)


def fuse_chains(ops: tuple, k_req: int, nranks: int) -> tuple:
    """Rewrite runs of >= 2 consecutive unrolled segmented exchanges into
    STREAM_CHAIN micro-ops when the region-overlap proof holds.

    This is what lets the non-uniform log-step schedules — recursive
    halving/doubling, whose windows shrink or grow each step and so never
    coalesce into LOOPs — earn the cross-step credit for real. A run is
    split at any step boundary the proof rejects (recursive halving at
    k = 2, where the head segment reaches into the missing tail write);
    sub-runs shorter than 2 keep their SEG_LOOP form.
    """
    def seq_of(body) -> tuple:
        load, recv = body[0], body[-1]
        return (load.sel, recv.sel, load.source, load.step)

    def level_of(body):
        return next(o for o in body if isinstance(o, Send)).level

    out: list = []
    i = 0
    while i < len(ops):
        if not _chain_body_eligible(ops[i], k_req):
            out.append(ops[i])
            i += 1
            continue
        # extend pairwise: each call proves both bodies' within-step
        # condition and the boundary between them, so an accepted run of
        # length >= 2 is fully proven — no whole-run re-check needed
        # (condition 2 only ever relates consecutive steps). Runs never
        # cross a level boundary: the chain's drain credit must price on
        # one fabric.
        run = [ops[i]]
        j = i + 1
        while (j < len(ops) and _chain_body_eligible(ops[j], k_req)
               and level_of(ops[j].body) == level_of(run[-1].body)
               and _regions_stream_safe(
                   [seq_of(run[-1].body), seq_of(ops[j].body)],
                   k_req, nranks)):
            run.append(ops[j])
            j += 1
        if len(run) >= 2:
            out.append(StreamChain(
                segments=k_req, bodies=tuple(op.body for op in run)))
            i = j
        else:
            out.append(run[0])
            i += 1
    return tuple(out)


def _stackable(body: tuple) -> bool:
    """One relay='original' copy exchange the peephole may stack."""
    if len(body) != 3:
        return False
    load, send, recv = body
    return (isinstance(load, Copy) and load.kind == "load"
            and load.source == SRC_ORIGINAL
            and load.sel.kind == SEL_CHUNK
            and isinstance(send, Send)
            and isinstance(recv, RecvCombine)
            and recv.op == "copy" and recv.sel.kind == SEL_CHUNK
            and recv.dsts is None and not recv.track_recv
            and load.step is not None)


def _distinct_recv_chunks(bodies: tuple, nranks: int) -> bool:
    """Every rank's receive chunks across the run must be pairwise
    distinct for the stacked scatter to be write-disjoint. Selector
    closures are pure (rank, step) arithmetic, so they evaluate on
    concrete ints at compile time; anything fancier opts out."""
    try:
        for r in range(nranks):
            idxs = [int(b[-1].sel.fn(r, b[-1].step)) for b in bodies]
            if len(set(idxs)) != len(idxs):
                return False
    except Exception:
        return False
    return True


def fuse_stacked_recv(ops: tuple, nranks: int) -> tuple:
    """The stacked-receive peephole: collapse runs of >= 2 consecutive
    relay='original' copy exchanges into one STACKED_RECV (the retired
    linear all-to-all lowering's one-gather write-back)."""
    out: list = []
    i = 0
    while i < len(ops):
        op = ops[i]
        run: list = []
        j = i
        while (j + 2 < len(ops) and isinstance(ops[j], Copy)
               and ops[j].kind == "load"
               and isinstance(ops[j + 2], RecvCombine)
               and _stackable(tuple(ops[j:j + 3]))):
            run.append(tuple(ops[j:j + 3]))
            j += 3
        if len(run) >= 2 and _distinct_recv_chunks(tuple(run), nranks):
            out.append(StackedRecv(bodies=tuple(run)))
            i = j
        else:
            out.append(op)
            i += 1
    return tuple(out)


# --------------------------------------------------------------------------
# Execution order: the executors' walk and its in-place proof
# --------------------------------------------------------------------------

def _chunk_spans(sel: Sel, r: int, step: int, chunks: int) -> tuple:
    """The (offset, length) chunk ranges selector `sel` names in rank r's
    buffer at a concrete step: `_sel_region` for a contiguous one, the
    whole buffer for SEL_ALL, one chunk per entry for SEL_MASK."""
    if sel.kind == SEL_ALL:
        return ((0, chunks),)
    if sel.kind == SEL_MASK:
        return tuple((int(j), 1) for j in sel.fn(r, step))
    return (_sel_region(sel, r, step),)


def _writes_safe(bodies, steps, nranks: int, chunks: int) -> bool:
    """The region proof that lets the exchanges `bodies` (at schedule
    `steps`), all reading one buffer state, write their results straight
    into the buffer: for EVERY rank r,

      1. no body's target region on row r overlaps any body's payload
         region read from row r's buffer (a rank's write never lands
         where another rank's payload, or a later slot's, is read), and
      2. the bodies' target regions on row r are pairwise disjoint (no
         slot reads a combine target another slot wrote).

    Then the results are those of the deferred write, bit for bit, in any
    order of ranks, segments and slots. A payload read from the
    immutable original (or the relay register) reads no row of the
    buffer. Regions are whole chunks, and segmenting only slices them,
    so the verdict holds at every segment count. A selector that does
    not evaluate on plain ints proves nothing."""
    ends = []     # (load, recv, step, ranks it receives, buffer rows read)
    for body, step in zip(bodies, steps):
        load, recv = body[0], body[-1]
        send = next(o for o in body if isinstance(o, Send))
        dsts = set(recv.dsts if recv.dsts is not None else range(nranks))
        read = {s for s, d in send.perm if d in dsts} \
            if load.source == SRC_BUFFER else set()
        ends.append((load, recv, step, dsts, read))
    try:
        for r in range(nranks):
            reads, writes = [], []
            for load, recv, step, dsts, read in ends:
                if r in read:
                    reads.extend(_chunk_spans(load.sel, r, step, chunks))
                if r in dsts:
                    writes.extend(_chunk_spans(recv.sel, r, step, chunks))
            for i, (w0, wl) in enumerate(writes):
                if any(_overlaps(w0, w0 + wl, o0, o0 + ol)
                       for o0, ol in reads + writes[i + 1:]):
                    return False
    except Exception:
        return False
    return True


@dataclasses.dataclass(frozen=True)
class Batch:
    """Exchanges that all read one state: each reads its payload and its
    combine target before any of them writes. `exchanges` holds (body,
    requested segments, step) triples in the order their writes land;
    `in_place` is the region proof (`_writes_safe`) that each may write
    straight into the buffer as it runs."""

    exchanges: tuple
    in_place: bool


def batches(prog: Program) -> tuple:
    """The program in execution order, the walk every executor runs: a
    Bruck `Copy` (`bruck_pre` only as the first op, `bruck_post`) or a
    `Batch`. Each LOOP or STREAM iteration is one batch, a STREAM as its
    unfused SEG_LOOP slots (what `fuse_streams` proves value-identical),
    and a STACKED_RECV is one; a SEG_LOOP, a bare exchange and each body
    of a STREAM_CHAIN (what `fuse_chains` proves) are a batch of one.

    A LOOP or STREAM is proved over all its iterations together, so its
    batches share one verdict; every other batch is proved alone. A
    STACKED_RECV proved as one batch is each body proved alone: every
    body reads the immutable original, and their target chunks are
    pairwise distinct (`_stackable`, `_distinct_recv_chunks`).

    Built once a program (`compile_schedule` builds it for every program
    it compiles) and kept on it, outside its fields: a program's fields
    mirror the JAX IR's, and a `dataclasses.replace` copy builds its own
    at first use."""
    walk = prog.__dict__.get("_batches")
    if walk is not None:
        return walk
    n, chunks, ops = prog.nranks, prog.chunks, prog.ops

    def proved(exchanges) -> bool:
        return _writes_safe([b for b, _k, _s in exchanges],
                            [s for _b, _k, s in exchanges], n, chunks)

    def batch(exchanges) -> Batch:
        return Batch(tuple(exchanges), proved(exchanges))

    walk = []
    i = 0
    while i < len(ops):
        op = ops[i]
        i += 1
        if isinstance(op, (Loop, Stream)):
            slots = [split_exchange(s) for s in op.slots] \
                if isinstance(op, Loop) else [(b, op.segments)
                                              for b in op.slots]
            its = [tuple((body, k, op.base + it * op.period + j)
                         for j, (body, k) in enumerate(slots))
                   for it in range(op.trip)]
            safe = all(proved(x) for x in its)
            walk.extend(Batch(x, safe) for x in its)
        elif isinstance(op, StreamChain):
            walk.extend(batch([(body, op.segments, body[0].step)])
                        for body in op.bodies)
        elif isinstance(op, StackedRecv):
            walk.append(batch([(body, 1, body[0].step)
                               for body in op.bodies]))
        elif isinstance(op, SegLoop):
            walk.append(batch([(op.body, op.segments, op.body[0].step)]))
        elif isinstance(op, Copy) and (op.kind == "bruck_post" or (
                op.kind == "bruck_pre" and i == 1)):
            walk.append(op)
        elif isinstance(op, Copy) and op.kind == "load":
            j = i
            while not isinstance(ops[j], RecvCombine):
                j += 1
            walk.append(batch([(ops[i - 1:j + 1], 1, op.step)]))
            i = j + 1
        else:
            raise ValueError(f"unexpected micro-op {op}")
    walk = tuple(walk)
    object.__setattr__(prog, "_batches", walk)     # frozen: set once
    return walk


# Schedules hash their Sel closures by identity, so freshly generated
# (structurally identical) schedules never share entries: bound the cache
# so long-lived processes compiling transient schedules (benchmark loops,
# simulator harnesses) don't grow it without limit. Steady-state engine
# use hits via the upstream schedule caches, far below this bound.
_COMPILE_CACHE: dict = {}
_COMPILE_CACHE_MAX = 512

# Verification achieved per compile-cache key ("structural" | "full") —
# a cache hit upgrades to a stronger level at most once, so always-on
# verification adds one dict lookup to the steady-state compile path.
_VERIFIED: dict = {}


def _verify_mode(explicit: Optional[str]) -> str:
    """Resolve the verification level: an explicit `verify=` argument
    wins; otherwise the REPRO_VERIFY env var (CI's verify lane sets
    "full"); default "structural" — the cheap selector-free rules run
    on every compile."""
    import os
    mode = explicit if explicit is not None \
        else os.environ.get("REPRO_VERIFY", "structural")
    from repro_torch.core.verify import VERIFY_LEVELS
    if mode not in VERIFY_LEVELS:
        raise ValueError(
            f"verify must be one of {VERIFY_LEVELS}, got {mode!r}")
    return mode


def _ensure_verified(prog: Program, schedule: Schedule, mode: str,
                     key) -> None:
    if mode == "off":
        return
    done = _VERIFIED.setdefault(key, set())
    if mode in done or "full" in done:
        return
    from repro_torch.core import verify as _verify
    _verify.verify_program(prog, schedule, level=mode)
    done.add(mode)


def compile_schedule(schedule: Schedule, segments: Optional[int] = None,
                     codec: Optional[str] = None, stream: bool = True,
                     stacked: bool = True,
                     verify: Optional[str] = None) -> Program:
    """Lower a Schedule to a Program (memoized — compilation is trace-time
    control-plane work, like the uC caching assembled microcode).

    Two optimization passes run by default; tests disable them to hold
    the unfused program as a bitwise reference:

      stream   fuse uniform runs of segmented exchanges into cross-step
               STREAM pipelines (`fuse_streams`) and proven runs of
               unrolled segmented exchanges into STREAM_CHAINs
               (`fuse_chains`) — only at segments > 1.
      stacked  collapse relay='original' copy runs into one STACKED_RECV
               scatter (`fuse_stacked_recv`) — only at segments == 1
               (segmented copy runs stream through `fuse_chains`).

    `verify` selects the static-verifier level applied to the compiled
    program ("off" | "structural" | "full"; None = REPRO_VERIFY env var,
    default "structural") — see `core/verify.py`. A program that fails
    verification raises `VerifyError` and is never cached.
    """
    k_req = int(segments if segments is not None else schedule.segments)
    if k_req < 1:
        raise ValueError(f"segments must be >= 1, got {k_req}")
    mode = _verify_mode(verify)
    key = (schedule, k_req, codec, bool(stream), bool(stacked))
    hit = _COMPILE_CACHE.get(key)
    tr = telemetry.current()
    if hit is not None:
        if tr.enabled:
            tr.instant("compile.cache_hit", track="compile",
                       schedule=schedule.name, segments=k_req, codec=codec)
        _ensure_verified(hit, schedule, mode, key)
        return hit

    with tr.span("compile", track="compile", schedule=schedule.name,
                 collective=schedule.collective, segments=k_req,
                 codec=codec) as sp:
        ops: list = []
        if schedule.pre_rotate == "bruck":
            ops.append(Copy("bruck_pre"))
        steps = schedule.steps
        i = 0
        while i < len(steps):
            run = _detect_run(steps, i)
            if run is not None:
                trip, period = run
                slot_ops = tuple(
                    _exchange_ops(steps[i + j], schedule.relay, None, k_req,
                                  codec)
                    for j in range(period))
                ops.append(Loop(base=i, trip=trip, period=period,
                                slots=slot_ops))
                i += trip * period
            else:
                ops.extend(_exchange_ops(steps[i], schedule.relay, i, k_req,
                                         codec))
                i += 1
        if schedule.post_rotate == "bruck":
            ops.append(Copy("bruck_post"))

        ops = tuple(ops)
        # fusion passes; when tracing, each pass records whether it ran
        # and whether it accepted (rewrote ops) or rejected, with reason
        passes = [] if tr.enabled else None
        if stream and k_req > 1:
            pre = len(ops)
            ops = fuse_streams(ops, k_req, schedule.nranks)
            if passes is not None:
                passes.append(_fusion_rec("fuse_streams", pre, len(ops)))
            pre = len(ops)
            ops = fuse_chains(ops, k_req, schedule.nranks)
            if passes is not None:
                passes.append(_fusion_rec("fuse_chains", pre, len(ops)))
        elif passes is not None:
            reason = "segments == 1" if k_req == 1 else "stream=False"
            passes.append({"pass": "fuse_streams", "ran": False,
                           "reason": reason})
            passes.append({"pass": "fuse_chains", "ran": False,
                           "reason": reason})
        if stacked and k_req == 1:
            pre = len(ops)
            ops = fuse_stacked_recv(ops, schedule.nranks)
            if passes is not None:
                passes.append(_fusion_rec("fuse_stacked_recv", pre,
                                          len(ops)))
        elif passes is not None:
            reason = "segments > 1" if k_req > 1 else "stacked=False"
            passes.append({"pass": "fuse_stacked_recv", "ran": False,
                           "reason": reason})

        prog = Program(
            name=schedule.name, collective=schedule.collective,
            nranks=schedule.nranks, chunks=schedule.chunks,
            relay=schedule.relay, segments=k_req, codec=codec,
            ops=ops, overlap_factor=schedule.overlap_factor,
            level_sizes=schedule.level_sizes)
        try:
            _ensure_verified(prog, schedule, mode, key)
        except Exception as e:
            if tr.enabled:
                tr.instant("compile.verify_failed", track="compile",
                           schedule=schedule.name, verify=mode,
                           error=type(e).__name__)
            raise
        if tr.enabled:
            sp.add(ops=len(ops), verify=mode, passes=passes)
        batches(prog)
        if len(_COMPILE_CACHE) >= _COMPILE_CACHE_MAX:
            evicted = next(iter(_COMPILE_CACHE))  # FIFO eviction
            _COMPILE_CACHE.pop(evicted)
            _VERIFIED.pop(evicted, None)
        _COMPILE_CACHE[key] = prog
    return prog


def _fusion_rec(name: str, pre: int, post: int) -> dict:
    """One fusion pass's span record: accepted iff it rewrote the ops."""
    rec = {"pass": name, "ran": True, "accepted": post != pre,
           "ops_before": pre, "ops_after": post}
    if post == pre:
        rec["reason"] = "no fusible run"
    return rec
