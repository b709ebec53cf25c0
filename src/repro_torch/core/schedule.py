"""Microcode schedule IR — the ACCL+ DMP instruction stream, as data.

In ACCL+ a collective algorithm lives in uC *firmware*: the uC emits
microcode instructions to the Data Movement Processor, each with two operand
slots (data into the CCLO: from memory / from network) and one result slot
(data out: to memory / to network / through an arithmetic plugin).

Here a collective algorithm is a `Schedule`: an ordered list of `Step`s.
Each step is one DMP instruction burst across all ranks:

  operand slot 0  = the local chunk selected by `send_sel`   (memory -> engine)
  operand slot 1  = the chunk arriving over `perm`           (network -> engine)
  plugin          = `op` (copy/add/max/min/mul, or compressed variants)
  result slot     = `recv_sel` placement back into the local buffer

Because the selection must be SPMD-uniform code but rank-dependent data,
selectors are tiny closures `(rank_tracer, step_index) -> chunk index` (or
`(offset, length)` ranges) evaluated on the traced `lax.axis_index` value.
The schedule itself — permutation pairs, op, byte volumes — is plain data,
inspectable and costable without tracing anything. That is the property the
paper gets from firmware: the algorithm can be swapped without touching the
datapath (here: without touching model code).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

# Combine ops the arithmetic plugin supports (binary streaming plugins).
COMBINE_OPS = ("copy", "add", "max", "min", "mul")

# Selector kinds.
SEL_CHUNK = "chunk"   # fn(rank, step) -> chunk index (single chunk of n)
SEL_RANGE = "range"   # fn(rank, step) -> (chunk_offset, n_chunks)
SEL_MASK = "mask"     # fn(rank, step) -> static tuple of chunk indices
SEL_ALL = "all"       # whole buffer


@dataclasses.dataclass(frozen=True)
class Sel:
    """Chunk selector: which slice of the local buffer a slot touches."""

    kind: str
    fn: Optional[Callable] = None  # (rank, step) -> idx | (off, len) | mask

    @staticmethod
    def all() -> "Sel":
        return Sel(SEL_ALL)

    @staticmethod
    def chunk(fn: Callable) -> "Sel":
        return Sel(SEL_CHUNK, fn)

    @staticmethod
    def range(fn: Callable) -> "Sel":
        return Sel(SEL_RANGE, fn)

    @staticmethod
    def mask(fn: Callable) -> "Sel":
        return Sel(SEL_MASK, fn)


@dataclasses.dataclass(frozen=True)
class Step:
    """One DMP instruction burst (all ranks move in parallel).

    perm:      (src, dst) pairs executed as one collective-permute.
    op:        arithmetic-plugin combine applied at the receiver.
    send_sel:  operand slot 0 — what each rank puts on the wire.
    recv_sel:  result slot   — where the arriving chunk lands locally.
    bytes_frac: fraction of the full buffer this step moves per rank
               (for the alpha-beta cost model; 1/n for chunked rings).
    mask_recv: if True, ranks not appearing as a dst keep their old data
               (ppermute delivers zeros to non-destinations; trees need
               the mask, rings where everyone receives do not).
    uniform:   the selector closures are pure arithmetic in
               (rank, step_index) — valid under a *traced* step index —
               and shared (by object identity) across the run of equal
               steps. The IR compiler rolls such runs into a LOOP micro-op
               (one lax.scan) instead of unrolling them, keeping O(n)-step
               rings at O(1) live buffers.
    segmentable: wire-segmentation eligibility. None = infer from the
               selector kinds (contiguous all/chunk/range regions segment;
               mask regions do not). True = force-allow: the algorithm
               asserts send/recv masks are identical so the gathered
               payload can be cut into wire segments and scattered back.
               False = never segment this step.
    """

    perm: tuple
    op: str = "copy"
    send_sel: Sel = dataclasses.field(default_factory=Sel.all)
    recv_sel: Sel = dataclasses.field(default_factory=Sel.all)
    bytes_frac: float = 1.0
    mask_recv: bool = False
    uniform: bool = False
    segmentable: Optional[bool] = None
    # Hierarchical (two-level) schedules tag each step with the level it
    # runs on ("intra" = inner/ICI group, "inter" = outer/DCN group) and
    # the permutation in that level's own rank space. The cost walk prices
    # the exchange on `comm.level_comm(level)`'s fabric; the engine
    # ppermutes `level_perm` on the level's own mesh axis. Flat schedules
    # leave both None.
    level: Optional[str] = None
    level_perm: Optional[tuple] = None

    def __post_init__(self):
        if self.op not in COMBINE_OPS:
            raise ValueError(f"unknown combine op {self.op!r}")

    def signature(self) -> tuple:
        """Loop-coalescing identity: steps with equal signatures execute
        the same micro-ops and differ only in the step index."""
        return (self.perm, self.op, self.send_sel, self.recv_sel,
                self.mask_recv, self.uniform, self.segmentable,
                self.level, self.level_perm)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A complete collective algorithm for `nranks` ranks.

    `chunks` is the number of equal chunks the buffer is divided into
    (1 = unchunked). `result` documents what the buffer holds afterwards
    ('full' = every rank has the collective result, 'shard' = rank r holds
    chunk owned(r), 'root' = only the root's buffer is meaningful).
    """

    name: str
    collective: str
    nranks: int
    steps: tuple  # tuple[Step, ...]
    chunks: int = 1
    result: str = "full"
    # rank -> which chunk index that rank owns in 'shard' results.
    owned_chunk: Optional[Callable] = None
    # What each rank puts on the wire: 'buffer' (its accumulator — rings,
    # trees), 'received' (relay of last arrival — eager ring reduce),
    # 'original' (its untouched input — all-to-one, linear a2a).
    relay: str = "buffer"
    # >1 when steps use independent links concurrently (bidirectional ring).
    overlap_factor: float = 1.0
    # Local chunk rotations around the wire phase (Bruck all-to-all).
    pre_rotate: Optional[str] = None
    post_rotate: Optional[str] = None
    # Chunk-index coordinate system: 'absolute' (chunk j = rank j's slot) or
    # 'relative' (chunk j = rank (root+j)%n's slot — binomial gather).
    chunk_coords: str = "absolute"
    # Wire segmentation: each step's payload is split into this many
    # Rx-buffer-sized segments and pipelined (segment s+1 rides the wire
    # while segment s is combined — ACCL+ §4.4.3). 1 = unsegmented.
    segments: int = 1
    # Two-level hierarchical schedules record the level rank counts here,
    # e.g. {"inter": pod_size, "intra": ici_size}; None for flat.
    level_sizes: Optional[tuple] = None

    # ---- static cost terms (selector + EXPERIMENTS tables) ---------------
    def n_steps(self) -> int:
        return len(self.steps)

    def bytes_on_wire(self, msg_bytes: float) -> float:
        """Per-rank bytes sent over the whole schedule."""
        return float(msg_bytes) * sum(s.bytes_frac for s in self.steps)

    def with_segments(self, segments: int) -> "Schedule":
        """Copy of this schedule with the segmentation knob set."""
        if segments == self.segments:
            return self
        return dataclasses.replace(self, segments=int(segments))

    def compile(self, segments: Optional[int] = None,
                codec: Optional[str] = None, stream: bool = True,
                stacked: bool = True, verify: Optional[str] = None):
        """Lower this schedule to a micro-op `Program` (core/program.py).

        The program is the single artifact of BOTH execution and cost:
        `engine.execute_program` (XLA) and `simulator.execute_program`
        (numpy) run it, and `Program.cost` prices it (there is no
        schedule-walk pricing any more). `segments` overrides the
        schedule's own knob; `codec` names a wire compressor from
        `plugins.CODECS`; `stream`/`stacked` gate the optimization
        passes (tests hold the unfused program as a bitwise reference);
        `verify` sets the static-verifier level ("off" | "structural" |
        "full", None = REPRO_VERIFY env var — see `core/verify.py`).
        """
        from repro_torch.core import program as prog  # local: avoid import cycle
        return prog.compile_schedule(self, segments=segments, codec=codec,
                                     stream=stream, stacked=stacked,
                                     verify=verify)

    def validate(self) -> None:
        """Structural checks (the 'firmware assembler')."""
        for i, s in enumerate(self.steps):
            seen_src, seen_dst = set(), set()
            for src, dst in s.perm:
                if not (0 <= src < self.nranks and 0 <= dst < self.nranks):
                    raise ValueError(f"step {i}: pair ({src},{dst}) out of range")
                if src in seen_src or dst in seen_dst:
                    raise ValueError(f"step {i}: duplicate src/dst in perm")
                seen_src.add(src)
                seen_dst.add(dst)
        if self.result == "shard" and self.owned_chunk is None:
            raise ValueError("shard-result schedule needs owned_chunk map")
