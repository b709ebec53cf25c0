"""Algorithm & protocol selector — the runtime-tunable part of the firmware.

ACCL+ (§4.4.4): "The tuning of the algorithms for specific collective can be
done at runtime by setting configuration parameters to the CCLO engine and
we set these parameters according to our empirical experiment results."

We reproduce that: `Selector.choose()` COMPILES every registered
(algorithm, protocol, segments) candidate to its micro-op Program and
prices it with `Program.cost` (the alpha-beta walk over the exact ops the
engine will execute — stream fusion and peepholes included), picking the
cheapest. A user tuning table overrides the model (the paper's
"configuration parameters"), so deployments can pin choices measured on
their fabric — without touching any model code.

Protocol model (paper §4.4.3, adapted per DESIGN.md §5):
  eager       no handshake; receiver staging copy costs msg/eager_copy_bw.
              Only available while the message fits the Rx-buffer pool.
  rendezvous  +1 handshake RTT; zero-copy delivery.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import algorithms as algos
from repro_torch.core import hierarchical
from repro_torch.core import plugins
from repro_torch.core import telemetry
from repro_torch.core.program import Program, Stream, StreamChain, fit_segments
from repro_torch.core.schedule import Schedule
from repro_torch.core.topology import Communicator, ProductComm

# Which algorithms may run under which protocol (paper Table 1 + [+] ours).
ALGO_PROTOCOLS = {
    ("bcast", "one_to_all"): ("eager", "rendezvous"),
    ("bcast", "binomial_tree"): ("rendezvous",),
    ("reduce", "ring"): ("eager",),
    ("reduce", "all_to_one"): ("rendezvous", "eager"),
    ("reduce", "binomial_tree"): ("rendezvous",),
    ("gather", "ring"): ("eager",),
    ("gather", "all_to_one"): ("rendezvous", "eager"),
    ("gather", "binomial_tree"): ("rendezvous",),
    ("alltoall", "linear"): ("eager", "rendezvous"),
    ("alltoall", "bruck"): ("eager",),
    ("allreduce", "recursive_doubling"): ("eager", "rendezvous"),
    ("allreduce", "ring"): ("rendezvous",),
    ("allreduce", "bidi_ring"): ("rendezvous",),
    ("allreduce", "halving_doubling"): ("rendezvous",),
    ("reduce_scatter", "ring"): ("rendezvous",),
    ("reduce_scatter", "recursive_halving"): ("rendezvous",),
    ("allgather", "ring"): ("eager", "rendezvous"),
    ("allgather", "recursive_doubling"): ("rendezvous",),
}

# (collective, algorithm) pairs whose generators require 2^k ranks.
_POW2_ONLY = {
    ("allreduce", "recursive_doubling"),
    ("allreduce", "halving_doubling"),
    ("reduce_scatter", "recursive_halving"),
    ("allgather", "recursive_doubling"),
    ("alltoall", "bruck"),
    ("gather", "binomial_tree"),
}


@dataclasses.dataclass(frozen=True)
class Choice:
    collective: str
    algorithm: str
    protocol: str
    predicted_s: float
    schedule: Schedule
    segments: int = 1
    codec: Optional[str] = None  # wire compressor the pricing assumed
    # the compiled artifact the price was computed FROM — the exact
    # micro-op program (stream-fused, peepholed) the engine will execute
    program: Optional[Program] = None

    @property
    def compressed(self) -> bool:
        return self.codec is not None


class Selector:
    """Prices schedules; honours a user tuning table first.

    Segmentation (ACCL+ §4.4.3): `choose` picks the wire segment count
    jointly with algorithm/protocol — each candidate schedule is priced at
    every admissible segment count and the cheapest (algo, proto, segments)
    triple wins. `choose` is memoized on (collective, msg_bytes, comm) so a
    training step that re-issues the same collective never re-runs the
    generators or the pricing sweep; `set_tuning` invalidates the cache.
    """

    #: segment counts the selector sweeps (1 = unsegmented baseline).
    DEFAULT_SEGMENT_CANDIDATES = (1, 2, 4, 8, 16, 32)

    def __init__(self, eager_max_bytes: Optional[int] = None,
                 segment_candidates: tuple = DEFAULT_SEGMENT_CANDIDATES,
                 min_segment_bytes: int = 8 * 1024):
        # None (default) = use the communicator's per-fabric cap
        # (`Communicator.eager_max_bytes`: the DCN Rx staging pool is
        # smaller than the ICI one). An explicit value overrides both —
        # the pre-per-fabric behaviour, kept for tests/tools that pin it.
        self.eager_max_bytes = eager_max_bytes
        self.segment_candidates = tuple(segment_candidates)
        # Rx-buffer floor: never cut a step's payload below this many bytes
        # (tiny segments are all alpha, and real Rx buffers have a floor).
        # This is the fallback when no communicator is given; with one, the
        # per-fabric floor applies (`Communicator.min_segment_bytes`) — the
        # 10 us DCN alpha prices a far larger floor than the ICI one.
        self.min_segment_bytes = min_segment_bytes
        # (collective, lo_bytes, hi_bytes, nranks_or_None, algorithm, segs)
        self._tuning: list[tuple] = []
        self._cache: dict = {}
        # generator/memoization telemetry, asserted on in tests; `stats`
        # is the read-compatible live view over the registry
        self.metrics = telemetry.MetricsRegistry()
        for _name in ("choose_calls", "cache_hits", "gen_calls"):
            self.metrics.counter(_name)
        self.stats = self.metrics.view()
        # last uncached choose: candidates priced + margin over runner-up
        self._last_priced = 0
        self._last_margin: Optional[float] = None

    #: set_tuning codec wildcard: the rule applies whatever codec the
    #: choose is pricing (the pre-codec-aware behaviour).
    ANY_CODEC = "any"

    # -- the paper's runtime configuration parameters ----------------------
    def set_tuning(self, collective: str, algorithm: str,
                   lo_bytes: int = 0, hi_bytes: int = 1 << 62,
                   nranks: Optional[int] = None,
                   segments: Optional[int] = None,
                   codec: Optional[str] = ANY_CODEC) -> None:
        """Pin an algorithm (and optionally segment count) for a bucket.

        `codec` scopes the rule: ANY_CODEC (default) matches every
        choose; None matches only uncompressed chooses; a codec name
        matches only chooses pricing that codec — so tables measured on
        compressed wires never leak into uncompressed selection.
        """
        self._tuning.append((collective, lo_bytes, hi_bytes, nranks,
                             algorithm, segments, codec))
        self._cache.clear()  # stale choices may no longer honour the table

    def _tuned(self, collective: str, msg_bytes: int, n: int,
               codec: Optional[str] = None
               ) -> tuple[Optional[str], Optional[int]]:
        """Last-set matching rule wins (algorithm, pinned segment count)."""
        for (c, lo, hi, nr, algo, segs, cdc) in reversed(self._tuning):
            if (c == collective and lo <= msg_bytes < hi
                    and (nr is None or nr == n)
                    and (cdc == self.ANY_CODEC or cdc == codec)):
                return algo, segs
        return None, None

    # -- pricing ------------------------------------------------------------
    def _protocol_overhead(self, protocol: str, msg_bytes: float,
                           comm: Communicator,
                           eager_cap: Optional[float] = None
                           ) -> Optional[float]:
        if protocol == "eager":
            # cap precedence: the pricing env's per-call override
            # (`PricingEnv.eager_max_bytes`), then the selector-level
            # constructor override, then the communicator's per-fabric
            # Rx staging pool (DCN comms reject eager at sizes the ICI
            # pool still accepts)
            cap = eager_cap
            if cap is None:
                cap = self.eager_max_bytes
            if cap is None:
                cap = comm.eager_max_bytes
            if msg_bytes > cap:
                return None  # Rx-buffer pool exceeded
            return msg_bytes / comm.hw.eager_copy_bw
        return comm.hw.rendezvous_rtt

    @staticmethod
    def _wire_scale(codec: Optional[str], elem_bytes: int) -> float:
        """Wire bytes per payload byte under `codec` (1.0 uncompressed)."""
        if codec is None:
            return 1.0
        return plugins.get_codec(codec).wire_bytes_per_elem / float(
            elem_bytes)

    def price_program(self, prog: Program, protocol: str, msg_bytes: float,
                      comm: Communicator, elem_bytes: int = 4,
                      eager_cap: Optional[float] = None) -> Optional[float]:
        """Protocol overhead + `Program.cost` — the hot-path pricer.

        The program IS the costed artifact: LOOP trip counts, SEG_LOOP /
        STREAM fill-drain, per-op codec wire bytes, and the fabric's
        alpha/segment floors are all read off the compiled ops, so the
        selector prices exactly what the engine will execute (the retired
        `predict_time` priced the schedule instead).
        """
        ov = self._protocol_overhead(protocol, msg_bytes, comm,
                                     eager_cap=eager_cap)
        if ov is None:
            return None
        return prog.cost(msg_bytes, comm, elem_bytes=elem_bytes) + ov

    def price(self, schedule: Schedule, protocol: str, msg_bytes: float,
              comm: Communicator, segments: int = 1,
              codec: Optional[str] = None, elem_bytes: int = 4,
              eager_cap: Optional[float] = None) -> Optional[float]:
        """Compile (memoized) then price — see `price_program`."""
        return self.price_program(
            schedule.compile(segments=segments, codec=codec), protocol,
            msg_bytes, comm, elem_bytes=elem_bytes, eager_cap=eager_cap)

    def admissible_segments(self, schedule: Schedule, msg_bytes: float,
                            comm: Optional[Communicator] = None,
                            codec: Optional[str] = None,
                            elem_bytes: int = 4) -> tuple:
        """Segment counts worth sweeping for this schedule/message.

        A step's per-segment *wire* payload must stay >= the fabric's
        segment floor (`Communicator.min_segment_bytes`: the DCN floor is
        far above the ICI one because of its 10 us alpha); k=1 is always
        admissible. Compressed wires shrink the per-segment bytes by the
        codec ratio, so they admit fewer segments at equal message size.
        Copy-only schedules have no combine work for SEG_LOOP to overlap,
        so a segment count is admissible for them only when the program
        compiled AT THAT COUNT cross-step streams the copies between hops
        (ring allgather's STREAM, linear all-to-all's and recursive
        doubling's STREAM_CHAIN; bcast trees never stream, so
        segmentation would only add per-segment alpha there). The probe
        is per count because stream eligibility is: recursive doubling's
        region-overlap proof admits k >= 3 but rejects k = 2. It reads
        the compiled artifact rather than hard-coding a schedule family.
        (A tuning-table entry can still pin segments explicitly. Combine
        schedules keep their full floor-admissible ladder: the split cost
        model already prices their non-streaming counts as serialized, so
        the sweep never picks one.)
        """
        if not schedule.steps:
            return (1,)
        floor = (comm.min_segment_bytes if comm is not None
                 else self.min_segment_bytes)
        scale = self._wire_scale(codec, elem_bytes)
        # the floor applies to the largest wire crossing that segments:
        # combine steps when present (copy phases ship uncompressed and
        # ride along), else the copy steps of a streamed copy schedule
        combine_bytes = [msg_bytes * s.bytes_frac * scale
                         for s in schedule.steps if s.op != "copy"]
        step_bytes = (max(combine_bytes) if combine_bytes
                      else max(msg_bytes * s.bytes_frac
                               for s in schedule.steps))
        out = [int(k) for k in self.segment_candidates
               if k == 1 or step_bytes / k >= floor]
        if all(s.op == "copy" for s in schedule.steps):
            out = [k for k in out
                   if k == 1 or any(
                       isinstance(op, (Stream, StreamChain))
                       for op in schedule.compile(segments=k).ops)]
        return tuple(out) or (1,)

    def fit_candidate_segments(self, schedule: Schedule, msg_bytes: int,
                               seg_space, codec: Optional[str] = None,
                               elem_bytes: int = 4,
                               lead_dim: Optional[int] = None) -> tuple:
        """Clamp candidate segment counts to what the executor will admit.

        The data plane clamps every requested count through
        `fit_segments` at trace time (divisor of the payload, whole codec
        scale blocks). Pricing a count the executor will then shrink
        would make `Choice.segments` a fiction — the engine would run
        fewer segments than were priced (the old ROADMAP "prices
        requested k" item). The engine flattens and pads the message to
        a multiple of `schedule.chunks`, so every contiguous payload is
        a whole multiple of the chunk size: a count that divides the
        chunk size divides every step's payload, and the executor admits
        it unchanged. Clamping here (duplicates dropped, order kept)
        makes the priced k and the executed k agree by construction.

        `alltoall` keeps its caller's 2-D shape, so its payload grid is
        leading-dim ROWS (`lead_dim / chunks` per chunk), not the flat
        element grid — callers pass `lead_dim` and the clamp runs on the
        row grid the executor will actually see, so an indivisible
        leading dim can no longer execute fewer segments than the priced
        `Choice.segments`.
        """
        elems = max(1, int(msg_bytes) // max(1, int(elem_bytes)))
        row_elems = 1
        if schedule.collective == "alltoall" and lead_dim:
            # the executor's fit_segments runs on payload rows: one
            # chunk of the caller's leading dim per exchange
            csize = max(1, int(lead_dim) // schedule.chunks)
            row_elems = max(1, elems // max(1, int(lead_dim)))
        elif schedule.collective in ("allgather", "gather"):
            # gathers price the per-rank SHARD (`msg_bytes`) but execute
            # on the nranks*shard buffer, whose chunk IS one shard — the
            # executable grid is the shard itself, not shard/chunks
            csize = elems
        else:
            csize = (elems + (-elems) % schedule.chunks) // schedule.chunks
        block = 1
        if codec is not None:
            block = plugins.get_codec(codec).block_elems
        out, seen = [], set()
        for k in seg_space:
            kf = fit_segments(csize, int(k), row_elems, block)
            if kf not in seen:
                seen.add(kf)
                out.append(kf)
        return tuple(out)

    def candidates(self, collective: str, comm: Communicator):
        if comm.size < 2:
            return
        for (coll, algo), gen in algos.GENERATORS.items():
            if coll != collective:
                continue
            if (coll, algo) in _POW2_ONLY and not comm.is_pow2:
                continue
            yield algo, gen
        # out-of-tree collectives (plugins.register_collective) price
        # through the exact same sweep as the built-in table
        for algo, gen, _protos in plugins.custom_candidates(collective):
            yield algo, gen

    def _protocols(self, collective: str, algo: str) -> tuple:
        protos = ALGO_PROTOCOLS.get((collective, algo))
        if protos is not None:
            return protos
        for c_algo, _gen, c_protos in plugins.custom_candidates(collective):
            if c_algo == algo:
                return c_protos
        return ("rendezvous",)

    def choose(self, collective: str, msg_bytes: int, comm: Communicator,
               codec: Optional[str] = None, elem_bytes: int = 4,
               lead_dim: Optional[int] = None, env=None) -> Choice:
        """Pick the cheapest (algorithm, protocol, segments) for a call.

        A `pricing.PricingEnv` (`env=`) threads the unified pricing
        knobs: `env.comm` overrides the positional comm, `env.lead_dim`
        fills `lead_dim` when not given, and `env.eager_max_bytes` caps
        the eager protocol for this call (precedence over the
        selector-level constructor override). The default env is
        bitwise-neutral.
        """
        self.metrics.inc("choose_calls")
        eager_cap = None
        if env is not None:
            if env.comm is not None:
                comm = env.comm
            if lead_dim is None:
                lead_dim = env.lead_dim
            eager_cap = env.eager_max_bytes
        # registry_version: (un)registering a custom collective must not
        # serve picks cached against the old candidate set; lead_dim is
        # part of the key because alltoall's executable segment grid is
        # its caller's leading dim, not just the byte count
        key = (collective, int(msg_bytes), comm, codec, int(elem_bytes),
               None if lead_dim is None else int(lead_dim), eager_cap,
               plugins.registry_version())
        hit = self._cache.get(key)
        tr = telemetry.current()
        if hit is not None:
            self.metrics.inc("cache_hits")
            if tr.enabled:
                tr.instant("selector.cache_hit", track="selector",
                           collective=collective, msg_bytes=int(msg_bytes),
                           algorithm=hit.algorithm, protocol=hit.protocol)
            return hit
        if tr.enabled:
            with tr.span("selector.choose", track="selector",
                         collective=collective, nranks=comm.size,
                         msg_bytes=int(msg_bytes), codec=codec) as sp:
                choice = self._choose_uncached(
                    collective, msg_bytes, comm, codec, elem_bytes,
                    lead_dim, eager_cap=eager_cap)
                sp.add(algorithm=choice.algorithm, protocol=choice.protocol,
                       segments=choice.segments,
                       predicted_s=choice.predicted_s,
                       candidates_priced=self._last_priced,
                       margin_s=self._last_margin)
        else:
            choice = self._choose_uncached(collective, msg_bytes, comm,
                                           codec, elem_bytes, lead_dim,
                                           eager_cap=eager_cap)
        self._cache[key] = choice
        return choice

    def _choose_uncached(self, collective: str, msg_bytes: int,
                         comm: Communicator, codec: Optional[str] = None,
                         elem_bytes: int = 4,
                         lead_dim: Optional[int] = None,
                         eager_cap: Optional[float] = None) -> Choice:
        if isinstance(comm, ProductComm):
            return self._choose_product(collective, msg_bytes, comm,
                                        codec, elem_bytes, lead_dim,
                                        eager_cap=eager_cap)
        tuned_algo, tuned_segs = self._tuned(collective, msg_bytes,
                                             comm.size, codec)
        custom_algos = {a for a, _g, _p
                        in plugins.custom_candidates(collective)}
        best: Optional[Choice] = None
        priced = 0
        second: Optional[float] = None
        for algo, gen in self.candidates(collective, comm):
            self.metrics.inc("gen_calls")
            try:
                sched = gen(comm)
            except ValueError:
                if algo in custom_algos:
                    # out-of-tree generators declare inapplicability to a
                    # communicator (e.g. pow2-only) by raising — skip,
                    # like the built-ins' _POW2_ONLY pre-filter
                    continue
                raise  # a built-in raising here is a bug, not a filter
            protos = self._protocols(collective, algo)
            seg_space = ((tuned_segs,) if tuned_algo == algo
                         and tuned_segs is not None
                         else self.admissible_segments(
                             sched, msg_bytes, comm, codec, elem_bytes))
            # price only counts the executor will actually run (the
            # trace-time fit_segments clamp, applied before pricing)
            seg_space = self.fit_candidate_segments(
                sched, msg_bytes, seg_space, codec, elem_bytes, lead_dim)
            tuned_best: Optional[Choice] = None
            for k in seg_space:
                # ONE compiled artifact per candidate: compiling through
                # the same Schedule instance the Choice carries means the
                # engine's memoized compile of choice.schedule returns
                # THIS program object — priced and executed artifacts are
                # identical, not merely equal
                sched_k = sched.with_segments(k)
                prog = sched_k.compile(codec=codec)
                for proto in protos:
                    t = self.price_program(prog, proto, msg_bytes, comm,
                                           elem_bytes=elem_bytes,
                                           eager_cap=eager_cap)
                    if t is None:
                        continue
                    priced += 1
                    cand = Choice(collective, algo, proto, t, sched_k,
                                  segments=k, codec=codec, program=prog)
                    if tuned_algo == algo:
                        if tuned_best is None or t < tuned_best.predicted_s:
                            tuned_best = cand
                    if best is None or t < best.predicted_s:
                        if best is not None and (second is None
                                                 or best.predicted_s < second):
                            second = best.predicted_s
                        best = cand
                    elif second is None or t < second:
                        second = t
            if tuned_best is not None:
                self._note_choice(priced, tuned_best, second)
                return tuned_best
        if best is None:
            raise ValueError(
                f"no applicable algorithm for {collective} over {comm}")
        self._note_choice(priced, best, second)
        return best

    def _note_choice(self, priced: int, winner: "Choice",
                     second: Optional[float]) -> None:
        """Stash candidates-priced / margin-over-runner-up for the
        `selector.choose` span (telemetry only — never read by pricing)."""
        self._last_priced = priced
        self._last_margin = (second - winner.predicted_s
                             if second is not None else None)

    def _choose_product(self, collective: str, msg_bytes: int,
                        comm: ProductComm, codec: Optional[str] = None,
                        elem_bytes: int = 4,
                        lead_dim: Optional[int] = None,
                        eager_cap: Optional[float] = None) -> Choice:
        """Two-level candidate family for a (pod x intra-pod) product.

        The `hierarchical:<intra>+<inter>` compositions are priced
        head-to-head against the flat algorithms over the product's
        bottleneck view (`ProductComm.flat`: full rank count, pod
        fabric). The hierarchical programs put 1/ici_size of the bytes
        on DCN, so they dominate from well below 1 MiB; the flat rows
        keep the comparison honest and remain the fallback the engine
        executes per axis when one is picked. A degenerate level
        (pod_size == 1 or intra == 1) delegates to the flat chooser
        over the one real level — flat wins by construction there.
        """
        if comm.outer.size < 2:
            return self._choose_uncached(collective, msg_bytes, comm.inner,
                                         codec, elem_bytes, lead_dim,
                                         eager_cap=eager_cap)
        if comm.inner.size < 2:
            return self._choose_uncached(collective, msg_bytes, comm.outer,
                                         codec, elem_bytes, lead_dim,
                                         eager_cap=eager_cap)
        if collective not in hierarchical.INTER_ALGOS:
            # no two-level composition (alltoall, reduce, gather):
            # price flat over the bottleneck view
            return self._choose_uncached(collective, msg_bytes, comm.flat,
                                         codec, elem_bytes, lead_dim,
                                         eager_cap=eager_cap)
        tuned_algo, tuned_segs = self._tuned(collective, msg_bytes,
                                             comm.size, codec)
        cands = []
        for intra in hierarchical.INTRA_ALGOS:
            for inter in hierarchical.inter_candidates(
                    collective, comm.outer.size):
                self.metrics.inc("gen_calls")
                sched = hierarchical.hierarchical_schedule(
                    collective, comm, intra=intra, inter=inter)
                # hierarchical programs span fabrics: rendezvous only
                # (per-region eager staging is not modeled)
                cands.append((sched.name, sched, ("rendezvous",), True))
        flat = comm.flat
        custom_algos = {a for a, _g, _p
                        in plugins.custom_candidates(collective)}
        for algo, gen in self.candidates(collective, flat):
            self.metrics.inc("gen_calls")
            try:
                sched = gen(flat)
            except ValueError:
                if algo in custom_algos:
                    continue
                raise
            cands.append((algo, sched, self._protocols(collective, algo),
                          False))
        best: Optional[Choice] = None
        priced = 0
        second: Optional[float] = None
        for algo, sched, protos, is_hier in cands:
            # per-level segment floors: a hierarchical candidate's ladder
            # comes from the inner (ICI) fabric — the cost walk and the
            # executor clamp each inter exchange to the DCN floor anyway
            floor_comm = comm.inner if is_hier else flat
            seg_space = ((tuned_segs,) if tuned_algo == algo
                         and tuned_segs is not None
                         else self.admissible_segments(
                             sched, msg_bytes, floor_comm, codec,
                             elem_bytes))
            seg_space = self.fit_candidate_segments(
                sched, msg_bytes, seg_space, codec, elem_bytes, lead_dim)
            tuned_best: Optional[Choice] = None
            for k in seg_space:
                sched_k = sched.with_segments(k)
                prog = sched_k.compile(codec=codec)
                for proto in protos:
                    t = self.price_program(prog, proto, msg_bytes, comm,
                                           elem_bytes=elem_bytes,
                                           eager_cap=eager_cap)
                    if t is None:
                        continue
                    priced += 1
                    cand = Choice(collective, algo, proto, t, sched_k,
                                  segments=k, codec=codec, program=prog)
                    if tuned_algo == algo:
                        if tuned_best is None or t < tuned_best.predicted_s:
                            tuned_best = cand
                    if best is None or t < best.predicted_s:
                        if best is not None and (second is None
                                                 or best.predicted_s < second):
                            second = best.predicted_s
                        best = cand
                    elif second is None or t < second:
                        second = t
            if tuned_best is not None:
                self._note_choice(priced, tuned_best, second)
                return tuned_best
        if best is None:
            raise ValueError(
                f"no applicable algorithm for {collective} over {comm}")
        self._note_choice(priced, best, second)
        return best

    # -- tuning-table artifacts (fig12 / EXPERIMENTS round-trips) -----------
    DEFAULT_TABLE_SIZES = (1 << 10, 1 << 13, 1 << 17, 1 << 20, 1 << 24,
                           1 << 27)

    def table(self, collective: str, comm: Communicator,
              sizes=DEFAULT_TABLE_SIZES, codec: Optional[str] = None,
              elem_bytes: int = 4):
        """Selection table — the fig12-style artifact for EXPERIMENTS.md.

        Each Choice carries the full tuning state for its size bucket:
        algorithm, protocol, chosen segment count, and the codec the
        pricing assumed (`Choice.compressed`) — so benchmark output and
        tuning-table round-trips are lossless (see `table_rows` /
        `apply_table`).
        """
        return {s: self.choose(collective, s, comm, codec=codec,
                               elem_bytes=elem_bytes) for s in sizes}

    def table_rows(self, collective: str, comm: Communicator,
                   sizes=DEFAULT_TABLE_SIZES, codec: Optional[str] = None,
                   elem_bytes: int = 4) -> list:
        """`table()` as JSON-ready rows (benchmark / EXPERIMENTS output)."""
        rows = []
        for size, c in self.table(collective, comm, sizes, codec,
                                  elem_bytes).items():
            rows.append({
                "collective": collective,
                "msg_bytes": int(size),
                "nranks": comm.size,
                "algorithm": c.algorithm,
                "protocol": c.protocol,
                "segments": int(c.segments),
                "compressed": c.compressed,
                "codec": c.codec,
                "predicted_s": float(c.predicted_s),
            })
        return rows

    def apply_table(self, rows) -> None:
        """Pin a `table_rows()` artifact back into the tuning table.

        The inverse of `table_rows`: every row becomes a size-bucketed
        tuning entry (algorithm AND segment count, scoped to its rank
        count AND the codec the table was priced under), so a selector
        seeded from a saved table reproduces the saved choices exactly —
        the lossless round-trip — without a compressed table leaking into
        uncompressed selection or vice versa.
        """
        # bucket within each (collective, nranks, codec) series — a mixed
        # artifact (several collectives' tables concatenated) must not
        # have one series' sizes truncating another's buckets
        series: dict = {}
        for r in rows:
            key = (r["collective"], r.get("nranks"), r.get("codec"))
            series.setdefault(key, []).append(r)
        for group in series.values():
            group = sorted(group, key=lambda r: int(r["msg_bytes"]))
            for i, r in enumerate(group):
                hi = (int(group[i + 1]["msg_bytes"]) if i + 1 < len(group)
                      else 1 << 62)
                self.set_tuning(r["collective"], r["algorithm"],
                                lo_bytes=int(r["msg_bytes"]), hi_bytes=hi,
                                nranks=r.get("nranks"),
                                segments=int(r["segments"]),
                                codec=r.get("codec"))
