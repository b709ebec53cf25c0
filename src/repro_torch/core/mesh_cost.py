"""Mesh-level contention-aware makespan (the shared-engine cost view).

`Sequencer.makespan` prices ONE communicator's queue in isolation. Real
training/serving steps run grad-sync, pipeline p2p, and offloaded app
collectives concurrently over the same chips and fabrics — ACCL+'s whole
premise is the engine as a *shared* offload resource — and per-queue
isolation prices two saturating queues on one fabric as if they ran 2x
parallel. `MeshMakespan` composes ALL queues over the physical links
(`topology.FabricOccupancy`):

  mesh = max( max over queues of the queue's own makespan,
              max over GLOBAL dependency chains of sum(full_i),
              max over physical links of sum(wire on that link)
                  + max over items of latency_i )

  * Per-queue term: each queue still prices at least its own pipelined
    drain (`Sequencer._compose`) — composition never discounts below a
    queue running alone, and a single-queue mesh makespan is BITWISE
    equal to `Sequencer.makespan`.
  * Global chain term: dependency chains crossing communicators (e.g.
    `issue_multi`'s RS -> recurse -> AG over `("pod", "data")`) price as
    one DAG — full costs serialize along the chain exactly as within one
    queue, instead of each axis's FIFO pretending the other is free.
  * Link term: wire seconds attributed per physical link by
    `Program.cost_terms(per_link=True)` SERIALIZE when queues share the
    link (two saturating same-fabric queues price ~the serial sum), and
    stay independent on disjoint fabrics (the busiest link bounds).
    Queued alpha still hides: only the single largest item latency is
    added, the same credit the per-queue model grants.

All prices come from `Sequencer._priced_plan` — the same compiled
programs, the same `PricingEnv` — so the composition never re-walks a
program. Nothing here mutates queue state: composing is a read.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.pricing import PricingEnv
from repro_torch.core.topology import FabricOccupancy


class MeshMakespan:
    """Composes many sequencer queues' prices over shared fabric links.

    Usage::

        mm = MeshMakespan()
        mm.add(seq_a, "data", env)      # one call per (queue, axis)
        mm.add(seq_b, "data", env)
        total = mm.total()              # contention-aware seconds

    or, for every outstanding axis of one sequencer::

        total = MeshMakespan.of(seq, env).total()
    """

    def __init__(self, occupancy: Optional[FabricOccupancy] = None):
        self.occupancy = occupancy if occupancy is not None \
            else FabricOccupancy()
        self._queues: list = []    # (sequencer, axis, env)

    def add(self, seq, axis, env: Optional[PricingEnv] = None
            ) -> "MeshMakespan":
        """Register one communicator queue; returns self for chaining."""
        self._queues.append((seq, axis,
                             env if env is not None else PricingEnv()))
        return self

    @classmethod
    def of(cls, seq, env: Optional[PricingEnv] = None,
           occupancy: Optional[FabricOccupancy] = None) -> "MeshMakespan":
        """Every outstanding axis of `seq` (cross-axis chains included),
        in first-issue order."""
        mm = cls(occupancy=occupancy)
        for axis in seq.axes_outstanding():
            mm.add(seq, axis, env)
        return mm

    def _composed(self) -> dict:
        """The full composition state, computed once.

        Every float here is produced by the exact operation sequence the
        original `report()` used — `report()` and `timeline()` are both
        thin views over this, so the timeline's last interval end equals
        `mesh_makespan_s` *bitwise*, not approximately.
        """
        occ = self.occupancy
        queues = []
        entries = []   # (min_rid, item, full_s, lat_s, wire_s, links, axis)
        for seq, axis, env in self._queues:
            _comm, items, recs = seq._priced_plan(axis, env)
            own = seq._compose(items, recs) if items else 0.0
            queues.append({"axis": axis, "items": len(items),
                           "makespan_s": own})
            for it, (full, lat, wire, links) in zip(items, recs):
                entries.append((min(r.rid for r in it.requests),
                                it, full, lat, wire, links, axis))
        # global dependency DAG: items in issue order, chains serialize
        # full costs across queues (the within-queue recurrence, widened)
        entries.sort(key=lambda e: e[0])
        pos = {r: i for i, e in enumerate(entries) for r in e[1].requests}
        chain = [0.0] * len(entries)
        starts = [0.0] * len(entries)
        for i, (_rid, it, full, _lat, _w, _links, _ax) in enumerate(entries):
            best = 0.0
            for r in it.requests:
                for d in r.deps:
                    j = pos.get(d)
                    if j is not None and j < i:
                        best = max(best, chain[j])
            starts[i] = best
            chain[i] = best + full
        # per-physical-link busy time: wire serializes on a shared link.
        # The cursor intervals ARE the accumulation: each item's window on
        # a link is [busy-so-far, busy-so-far + w], so the last window's
        # end is the final busy value, bitwise.
        busy: dict = {}
        link_iv = []   # (canonical_key, start_s, end_s, entry_index)
        for i, (_rid, _it, _full, _lat, _w, links, _ax) in \
                enumerate(entries):
            for key, w in links.items():
                ck = occ.canonical(key)
                start = busy.get(ck, 0.0)
                busy[ck] = start + w
                link_iv.append((ck, start, busy[ck], i))
        max_lat = max((e[3] for e in entries), default=0.0)
        link_term = max(busy.values(), default=0.0) + max_lat
        terms = [q["makespan_s"] for q in queues]
        terms.append(max(chain, default=0.0))
        terms.append(link_term)
        return {
            "mesh": max(terms, default=0.0),
            "chain": chain, "starts": starts, "entries": entries,
            "queues": queues, "busy": busy, "link_iv": link_iv,
            "max_lat": max_lat, "link_term": link_term,
        }

    def report(self) -> dict:
        """The composition, with its terms exposed for telemetry.

        {"mesh_makespan_s", "chain_s", "queues": [...], "links": {...}}
        — `queues` holds each registered queue's isolated makespan,
        `links` the per-physical-link busy seconds and capacity.
        """
        c = self._composed()
        occ = self.occupancy
        return {
            "mesh_makespan_s": c["mesh"],
            "chain_s": max(c["chain"], default=0.0),
            "queues": c["queues"],
            "links": {k: {"busy_s": v, "capacity_Bps": occ.capacity(k)}
                      for k, v in c["busy"].items()},
        }

    def timeline(self) -> dict:
        """Expand the composed makespan into virtual-clock intervals.

        Returns `{"end_s", "queues", "requests", "links"}` where every
        interval is `{"name", "track", "start_s", "end_s", ...}`:

        * one **queue** interval per registered queue ([0, own
          makespan]) on track `queue:<axis>`;
        * one **request** interval per plan item, chain-placed
          ([chain start, chain start + full]) with its wait/wire/lat
          split and coalesced flag;
        * one **link** interval per (item, physical link) — wire
          seconds serialized on the link's cursor — plus one trailing
          `alpha` interval on the busiest link for the queued-latency
          credit the link term adds.

        Feed it to `Tracer.ingest_timeline()` for Perfetto export.  The
        maximum `end_s` over all intervals equals
        `report()["mesh_makespan_s"]` **bitwise** (regression-gated in
        tests/test_telemetry.py): both are views over `_composed()`,
        which performs the float arithmetic exactly once.
        """
        from repro_torch.core.telemetry import axis_label
        c = self._composed()
        queues = []
        for q in c["queues"]:
            queues.append({"name": "drain", "axis": q["axis"],
                           "track": f"queue:{axis_label(q['axis'])}",
                           "start_s": 0.0, "end_s": q["makespan_s"]})
        requests = []
        for i, (_rid, it, full, lat, wire, _links, axis) in \
                enumerate(c["entries"]):
            requests.append({
                "name": "request", "axis": axis,
                "track": f"queue:{axis_label(axis)}",
                "start_s": c["starts"][i], "end_s": c["chain"][i],
                "rids": [r.rid for r in it.requests],
                "full_s": full, "lat_s": lat, "wire_s": wire,
                "coalesced": len(it.requests) > 1,
            })
        links = []
        for ck, start, end, i in c["link_iv"]:
            links.append({
                "name": "wire", "link": ck,
                "track": "link:" + "/".join(str(p) for p in ck),
                "start_s": start, "end_s": end,
                "rids": [r.rid for r in c["entries"][i][1].requests],
            })
        if c["busy"]:
            # the queued-alpha credit: one max-latency term after the
            # busiest link drains, ending exactly at link_term
            busiest = max(c["busy"], key=lambda k: c["busy"][k])
            links.append({
                "name": "alpha", "link": busiest,
                "track": "link:" + "/".join(str(p) for p in busiest),
                "start_s": c["busy"][busiest], "end_s": c["link_term"],
                "rids": [],
            })
        return {"end_s": c["mesh"], "queues": queues,
                "requests": requests, "links": links}

    def total(self) -> float:
        """Contention-aware seconds to drain every registered queue."""
        return self.report()["mesh_makespan_s"]
