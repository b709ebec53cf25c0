"""The LM's spans in a traced run (`repro_torch`'s `moe.*`, `ssm.*`,
`lm.*` and the engine's under them), read by the Granite cell's
per-layer metrics. Each function returns None where the program recorded
no span (a tree without them, an untraced run)."""
from __future__ import annotations

from typing import Optional

import bench_spans


# the program's device-to-host reads, where the host waits for the
# device's queued work: device wait, not the host work a self time reads
WAITS = ("moe.count_sync",)


def _self_ms(run, prefix: str) -> Optional[float]:
    """The self time of the spans named `prefix`* outside every engine
    span and the waits (`WAITS`), less the kernel entry points' ns, a
    traced call, ms."""
    sp = bench_spans.spans(run)
    if sp is None:
        return None
    by_id = {s.id: s for s in sp}
    hits = [s for s in sp if s.name.startswith(prefix)
            and s.name not in WAITS and not any(
                a.name.startswith("engine.")
                for a in bench_spans._ancestors(s, by_id))]
    if not hits:
        return None
    return bench_spans.per_call_ms(run, sum(s.self_ns for s in hits))


def moe_ms(run) -> Optional[float]:
    return _self_ms(run, "moe.")


def ssm_ms(run) -> Optional[float]:
    return _self_ms(run, "ssm.")


def a2a_ms(run) -> Optional[float]:
    """The whole duration of the engine's alltoall spans under the MoE's
    dispatch and combine, a traced call, ms."""
    sp = bench_spans.spans(run)
    if sp is None:
        return None
    by_id = {s.id: s for s in sp}
    hits = [s for s in sp if s.name == "engine.alltoall" and any(
        a.name in ("moe.dispatch", "moe.combine")
        for a in bench_spans._ancestors(s, by_id))]
    if not hits:
        return None
    return bench_spans.per_call_ms(run, sum(s.dur for s in hits))


def slot_ratio(run) -> Optional[float]:
    """The dispatch rows sent over the routed assignments (`moe.slots` /
    `moe.assignments`) of the traced calls."""
    sp = bench_spans.spans(run)
    if sp is None:
        return None
    got: dict = {}
    for s in sp:
        if s.parent is None:
            for k in ("moe.slots", "moe.assignments"):
                got[k] = got.get(k, 0) + s.counters.get(k, 0)
    if not got.get("moe.assignments"):
        return None
    return got["moe.slots"] / got["moe.assignments"]
