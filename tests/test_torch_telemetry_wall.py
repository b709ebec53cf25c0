"""The wall-clock recorder (`core/telemetry.py::WallTracer`) and the spans
and counters the port records into it, on the CPU.

Under a `ProfilerActivity.CPU` session, with no tracer installed, an
8-rank stacked allreduce and a small `DLRMServer` record spans that nest
by parent id and share one call id a call or batch; the caches miss on
the first call alone; the kernel entry points count exactly the calls
made; results are bitwise those of an untraced run. With no profiler and
no tracer nothing is recorded, and an installed tick `Tracer` sees the
events it saw before the wall clock existed.
"""
import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import ParallelConfig
from repro_torch.configs.dlrm import reduced
from repro_torch.core import CollectiveEngine, telemetry
from repro_torch.core import engine as engine_mod
from repro_torch.kernels import ops as kops
from repro_torch.launch.dlrm_serve import DLRMServer

WALL = telemetry.WALL
#: the kernel entry points of `kernels/ops.py` (K1-K5, the indexed copy)
ENTRY_POINTS = ("fused_combine", "fused_combine_at", "quantize_int8",
                "dequantize_int8", "quantize_int8_at", "dequantize_int8_at",
                "matmul", "embedding_gather", "embedding_lookup_rows",
                "region_copy")


@contextlib.contextmanager
def profiled():
    """A CPU profiler session; yields the wall-clock spans recorded in it."""
    got: list = []
    first = WALL._ids
    with profile(activities=[ProfilerActivity.CPU]):
        assert telemetry.current() is WALL and telemetry.wall() is WALL
        yield got
    assert telemetry.LIVE is None
    got.extend(e for e in WALL.spans() if e["id"] > first)


def _calls(spans) -> dict:
    out: dict = {}
    for e in spans:
        out.setdefault(e["call"], []).append(e)
    return out


def _roots(spans) -> list:
    return [e for e in spans if e["parent"] is None]


def _input(size: int, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((8, size), generator=g)


def _server():
    return DLRMServer(reduced(), mesh_shape={"pod": 1, "data": 1, "model": 4},
                      device="cpu", seed=3,
                      pcfg=ParallelConfig(collective_matmul=True))


def _ids(seed: int, B: int = 8):
    rng = np.random.default_rng(seed)
    cfg = reduced()
    return torch.from_numpy(rng.integers(0, cfg.rows_per_table,
                                         (B, cfg.n_tables)).astype(np.int32))


def _check_nesting(spans) -> None:
    by_id = {e["id"]: e for e in spans}
    for e in spans:
        if e["parent"] is None:
            continue
        p = by_id[e["parent"]]
        assert p["call"] == e["call"]
        assert p["ts"] <= e["ts"] and \
            e["ts"] + e["dur"] <= p["ts"] + p["dur"]


@pytest.mark.parametrize("collective", ["allreduce", "allgather",
                                        "reduce_scatter"])
def test_engine_spans_nest_and_share_a_call_id(collective):
    eng = CollectiveEngine({"x": 8}, device="cpu")
    x = _input(4096)
    with profiled() as spans:
        for _ in range(3):
            getattr(eng, collective)(x, "x")
    _check_nesting(spans)
    calls = _calls(spans)
    assert len(calls) == 3 and len(_roots(spans)) == 3
    for group in calls.values():
        root, = _roots(group)
        assert root["name"] == f"engine.{collective}"
        assert root["args"]["bytes"] == x.nbytes
        assert root["args"]["algorithm"] and root["args"]["segments"] >= 1
        names = {e["name"] for e in group}
        assert {"engine.resolve", "engine.compile", "execute_program",
                "exchange"} <= names
        for e in group:
            if e["name"] == "exchange":
                assert e["args"]["path"] in ("in_place", "indexed", "codec",
                                             "gather")
                assert e["args"]["segments"] >= 1


def test_caches_miss_on_the_first_call_alone():
    eng = CollectiveEngine({"x": 8}, device="cpu")
    x = _input(8 * 1237)            # a size no other test indexes
    with profiled() as spans:
        for _ in range(3):
            eng.allreduce(x, "x")                       # the selector
            eng.allreduce(x, "x", algorithm="ring")     # the schedule cache
    roots = _roots(spans)
    assert len(roots) == 6
    first, later = roots[:2], roots[2:]
    assert first[0]["counters"]["region_index.miss"] > 0
    for r in later:
        c = r["counters"]
        assert c.get("region_index.miss", 0) == 0
        assert c["region_index.hit"] > 0
        assert c["compile.cache_hit"] == 1
    assert first[0]["counters"].get("selector.cache_hit", 0) == 0
    assert first[1]["counters"]["schedule.gen"] == 1
    for r in later[0::2]:
        assert r["counters"]["selector.cache_hit"] == 1
    for r in later[1::2]:
        assert r["counters"]["schedule.cache_hit"] == 1
    by_call = _calls(spans)
    misses = [[e["name"] for e in by_call[r["call"]]
               if e["name"] in ("selector.choose", "compile")]
              for r in roots]
    assert "selector.choose" in misses[0]
    assert all(m == [] for m in misses[2:])


def test_kernel_entries_count_the_calls_made(monkeypatch):
    made = {"n": 0}

    def counting(fn):
        def call(*a, **k):
            made["n"] += 1
            return fn(*a, **k)
        return call

    for name in ENTRY_POINTS:
        monkeypatch.setattr(kops, name, counting(getattr(kops, name)))
    server = _server()
    eng = CollectiveEngine({"x": 8}, device="cpu")
    x = _input(4096)
    with profiled() as spans:
        eng.allreduce(x, "x")
        server.serve(_ids(1))
    roots = _roots(spans)
    assert [r["name"] for r in roots] == ["engine.allreduce", "dlrm.serve"]
    entries = sum(r["counters"].get(telemetry.ENTRIES, 0) for r in roots)
    assert made["n"] > 0 and entries == made["n"]
    assert all(r["counters"].get(telemetry.ENTRY_NS, 0) > 0 for r in roots)
    # a span's entries are its children's and its own, never more
    by_id = {e["id"]: e for e in spans}
    for e in spans:
        if e["parent"] is not None:
            assert e["counters"].get(telemetry.ENTRIES, 0) <= \
                by_id[e["parent"]]["counters"].get(telemetry.ENTRIES, 0)


def test_k1_entry_counts_each_exchange_and_its_segments():
    """A traced 4-segment ring allreduce, every exchange written in place:
    each of its 7 combining exchanges is one K1 entry over all 4
    segments, so `kernel.entries` rises by 1 an exchange and
    `k1.segments` by 4; each of its 7 copy exchanges is one entry of the
    indexed copy."""
    eng = CollectiveEngine({"x": 8}, device="cpu")
    x = _input(8 * 4 * 64)
    with profiled() as spans:
        eng.allreduce(x, "x", algorithm="ring", segments=4)
    root, = _roots(spans)
    exchanges = [e for e in spans if e["name"] == "exchange"]
    assert len(exchanges) == 14
    combining = [e for e in exchanges
                 if e["counters"].get(telemetry.K1_SEGMENTS)]
    assert len(combining) == 7
    for e in exchanges:
        assert e["args"]["path"] == "in_place"
        assert e["args"]["segments"] == 4
        assert e["counters"][telemetry.ENTRIES] == 1
    for e in combining:
        assert e["counters"][telemetry.K1_SEGMENTS] == 4
    assert root["counters"][telemetry.ENTRIES] == 7 + 7
    assert root["counters"][telemetry.K1_SEGMENTS] == 7 * 4


def test_dlrm_spans_nest_a_batch():
    server = _server()
    with profiled() as spans:
        for s in range(2):
            server.serve(_ids(s))
    _check_nesting(spans)
    calls = _calls(spans)
    assert len(calls) == 2
    by_id = {e["id"]: e for e in spans}
    for group in calls.values():
        root, = _roots(group)
        assert root["name"] == "dlrm.serve" and root["args"]["batch"] == 8
        kids = [e["name"] for e in group if e["parent"] == root["id"]]
        assert kids == ["dlrm.ids_in", "dlrm.lookup", "dlrm.fc1", "dlrm.fc",
                        "dlrm.fc", "dlrm.unstack"]
        engines = [e for e in group if e["name"].startswith("engine.")
                   and e["name"] not in ("engine.resolve", "engine.compile")]
        assert {e["name"] for e in engines} == {
            "engine.allreduce", "engine.matmul_reduce_scatter",
            "engine.allgather"}
        for e in engines:
            assert by_id[e["parent"]]["name"].startswith("dlrm.")
        rings = [e for e in group if e["name"] == "exchange"
                 and e["args"]["path"] == "ring"]
        assert len(rings) == 3                 # 4 ranks: 3 ring steps


def test_nothing_recorded_without_profiler_or_tracer():
    server = _server()
    eng = CollectiveEngine({"x": 8}, device="cpu")
    before = (len(WALL.events()), dict(WALL.counters), WALL._ids)
    assert telemetry.current() is telemetry.NULL
    assert telemetry.wall() is telemetry.NULL
    eng.allreduce(_input(4096), "x")
    server.serve(_ids(0))
    assert (len(WALL.events()), dict(WALL.counters), WALL._ids) == before
    assert telemetry.LIVE is None


def test_results_bitwise_equal_traced_or_not():
    server = _server()
    eng = CollectiveEngine({"x": 8}, device="cpu")
    x = _input(8 * 1000, seed=5)
    ids = _ids(9)
    plain = (eng.allreduce(x, "x"), eng.reduce_scatter(x, "x"),
             eng.allreduce(x, "x", compression="int8"), server.serve(ids))
    with profiled() as spans:
        traced = (eng.allreduce(x, "x"), eng.reduce_scatter(x, "x"),
                  eng.allreduce(x, "x", compression="int8"),
                  server.serve(ids))
    assert spans
    assert any(e["args"].get("path") == "codec" for e in spans)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


def test_installed_tick_tracer_sees_what_it_saw():
    def tick_events(prof: bool):
        eng = CollectiveEngine({"x": 8}, device="cpu")
        ctx = profile(activities=[ProfilerActivity.CPU]) if prof \
            else contextlib.nullcontext()
        with ctx, telemetry.use(telemetry.Tracer()) as tr:
            assert telemetry.wall() is telemetry.NULL
            for _ in range(2):
                eng.allreduce(_input(8 * 999), "x")
        return [(e["type"], e["name"], e["ts"], e.get("dur"))
                for e in tr.events()]

    first = WALL._ids
    tick_events(False)          # the compile memo: warm on both sides
    off, on = tick_events(False), tick_events(True)
    assert off == on and off
    assert not any(n.startswith(("engine.", "dlrm.")) or n in (
        "execute_program", "exchange") for _t, n, _ts, _d in off)
    assert WALL._ids == first


def test_buffer_is_bounded_and_counts_drops():
    rec = telemetry.WallTracer(cap=4)
    for i in range(10):
        with rec.span(f"s{i}"):
            pass
    kept = rec.spans()
    assert [e["name"] for e in kept] == ["s6", "s7", "s8", "s9"]
    assert rec.dropped == 6
    assert [e["call"] for e in kept] == [7, 8, 9, 10]


def test_span_counters_instants_and_errors():
    rec = telemetry.WallTracer()
    with telemetry.use(rec):
        assert telemetry.wall() is rec
        with rec.span("root", track="t", a=1) as root:
            assert telemetry.LIVE is rec
            rec.count("x", 2)
            with pytest.raises(KeyError):
                with rec.span("child"):
                    rec.instant("hit")
                    raise KeyError("boom")
            root.add(b=2)
        assert telemetry.LIVE is None
    child, parent = rec.spans()
    assert child["parent"] == parent["id"] and parent["parent"] is None
    assert child["args"]["error"] == "KeyError"
    assert child["counters"] == {"hit": 1}
    assert parent["counters"] == {"x": 2, "hit": 1}
    assert parent["args"] == {"a": 1, "b": 2}
    assert rec.counters == {"x": 2, "hit": 1}
    (instant,) = [e for e in rec.events() if e["type"] == "instant"]
    assert instant["parent"] == child["id"] and instant["call"] == 1


def test_chrome_trace_has_a_wall_clock_group():
    rec = telemetry.WallTracer()
    with rec.span("root", track="engine"):
        rec.instant("mark", track="engine")
    rec.interval("drain", "queue:x", 0.0, 1e-6)
    ct = rec.to_chrome_trace()["traceEvents"]
    names = {(e["pid"], e["args"]["name"]) for e in ct if e["ph"] == "M"
             and e["name"] == "process_name"}
    assert (telemetry.WALL_PID, "wall clock (time.time_ns)") in names
    span, = [e for e in ct if e["ph"] == "X" and e["name"] == "root"]
    ev, = rec.spans()
    assert span["pid"] == telemetry.WALL_PID
    assert span["ts"] == pytest.approx(ev["ts"] / 1e3)
    assert span["dur"] == pytest.approx(ev["dur"] / 1e3)
    assert span["args"]["call"] == 1 and span["args"]["parent"] is None
    drain, = [e for e in ct if e["name"] == "drain"]
    assert drain["pid"] == telemetry.VIRTUAL_PID and drain["dur"] == 1.0
    tick = telemetry.Tracer()
    with tick.span("s"):
        pass
    pids = {e["pid"] for e in tick.to_chrome_trace()["traceEvents"]}
    assert telemetry.WALL_PID not in pids


def test_region_index_counts_only_under_a_span():
    rec = telemetry.WallTracer()
    key = ((0, 1), (((0, 4),), ((4, 4),)), 1, "cpu")
    engine_mod._INDEX_CACHE.pop(key, None)
    with telemetry.use(rec), rec.span("root"):
        engine_mod._region_index(*key)
        engine_mod._region_index(*key)
    engine_mod._region_index(*key)
    assert rec.counters == {"region_index.miss": 1, "region_index.hit": 1}


def test_lm_prefill_spans_nest_and_count_the_moe():
    """A traced prefill of a small Granite-4.0-H (layers mamba /
    attention): one `lm.prefill` root, an `lm.layer` a layer with its
    kind, the Mamba mixer's `ssm.proj` / `ssm.scan` / `ssm.norm` inside
    `ssm.mixer`, the MoE's steps with the alltoalls inside dispatch and
    combine and the counts' read (`moe.count_sync`) inside route; `moe.assignments` is tokens x top-k, `moe.dropped` 0."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.convert import stack_global
    from repro_torch.parallel import stages
    cfg = reduced_config(get_config("granite-4.0-h-small"))
    mesh = {"pod": 1, "data": 1, "model": 2}
    s = 16
    pf, ctx, _specs, bspec = stages.build_prefill(cfg, ParallelConfig(), mesh,
                                                  1, s, device="cpu")
    params = stages.init_params(cfg, mesh, 2, seed=1, device="cpu",
                                serve=True)
    tokens = torch.arange(s, dtype=torch.int32)[None]
    batch = {"tokens": stack_global(tokens, mesh, bspec["tokens"])}
    with profiled() as spans:
        traced = pf(params, batch)
    _check_nesting(spans)
    root, = _roots(spans)
    assert root["name"] == "lm.prefill"
    by_id = {e["id"]: e for e in spans}

    def parent(e):
        return by_id[e["parent"]]["name"]

    layers = [e for e in spans if e["name"] == "lm.layer"]
    assert [e["args"]["kind"] for e in layers] == ["mamba", "attention"]
    assert all(parent(e) == "lm.prefill" for e in layers)
    for name in ("ssm.proj", "ssm.scan", "ssm.norm"):
        hit, = [e for e in spans if e["name"] == name]
        assert parent(hit) == "ssm.mixer"
    for name in ("moe.route", "moe.dispatch", "moe.experts", "moe.combine",
                 "moe.shared"):
        assert [parent(e) for e in spans if e["name"] == name] == \
            ["lm.layer"] * 2
    # the per-expert counts' one read to the host a layer, a span of its own
    assert [parent(e) for e in spans if e["name"] == "moe.count_sync"] == \
        ["moe.route"] * 2
    a2a = [parent(e) for e in spans if e["name"] == "engine.alltoall"]
    assert a2a == ["moe.dispatch", "moe.combine"] * 2
    assert root["counters"]["moe.assignments"] == 2 * s * 2
    assert root["counters"].get("moe.dropped", 0) == 0  # no change: 0
    assert ctx.engine.metrics.get("moe.dropped") == 0
    assert root["counters"]["moe.slots"] >= 2 * s * 2
    # tracing changes no bit
    plain = pf(params, batch)
    for a, b in zip(traced[1], plain[1]):
        assert torch.equal(a, b)
    assert torch.equal(traced[0], plain[0])
