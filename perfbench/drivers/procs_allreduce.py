"""Driver `procs_allreduce`: back-to-back `ProcessGroupEngine.allreduce`
calls, one rank per process and card.

`launch/procs.py::spawn` starts `processes` processes on one `backend`
group (its store under TMPDIR); process r runs on card r. Each makes
its own inputs from the seed (a pool of `params.inputs`, `bytes_per_rank`
of standard normal fp32 each); no tensor passes between processes but
through the program. A closed loop, one call in flight: a call ends when
the result is on the process's card and synchronised; after each call
rank 0 tells every process, over a group of the harness's own, whether
the window has closed. Rank 0's window over its completed calls is the
call time. Each process keeps the results of `params.checked_calls`
calls drawn from the seed, and of the first; once the window has closed
and the program is freed it makes every rank's inputs of those calls
again and compares its result with their float64 sum
(`reference/allreduce.py`). The processes write what they measured to a
directory under TMPDIR, which the harness reads and removes.
"""
from __future__ import annotations

import json
import os
import pathlib
import sys
import tempfile
import time

import torch

import bench_harness as H
import bench_inputs as I
from bench_trace import Recorder, span_of

ref = H.load_module("reference/allreduce.py")


def control(cell) -> tuple:
    """(the cell, the program) of the control: the reference's sum in
    bfloat16 computes no collective, so it runs on one card through the
    stacked driver."""
    return (H.Cell(cell.name, dict(cell.workload, driver="stacked_allreduce"),
                   cell.config), "fault_cases:allreduce_control")


def engine_program(cfg: dict, device):
    """The program: this process's `ProcessGroupEngine.allreduce`; the
    transport's counters as `counters`."""
    from repro_torch.core.procgroup import ProcessGroupEngine
    eng = ProcessGroupEngine(dict(cfg["mesh"]), device=device)
    axis = cfg["axis"]

    def call(x):
        return eng.allreduce(x, axis)

    call.counters = eng.transport_stats
    return call


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        program=None) -> H.Run:
    from repro_torch.launch import procs
    with tempfile.TemporaryDirectory(prefix="perfbench_") as out:
        spec = child_spec(cell, seed, seconds, trace, device, out, program)
        spec["t0"] = t0
        procs.spawn(H.child_entry, cell.config["processes"],
                    backend=cell.config["backend"],
                    device=spec["device_type"],
                    args=("drivers/procs_allreduce.py", "child", spec))
        return collect(cell, out, trace, t0)


def child_spec(cell, seed: int, seconds: float, trace: bool, device,
               out: str, program=None) -> dict:
    """What each process is told: the cell, the run and where to write."""
    return {"config": cell.config, "params": cell.params, "seed": seed,
            "seconds": seconds, "trace": trace, "out": out,
            "program": program, "device_type": torch.device(device).type,
            "t0": time.time()}


def collect(cell, out: str, trace: bool, t0: float) -> H.Run:
    """The run from what every process wrote to `out`: rank 0's window,
    calls and trace (every card's busy time), the worst gap of any rank,
    the fullest card's peak."""
    world = cell.config["processes"]
    res = [json.loads(pathlib.Path(out, f"rank{r}.json").read_text())
           for r in range(world)]
    r0 = res[0]
    trace_obj = None
    if trace and r0["trace"] is not None:
        from bench_trace import Trace
        trace_obj = Trace(**r0["trace"])
        trace_obj.busy_ranks_s = [Trace(**r["trace"]).busy_s for r in res]
    return H.Run(setup_s=r0["window_start"] - t0, window_s=r0["window_s"],
                 done=[(None, 1)] * r0["calls"], attempted=r0["calls"],
                 failed=0,
                 checks={"allreduce_gap": (max(r["gap"] for r in res),
                                           cell.limits["allreduce_gap"])},
                 memory_peak_bytes=max(r["peak"] for r in res),
                 device_kind=r0["kind"], device_count=world,
                 trace=trace_obj, setup_split=r0["setup_split"])


def child(rank: int, world: int, spec: dict) -> None:
    import torch.distributed as dist
    cfg, p, seed = spec["config"], spec["params"], spec["seed"]
    cuda = spec["device_type"] == "cuda"
    dev = torch.device(f"cuda:{torch.cuda.current_device()}" if cuda
                       else "cpu")

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    elems = cfg["bytes_per_rank"] // 4
    if cuda:        # each process on a core of its own card's share
        print(f"perfbench: rank {rank} {H.steady_host(dev.index)}",
              file=sys.stderr, flush=True)
    marks = H.Marks(spec["t0"])
    H.card_ready(dev, marks)          # here: spawn, imports, the group
    call = (H.resolve(spec["program"]) or engine_program)(cfg, dev)
    counters = getattr(call, "counters", None)
    flag_group = dist.new_group(backend="gloo")
    flag = torch.zeros(1, dtype=torch.int32)
    marks.mark("program")
    pool = [I.allreduce_row(elems, seed, j, rank, dev)
            for j in range(p["inputs"])]
    sync()
    marks.mark("inputs")
    for j in range(p["warmup_calls"]):
        tw = time.perf_counter()
        call(pool[j % len(pool)])
        sync()
    per = torch.tensor([time.perf_counter() - tw], dtype=torch.float64)
    dist.broadcast(per, 0, group=flag_group)     # one sample on every rank
    keep = H.sample(seed, int(spec["seconds"] / float(per)),
                    p["checked_calls"])
    kept: dict = {}
    rec = Recorder(dev) if spec["trace"] else None
    span = span_of(rec)
    trace_calls = p["trace_calls"] if spec["trace"] else 0
    if rec is not None:
        rec.start(counters)            # before the clock: CUPTI starts slowly
    dist.barrier(group=flag_group)
    marks.mark("warm-up")
    window_start = time.time()
    t0 = time.perf_counter()
    i = 0
    while True:
        with span("ProcessGroupEngine.allreduce"):
            y = call(pool[i % len(pool)])
        with span("synchronize"):
            sync()
        if i in keep:
            kept[i] = y
        i += 1
        if rec is not None and rec.active and i == trace_calls:
            rec.stop(i, i, counters)
        with span("window flag"):
            if rank == 0:
                flag[0] = int(time.perf_counter() - t0 >= spec["seconds"])
            dist.broadcast(flag, 0, group=flag_group)
        if flag[0]:
            break
    if rec is not None and rec.active:
        rec.stop(i, i, counters)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    del call, pool
    if cuda:
        torch.cuda.empty_cache()
    gap = 0.0
    for k, y in sorted(kept.items()):
        x = torch.stack([I.allreduce_row(elems, seed, k % p["inputs"], r,
                                         dev) for r in range(world)])
        gap = max(gap, ref.gap(y, x))
    t = rec.trace if rec is not None else None
    out = {"rank": rank, "window_start": window_start, "window_s": window_s,
           "calls": i, "gap": gap, "peak": peak, "kind": kind,
           "setup_split": marks.split,
           "trace": None if t is None else {
               "window_s": t.window_s, "calls": t.calls, "items": t.items,
               "t0_ns": t.t0_ns, "t1_ns": t.t1_ns,
               "ops": t.ops if rank == 0 else [
                   ("busy", a, b - a) for a, b in t.intervals()],
               "spans": t.spans if rank == 0 else [],
               "counters": t.counters}}
    path = pathlib.Path(spec["out"], f"rank{rank}.json")
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_text(json.dumps(out))
    os.replace(tmp, path)
