"""Driver `stacked_allreduce`: back-to-back `CollectiveEngine.allreduce`
calls with every rank stacked on one card.

A closed loop, one call in flight: each call takes the next input of a
pool made before the window (`params.inputs` of them, each rank's
`bytes_per_rank` standard normal fp32 drawn from the seed) and ends when
its result is on the card and the device is synchronised, as a blocking
ACCL+ call returns. The results of `params.checked_calls` calls drawn
from the seed, and of the first, are kept; once the window has closed
and the program is freed, every rank's copy of each is compared with
the float64 sum of the inputs, made again from the seed
(`reference/allreduce.py`).
"""
from __future__ import annotations

import time

import torch

import bench_harness as H
import bench_inputs as I
from bench_trace import Recorder, span_of

ref = H.load_module("reference/allreduce.py")


def control(cell) -> tuple:
    """(the cell, the program) of the control: the reference's sum in
    bfloat16 in the engine's place."""
    return cell, "fault_cases:allreduce_control"


def engine_program(cfg: dict, device):
    """The program: the engine's allreduce over the configuration's axis."""
    from repro_torch.core import CollectiveEngine
    eng = CollectiveEngine(dict(cfg["mesh"]), device=device)
    axis = cfg["axis"]
    return lambda x: eng.allreduce(x, axis)


def shape(cfg: dict) -> tuple:
    """(ranks, elements a rank) of one call."""
    return cfg["mesh"][cfg["axis"]], cfg["bytes_per_rank"] // 4


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        program=None) -> H.Run:
    cfg, p = cell.config, cell.params
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    ranks, elems = shape(cfg)
    marks = H.Marks(t0)
    H.card_ready(dev, marks)
    call = (H.resolve(program) or engine_program)(cfg, dev)
    marks.mark("program")
    pool = [I.allreduce_input(ranks, elems, seed, j, dev)
            for j in range(p["inputs"])]
    sync()
    marks.mark("inputs")
    for j in range(p["warmup_calls"]):
        tw = time.perf_counter()
        call(pool[j % len(pool)])
        sync()
    per_call = time.perf_counter() - tw
    keep = H.sample(seed, int(seconds / per_call), p["checked_calls"])
    kept: dict = {}
    rec = Recorder(dev) if trace else None
    span = span_of(rec)

    def step(i):
        with span("engine.allreduce"):
            y = call(pool[i % len(pool)])
        with span("synchronize"):
            sync()
        if i in keep:
            kept[i] = y

    marks.mark("warm-up")
    setup_s = time.time() - t0
    window_s, calls = H.closed_loop(step, seconds, rec,
                                    p["trace_calls"] if trace else 0)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    del call, pool
    if cuda:
        torch.cuda.empty_cache()
    gap = 0.0
    for i, y in sorted(kept.items()):
        x = I.allreduce_input(ranks, elems, seed, i % p["inputs"], dev)
        gap = max(gap, ref.gap(y, x))
    return H.Run(setup_s=setup_s, window_s=window_s,
                 done=[(None, 1)] * calls, attempted=calls, failed=0,
                 checks={"allreduce_gap": (gap,
                                           cell.limits["allreduce_gap"])},
                 memory_peak_bytes=peak, device_kind=kind, device_count=1,
                 trace=rec.trace if rec else None, setup_split=marks.split)
