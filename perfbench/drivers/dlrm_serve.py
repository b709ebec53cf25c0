"""Driver `dlrm_serve`: batches of requests through `DLRMServer.serve`,
the paper's use case 2, every rank stacked on one card.

The benchmark draws the tables (laid out by shard, one generator a
table) and the FC stack on the card from the seed and hands them to
`DLRMServer(params=...)` in the port's stacked layout; the tables are
not copied. The traffic (`params`): `batch` queries a batch, each query
one row id a table, uniform over the table's rows, from a pool of `pool`
batches drawn before the window and held in pinned host memory, where
requests arrive. A closed loop, one batch in flight: the next is issued
when the last one's logits are on the host. A batch's latency runs from
its issue to its logits on the host, timed by CUDA events on the card.

Every served batch's logits are kept. Once the window has closed and the
program and its tables are freed, the reference (`reference/dlrm.py`)
makes the tables, the FC stack and the ids again from the seed and
computes each pool batch's logits in float64; every served batch is
compared with them (`logit_gap`).
"""
from __future__ import annotations

import math
import time

import torch

import bench_harness as H
import bench_inputs as I
from bench_trace import Recorder, span_of

ref = H.load_module("reference/dlrm.py")


def control(cell) -> tuple:
    """(the cell, the program) of the control: the reference in bfloat16
    in the server's place."""
    return cell, "fault_cases:dlrm_control"


def server_program(cfg: dict, tables, fcs, device):
    """The program: `DLRMServer.serve`, given the benchmark's tables
    (tp, n_tables, rows / tp, dim) as a view and a copy of its FC stack,
    each laid out as the port stacks it over the mesh."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.configs.dlrm import DLRMConfig
    from repro_torch.convert import stack_global
    from repro_torch.launch.dlrm_serve import DLRMServer
    from repro_torch.models import dlrm as dlrm_mod
    mesh = dict(cfg["mesh"])
    names = list(mesh)
    if names[-1] != "model" or math.prod(mesh.values()) != mesh["model"]:
        raise ValueError(f"mesh {mesh}: only 'model' may exceed 1, last")
    dc = DLRMConfig(n_tables=cfg["n_tables"], emb_dim=cfg["emb_dim"],
                    rows_per_table=cfg["rows_per_table"],
                    fc_dims=tuple(cfg["fc_dims"]), out_dim=cfg["out_dim"])
    specs = dlrm_mod.dlrm_specs(dc, mesh["model"])
    lead = tuple(mesh.values())
    params = {"tables": tables.view(lead + tuple(tables.shape[1:])),
              "fc": [{k: stack_global(fc[k].clone(), mesh, sp[k])
                      for k in ("w", "b")}
                     for fc, sp in zip(fcs, specs["fc"])]}
    server = DLRMServer(dc, mesh_shape=mesh, device=device,
                        pcfg=ParallelConfig(
                            collective_matmul=cfg["collective_matmul"]),
                        params=params)
    return server.serve


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        program=None) -> H.Run:
    cfg, p = cell.config, cell.params
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    tp, B, P = cfg["mesh"]["model"], p["batch"], p["pool"]
    marks = H.Marks(t0)
    H.card_ready(dev, marks)
    tables = I.dlrm_tables(cfg, seed, tp, dev)
    fcs = I.dlrm_fc(cfg, seed, dev)
    ids = I.dlrm_ids(cfg, seed, B, P, dev).cpu()
    if cuda:
        ids = ids.pin_memory()
    marks.mark("inputs")
    serve = (H.resolve(program) or server_program)(cfg, tables, fcs, dev)
    marks.mark("program")
    for j in range(p["warmup_batches"]):
        serve(ids[j % P]).cpu()
    marks.mark("warm-up")
    served: list = []
    stamps: list = []
    rec = Recorder(dev) if trace else None
    span = span_of(rec)

    def step(i):
        e0 = _stamp(cuda)
        with span("DLRMServer.serve"):
            y = serve(ids[i % P])
        with span("logits to host"):
            served.append(y.cpu())
        stamps.append((e0, _stamp(cuda)))

    setup_s = time.time() - t0
    window_s, calls = H.closed_loop(step, seconds, rec,
                                    p["trace_batches"] if trace else 0,
                                    items=B)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    done = [(_elapsed_s(e0, e1), B) for e0, e1 in stamps]
    del serve, tables, fcs
    if cuda:
        torch.cuda.empty_cache()
    gap = _check(cfg, seed, B, P, served, dev)
    return H.Run(setup_s=setup_s, window_s=window_s, done=done,
                 attempted=calls * B, failed=0,
                 checks={"logit_gap": (gap, cell.limits["logit_gap"])},
                 memory_peak_bytes=peak, device_kind=kind, device_count=1,
                 trace=rec.trace if rec else None, setup_split=marks.split)


def _stamp(cuda: bool):
    if cuda:
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e
    return time.perf_counter()


def _elapsed_s(e0, e1) -> float:
    if isinstance(e0, float):
        return e1 - e0
    return e0.elapsed_time(e1) / 1e3


def _check(cfg: dict, seed: int, B: int, P: int, served: list, dev) -> float:
    """Every served batch's logits against the float64 reference of its
    pool batch."""
    if not served:
        return math.inf
    used = sorted({i % P for i in range(len(served))})
    ids = I.dlrm_ids(cfg, seed, B, P, dev)[used]
    want = ref.logits(lambda t: I.dlrm_table(cfg, seed, t, dev),
                      I.dlrm_fc(cfg, seed, dev),
                      ids.reshape(-1, cfg["n_tables"]), cfg["n_tables"],
                      cfg["emb_dim"]).reshape(len(used), B, -1)
    slot = {j: k for k, j in enumerate(used)}
    got = torch.stack(served).to(dev)
    wanted = want[torch.as_tensor([slot[i % P] for i in range(len(served))],
                                  device=dev)]
    return ref.gap(got, wanted)
