"""Programs put in the place of the port's, for the checks that the
comparison deciding `correct` fails where it must: the control (the
plain reference computed in bfloat16, the precision below the float32
the configurations state) and the timed path broken in each way a cell
can be. Each is a program factory a driver takes as `program=
"fault_cases:<name>"`, with the driver's own factory's signature. Used by
`test_perfbench_drivers.py` and `control.py`, never by a benchmark run.
"""
from __future__ import annotations

import torch

import bench_harness as H

ar_ref = H.load_module("reference/allreduce.py")
dlrm_ref = H.load_module("reference/dlrm.py")


def _driver(name: str):
    return H.load_module(f"drivers/{name}.py")


# -- every rank stacked: (cfg, device) -> call(x) -------------------------

def allreduce_control(cfg, device):
    """The reference's sum in bfloat16 in the engine's place."""
    return ar_ref.lower_precision_sum


def allreduce_unchanged(cfg, device):
    """A call that returns its state unchanged: the input."""
    return lambda x: x


def allreduce_half(cfg, device):
    """Half of the ranks left out, the rest's sum scaled up in their
    place."""
    real = _driver("stacked_allreduce").engine_program(cfg, device)

    def call(x):
        h = x.clone()
        h[x.shape[0] // 2:] = 0
        return 2 * real(h)
    return call


def allreduce_altered(cfg, device):
    """One element of the result altered where it is produced."""
    real = _driver("stacked_allreduce").engine_program(cfg, device)

    def call(x):
        y = real(x).clone()
        y.view(-1)[0] += 1.0
        return y
    return call


# -- one rank per process: (cfg, device) -> call(local x) -----------------

def procs_unchanged(cfg, device):
    return lambda x: x


def procs_half(cfg, device):
    import torch.distributed as dist
    real = _driver("procs_allreduce").engine_program(cfg, device)
    left_out = dist.get_rank() >= dist.get_world_size() // 2

    def call(x):
        return 2 * real(torch.zeros_like(x) if left_out else x)
    call.counters = real.counters
    return call


def procs_no_exchange(cfg, device):
    """The exchange between processes left out: every send and receive
    of the transport dropped, receive buffers left as they were."""
    from repro_torch.core import procgroup
    procgroup.Transport.exchange = lambda self, sends, recvs: None
    return _driver("procs_allreduce").engine_program(cfg, device)


def procs_altered(cfg, device):
    import torch.distributed as dist
    real = _driver("procs_allreduce").engine_program(cfg, device)

    def call(x):
        y = real(x)
        if dist.get_rank() == 0:
            y = y.clone()
            y[0] += 1.0
        return y
    call.counters = real.counters
    return call


# -- the DLRM: (cfg, tables, fcs, device) -> serve(ids) -------------------

def dlrm_control(cfg, tables, fcs, device):
    """The reference in bfloat16 in the server's place, on the tables and
    the FC stack as the program is handed them."""
    def serve(ids):
        ids = torch.as_tensor(ids, device=tables.device)
        x = dlrm_ref.concat_sharded(tables, ids)
        return dlrm_ref.mlp(fcs, x, torch.bfloat16).float()
    return serve


def dlrm_unchanged(cfg, tables, fcs, device):
    """The server's state never advances: every batch gets the first
    batch's logits."""
    real = _driver("dlrm_serve").server_program(cfg, tables, fcs, device)
    first: list = []

    def serve(ids):
        if not first:
            first.append(real(ids))
        return first[0]
    return serve


def dlrm_half(cfg, tables, fcs, device):
    """Half of the batch left out: its logits are the mean of the rest's."""
    real = _driver("dlrm_serve").server_program(cfg, tables, fcs, device)

    def serve(ids):
        y = real(ids).clone()
        h = y.shape[0] // 2
        y[h:] = y[:h].mean(0)
        return y
    return serve


def dlrm_altered(cfg, tables, fcs, device):
    """One logit altered where it is produced, by 1% of the batch's
    largest."""
    real = _driver("dlrm_serve").server_program(cfg, tables, fcs, device)

    def serve(ids):
        y = real(ids).clone()
        y[0] += 1e-2 * y.abs().max()
        return y
    return serve


def procs_variants(rank: int, world: int, specs: list) -> None:
    """One world of processes running the procs driver's child once for
    each of `specs` in turn (a fault that patches the transport last)."""
    child = _driver("procs_allreduce").child
    for spec in specs:
        child(rank, world, spec)
