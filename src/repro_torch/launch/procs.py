"""Processes for the per-process engine: the counterpart of the
reference's `jax.distributed.initialize()` (`repro/launch/train.py`).

Two ways to stand up a world of processes, one rank each, for
`core/procgroup.py::ProcessGroupEngine`:

  * `init_from_env()` joins a world that `torchrun` (or any launcher
    setting the same variables) started: RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR and MASTER_PORT.
  * `spawn(fn, nprocs, backend, device)` starts the world itself:
    `torch.multiprocessing` with the `spawn` start method, a `file://`
    store in a temporary directory (no TCP port, so concurrent worlds
    never collide), and `fn(rank, world, *args)` in every process. On
    the card the parent builds the kernel library first, so the
    children only load it. A child that raises makes `spawn` raise; a
    peer left waiting on it fails within the group timeout.

The group timeout is `TIMEOUT_S` seconds: a rank that dies turns its
peers' wait into an error rather than a hang.
"""
from __future__ import annotations

import datetime
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 120


def _timeout(seconds) -> datetime.timedelta:
    return datetime.timedelta(seconds=TIMEOUT_S if seconds is None
                              else seconds)


def _use_card(device, local: int) -> None:
    """Make card `local % device_count` this process's current device, the
    one `ProcessGroupEngine` defaults to: collectives on the group (the
    program fingerprint's all-gather on NCCL) and the kernels' launches
    go there."""
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        torch.cuda.set_device(local % torch.cuda.device_count())


def init_from_env(backend: str = "gloo", device: str = "cuda",
                  timeout_s=None) -> tuple:
    """Join the process group torchrun's environment describes, on card
    `LOCAL_RANK % device_count` unless `device` is 'cpu'; returns (rank,
    world size, local rank)."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    addr, port = os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"]
    _use_card(device, local)
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=rank, world_size=world,
                            timeout=_timeout(timeout_s))
    return rank, world, local


def _child(rank: int, fn, world: int, backend: str, device: str, init: str,
           timeout_s, args) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    _use_card(device, rank)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world, timeout=_timeout(timeout_s))
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs: int, backend: str = "gloo", device: str = "cuda",
          args: tuple = (), timeout_s=None) -> None:
    """Run `fn(rank, nprocs, *args)` in `nprocs` new processes joined in
    one `backend` process group; return when all have, raise if any
    raised. `fn` must be importable (a module-level function). With
    `device` 'cuda' the kernel library is built here first and process r
    runs on card `r % device_count`; without a card that raises before
    any process starts."""
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("procs.spawn: no CUDA device is available; "
                               "pass device='cpu' to run on the host")
        from repro_torch.kernels import _build
        _build.build()
    with tempfile.TemporaryDirectory(prefix="repro_torch_procs_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        mp.start_processes(_child, args=(fn, nprocs, backend, device, init,
                                         timeout_s, tuple(args)),
                           nprocs=nprocs, join=True, start_method="spawn")
