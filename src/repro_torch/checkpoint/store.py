"""Sharded, async, elastically-reshardable checkpointing.

Port of `repro/checkpoint/store.py`, in the reference's on-disk format
(one directory per step):
    step_000123/
      manifest.json     step, per-leaf {shape, dtype, spec}, extra
      <leaf-id>.npy     the full logical (global) array, named as the
                        reference names it (its pytree path, each key
                        stripped to [A-Za-z0-9], joined by '_')
      COMMIT            written last — a directory without it is garbage
                        (atomic-commit protocol; interrupted saves are
                        ignored by latest_step and GC'd)
so a checkpoint written by either package loads into the other. A
bfloat16 leaf is stored as the reference's numpy writes it (2-byte void
records, manifest dtype "bfloat16"), without needing a bfloat16 numpy
type.

The port's state is mesh-stacked (`convert.py`): with `mesh_shape` and
`specs`, a save unstacks every leaf to its global array (a layer-stacked
(L, *mesh, ...) leaf — a path through "layers" or "enc_layers" — keeps
its layer dim in front) and a load stacks it onto the TARGET mesh, so a
checkpoint restores onto any other mesh shape (elastic restart). 0-d
leaves (the optimizer's count) are not stacked.

Async: CheckpointManager.save(..., blocking=False) snapshots to host
numpy copies in the caller thread (the train step updates its buffers in
place afterwards) and writes the files on a background thread; `wait()`
joins before the next save or shutdown.

One rank per process (`per_process=True`, on an initialized
`torch.distributed` world laid out as `ProcessGroupEngine` lays it:
global rank g at mesh position `unravel_index(g, mesh sizes)`) the
tree holds this process's LOCAL shards. A save gathers every leaf to
its global array on the mesh's rank 0 (`dist.gather` of each shard's
bytes, in the caller's thread, every process of the mesh joining); that
process writes the same files and COMMIT, on the background thread as
before, and `wait()` ends in a barrier, so no process reports a step
(`latest_step`) before it is committed. The mesh is the whole world in
rank order by default, or that of a `ProcessGroupEngine` (`engine`: its
`members` over its `group`, as after an elastic shrink). A load
(`coords`) reads the global file and keeps this process's shard
(`convert.shard_of`). The format is unchanged: a
checkpoint written one rank per process loads stacked and into the
reference, and the other way round.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.tree import flatten, unflatten

_LAYERED = ("layers", "enc_layers")


def _name(path) -> str:
    return "_".join(re.sub(r"[^A-Za-z0-9]", "", str(k)) for k in path)


def _spec_to_json(spec):
    return [list(e) if isinstance(e, (tuple, list)) else e for e in spec]


def _to_host(leaf, spec, path, mesh_shape, copy: bool = True) -> tuple:
    """(numpy array as the file holds it, dtype name): the global array
    of a (stacked) leaf, a copy (`copy=False`: the leaf is already one)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if mesh_shape is not None and spec is not None and t.ndim:
            from repro_torch.convert import unstack
            if any(k in _LAYERED for k in path):
                t = t.movedim(0, len(mesh_shape))
            t = unstack(t, mesh_shape, spec)
        # a device tensor's .cpu() is already a copy; a host one is not
        copy = copy and t.device.type == "cpu"
        t = t.cpu().contiguous()
        if t.dtype == torch.bfloat16:
            arr = t.view(torch.int16).numpy().view("V2")
            return np.array(arr, copy=copy), "bfloat16"
        arr = np.array(t.numpy(), copy=copy)
        return arr, str(arr.dtype)
    arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def _from_file(arr, dtype: str):
    """A torch tensor of the stored array (bfloat16 records included)."""
    arr = np.ascontiguousarray(arr).reshape(arr.shape)   # 0-d stays 0-d
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _mesh(engine) -> tuple:
    """(group, global ranks in row-major mesh order) of `engine`'s mesh,
    or of the whole world in rank order."""
    if engine is None:
        return None, tuple(range(dist.get_world_size()))
    return engine.group, engine.members


def _gather_root(leaf, spec, mesh_shape, engine=None):
    """The global tensor of every process's local shard of a leaf, on
    the mesh's rank 0 (None elsewhere): each shard's bytes gathered on
    the mesh's group, put in row-major mesh order, stacked and
    unstacked."""
    from repro_torch.convert import unstack
    group, members = _mesh(engine)
    h = leaf.detach().cpu().contiguous()
    wire = h.reshape(-1).view(torch.uint8)
    root = dist.get_rank() == members[0]
    parts = [torch.empty_like(wire) for _ in members] if root else None
    dist.gather(wire, parts, dst=members[0], group=group)
    if not root:
        return None
    by_rank = dict(zip(sorted(members), parts))     # the group's rank order
    stacked = torch.stack([by_rank[g] for g in members]).view(
        h.dtype).reshape(tuple(mesh_shape.values()) + tuple(h.shape))
    return unstack(stacked, mesh_shape, spec)


def snapshot(tree, specs=None, mesh_shape=None,
             per_process: bool = False, engine=None):
    """{name: (path, host array, dtype name, spec)} of every leaf: the
    global arrays a save writes. `per_process`: the tree's leaves are
    this process's local shards, every process of the mesh (`engine`'s,
    default the world) calls this, and the mesh's rank 0 gets the
    snapshot (the others None)."""
    spec_of = dict(flatten(specs)) if specs is not None else {}
    out = {}
    for path, leaf in flatten(tree):
        spec = spec_of.get(path)
        if per_process and isinstance(leaf, torch.Tensor) and leaf.ndim:
            leaf = _gather_root(leaf, spec, mesh_shape, engine)
            if leaf is None:
                continue
            arr, dtype = _to_host(leaf, None, path, None, copy=False)
        else:
            arr, dtype = _to_host(leaf, spec, path,
                                  None if per_process else mesh_shape)
        out[_name(path)] = (path, arr, dtype, spec)
    if per_process and dist.get_rank() != _mesh(engine)[1][0]:
        return None
    return out


def save_checkpoint(directory: str, step: int, tree, specs=None,
                    extra: Optional[dict] = None, mesh_shape=None,
                    per_process: bool = False, engine=None):
    """Synchronous save with atomic commit. `tree` is a tree of dicts of
    tensors or arrays; with `mesh_shape` and `specs`, its tensors are
    mesh-stacked (with `per_process`, every process's local shards) and
    saved as their global arrays (on `engine`'s mesh, default the
    world)."""
    snap = snapshot(tree, specs, mesh_shape, per_process, engine)
    d = None if snap is None else _write(directory, step, snap, extra)
    if per_process:
        dist.barrier(group=_mesh(engine)[0])
    return d


def _write(directory: str, step: int, snap: dict, extra: Optional[dict]):
    """Write a `snapshot` as the step's directory, COMMIT last."""
    d = os.path.join(directory, f"step_{step:09d}")
    tmp = d + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for name, (_path, arr, dtype, spec) in snap.items():
        np.save(os.path.join(tmp, name + ".npy"), arr)
        entry = {"shape": list(arr.shape), "dtype": dtype}
        if spec is not None:
            entry["spec"] = _spec_to_json(spec)
        manifest["leaves"][name] = entry
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write("ok")
    if os.path.exists(d):
        shutil.rmtree(d)
    os.rename(tmp, d)
    return d


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, "COMMIT")):
            best = max(best or -1, int(m.group(1)))
    return best


def load_checkpoint(directory: str, step: int, tree_like, specs=None,
                    mesh_shape=None, device="cpu", coords=None):
    """Restore into the structure of `tree_like` (its leaves are only
    read for their paths and whether they are 0-d): with `mesh_shape` and
    `specs`, every leaf stacked onto that mesh on `device` (with
    `coords`, the local shard of the process at that mesh position);
    else the global tensors. Returns (tree, manifest)."""
    d = os.path.join(directory, f"step_{step:09d}")
    if not os.path.exists(os.path.join(d, "COMMIT")):
        raise FileNotFoundError(f"no committed checkpoint at {d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    spec_of = dict(flatten(specs)) if specs is not None else {}
    names = {_name(path): (path, leaf) for path, leaf in flatten(tree_like)}
    out = []
    for name, entry in manifest["leaves"].items():
        if name not in names:
            raise KeyError(f"checkpoint leaf {name} missing in target tree")
        path, leaf = names[name]
        # one process maps the file and reads its own slice alone
        t = _from_file(np.load(os.path.join(d, name + ".npy"),
                               mmap_mode="c" if coords is not None else None),
                       entry["dtype"])
        if coords is not None:
            if spec_of and t.ndim:
                from repro_torch.convert import shard_of
                t = shard_of(t, mesh_shape, spec_of[path], coords)
            t = t.to(device, copy=True, memory_format=torch.contiguous_format)
        else:
            t = t.to(device)
            if mesh_shape is not None and spec_of and t.ndim:
                from repro_torch.convert import stack_global
                t = stack_global(t, mesh_shape, spec_of[path])
                if any(k in _LAYERED for k in path):
                    t = t.movedim(len(mesh_shape), 0).contiguous()
        out.append((path, t))
    if len(out) != len(names):
        missing = sorted(set(names) - set(manifest["leaves"]))
        raise KeyError(f"target leaves {missing} missing in checkpoint")
    return unflatten(out), manifest


class CheckpointManager:
    """Async keep-K manager with atomic commits and exact resume.
    `per_process`: every process of the mesh (`engine`'s, default the
    world; an elastic shrink sets it anew) holds one, saves and waits at
    the same steps; the mesh's rank 0 writes."""

    def __init__(self, directory: str, keep: int = 3,
                 per_process: bool = False, engine=None):
        self.directory = directory
        self.keep = keep
        self.per_process = per_process
        self.engine = engine
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending = False

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending:
            # rank 0 has committed: now every process may see the step
            self._pending = False
            dist.barrier(group=_mesh(self.engine)[0])
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree, specs=None, extra=None,
             blocking: bool = False, mesh_shape=None):
        self.wait()
        # snapshot to host in the caller thread (the step updates its
        # buffers in place afterwards); one rank per process every
        # process joins the gather, and rank 0 alone gets the snapshot
        snap = snapshot(tree, specs, mesh_shape, self.per_process,
                        self.engine)
        self._pending = self.per_process
        if snap is None:
            if blocking:
                self.wait()
            return

        def work():
            try:
                _write(self.directory, step, snap, extra)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        if blocking:
            work()
            self.wait()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def restore_latest(self, tree_like, specs=None, mesh_shape=None,
                       device="cpu", coords=None):
        step = latest_step(self.directory)
        if step is None:
            return None
        tree, manifest = load_checkpoint(self.directory, step, tree_like,
                                         specs, mesh_shape, device, coords)
        return step, tree, manifest

    def _gc(self):
        steps = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                committed = os.path.exists(
                    os.path.join(self.directory, name, "COMMIT"))
                if not committed and not name.endswith(".tmp"):
                    shutil.rmtree(os.path.join(self.directory, name),
                                  ignore_errors=True)
                    continue
                steps.append(int(m.group(1)))
        for s in sorted(steps)[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)
