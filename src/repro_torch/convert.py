"""Carry state across from the JAX package, as numpy.

A collective engine has no weights: its state is its inputs and its
tuning tables. This module moves both between the reference package's
forms and the port's, through numpy only (it imports no jax):

  * a global array as the reference shards it over a mesh (a numpy copy
    of the jax array, plus its PartitionSpec entries) <-> the port's
    MESH-STACKED tensor, whose leading dims are the mesh axes in mesh
    order and whose trailing dims are one device's local shard;
  * the reference `Selector.table_rows()` artifact <-> rows the port's
    `Selector.apply_table` takes (and its own `table_rows` emits).
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

_ROW_TYPES = {"collective": str, "msg_bytes": int, "nranks": int,
              "algorithm": str, "protocol": str, "segments": int,
              "compressed": bool, "predicted_s": float}


def _dim_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _blocks(global_shape, mesh_shape: dict, spec):
    """Yield (mesh coords, index of that device's shard in the global)."""
    spec = tuple(spec) + (None,) * (len(global_shape) - len(tuple(spec)))
    names = list(mesh_shape)
    for coords in itertools.product(*(range(s) for s in mesh_shape.values())):
        at = dict(zip(names, coords))
        index = []
        for dim, entry in zip(global_shape, spec):
            axes = _dim_axes(entry)
            parts, shard = 1, 0
            for a in axes:              # the first axis is the major one
                parts *= mesh_shape[a]
                shard = shard * mesh_shape[a] + at[a]
            if dim % parts:
                raise ValueError(f"dim {dim} does not split over {axes}")
            size = dim // parts
            index.append(slice(shard * size, (shard + 1) * size))
        yield coords, tuple(index)


def to_stacked(global_array, mesh_shape: dict, spec, device="cpu"):
    """A global array sharded by `spec` (PartitionSpec entries: an axis
    name, a tuple of names, or None per dim) -> the mesh-stacked tensor
    of every device's local shard."""
    g = np.asarray(global_array)
    lead = tuple(mesh_shape.values())
    out = None
    for coords, index in _blocks(g.shape, dict(mesh_shape), spec):
        local = g[index]
        if out is None:
            out = np.empty(lead + local.shape, dtype=g.dtype)
        out[coords] = local
    return torch.from_numpy(out).to(device)


def from_stacked(stacked, mesh_shape: dict, spec) -> np.ndarray:
    """Inverse of `to_stacked`: the global numpy array the mesh-stacked
    shards make up under `spec` (replicated dims take any one copy)."""
    s = stacked.detach().cpu()
    if s.dtype == torch.bfloat16:
        s = s.float()
    s = s.numpy()
    D = len(mesh_shape)
    local = s.shape[D:]
    spec = tuple(spec) + (None,) * (len(local) - len(tuple(spec)))
    gshape = []
    for dim, entry in zip(local, spec):
        parts = 1
        for a in _dim_axes(entry):
            parts *= mesh_shape[a]
        gshape.append(dim * parts)
    out = np.empty(tuple(gshape), dtype=s.dtype)
    for coords, index in _blocks(tuple(gshape), dict(mesh_shape), spec):
        out[index] = s[coords]
    return out


def table_rows(rows) -> list:
    """Reference `Selector.table_rows()` rows -> plain rows for the port's
    `Selector.apply_table` (numpy scalars become Python values; a row
    missing a field the table needs raises)."""
    out = []
    for r in rows:
        row = {}
        for key, typ in _ROW_TYPES.items():
            if key not in r:
                raise ValueError(f"table row {r} has no {key!r}")
            row[key] = typ(r[key])
        row["codec"] = None if r.get("codec") is None else str(r["codec"])
        out.append(row)
    return out
