"""Carry state across from the JAX package, as numpy.

The engine's state is its inputs and its tuning tables; the DLRM's is
its params. This module moves them between the reference package's
forms and the port's, through numpy only (it imports no jax):

  * a global array as the reference shards it over a mesh (a numpy copy
    of the jax array, plus its PartitionSpec entries) <-> the port's
    MESH-STACKED tensor, whose leading dims are the mesh axes in mesh
    order and whose trailing dims are one device's local shard
    (`unstack` is the same inverse in torch, on the tensor's device);
  * the reference `dlrm_params` pytree <-> the port's stacked params;
  * the reference `Selector.table_rows()` artifact <-> rows the port's
    `Selector.apply_table` takes (and its own `table_rows` emits).
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from repro_torch.models.dlrm import dlrm_specs

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


def unstack(stacked, mesh_shape: dict, spec):
    """The global tensor the mesh-stacked shards make up under `spec`,
    on the shards' device (replicated dims take the first copy)."""
    names = list(mesh_shape)
    local_nd = stacked.ndim - len(names)
    spec = tuple(spec) + (None,) * (local_nd - len(tuple(spec)))
    used = [a for entry in spec for a in _dim_axes(entry)]
    t = stacked[tuple(slice(None) if a in used else 0 for a in names)]
    kept = [a for a in names if a in used]
    perm, shape = [], []
    for d, entry in enumerate(spec):
        axes = _dim_axes(entry)            # the first axis is the major one
        perm += [kept.index(a) for a in axes] + [len(kept) + d]
        shape.append(t.shape[len(kept) + d]
                     * int(np.prod([mesh_shape[a] for a in axes])))
    return t.permute(perm).reshape(shape)


def from_stacked(stacked, mesh_shape: dict, spec) -> np.ndarray:
    """Inverse of `to_stacked`: the global numpy array the mesh-stacked
    shards make up under `spec` (replicated dims take any one copy)."""
    g = unstack(stacked.detach(), mesh_shape, spec).cpu()
    return (g.float() if g.dtype == torch.bfloat16 else g).numpy()


def dlrm_params_from_jax(params_np, cfg, mesh_shape: dict, device="cpu"):
    """The reference `dlrm_params` pytree (numpy leaves: {"tables",
    "fc": [{"w", "b"}, ...]}) -> the port's mesh-stacked params."""
    specs = dlrm_specs(cfg, mesh_shape.get("model", 1))
    return {
        "tables": to_stacked(params_np["tables"], mesh_shape,
                             specs["tables"], device),
        "fc": [{k: to_stacked(fc[k], mesh_shape, sp[k], device)
                for k in ("w", "b")}
               for fc, sp in zip(params_np["fc"], specs["fc"])],
    }


def dlrm_params_to_jax(params, cfg, mesh_shape: dict):
    """Inverse of `dlrm_params_from_jax`: the reference pytree as numpy."""
    specs = dlrm_specs(cfg, mesh_shape.get("model", 1))
    return {
        "tables": from_stacked(params["tables"], mesh_shape,
                               specs["tables"]),
        "fc": [{k: from_stacked(fc[k], mesh_shape, sp[k])
                for k in ("w", "b")}
               for fc, sp in zip(params["fc"], specs["fc"])],
    }


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
