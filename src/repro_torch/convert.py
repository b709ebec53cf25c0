"""Carry state across from the JAX package, as numpy.

The engine's state is its inputs and its tuning tables; the DLRM's and
the LM's are their params (and the LM's caches). This module moves them
between the reference package's forms and the port's, through numpy
only (it imports no jax):

  * a global array as the reference shards it over a mesh (a numpy copy
    of the jax array, plus its PartitionSpec entries) <-> the port's
    MESH-STACKED tensor, whose leading dims are the mesh axes in mesh
    order and whose trailing dims are one device's local shard
    (`stack_global` and its inverse `unstack` do the same in torch, on
    the tensor's device);
  * the reference `dlrm_params` pytree <-> the port's stacked params;
  * the reference LM param tree (`parallel/stages.py::init_params`), its
    AdamW state (`optim/adamw.py`), its decode caches and its prefill
    caches <-> the port's (layer-stacked leaves lead with the layer dim,
    `models/blocks.py`);
  * the reference `Selector.table_rows()` artifact <-> rows the port's
    `Selector.apply_table` takes (and its own `table_rows` emits);
  * a mesh-stacked tensor (or params tree) -> the LOCAL shard of the one
    rank a process holds (`local_shard`, `local_params`: a layer-stacked
    leaf keeps its layer dim in front), the form a per-process model
    takes (`core/procgroup.py`);
  * a GLOBAL tensor -> one process's shard by its spec, with no stacked
    copy (`shard_of`: a batch, a checkpoint's leaf), and back through
    the process's engine (`gather_global`: every process of the mesh
    calls it and gets the global tensor).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.dlrm import dlrm_specs
from repro_torch.models.serve import prefill_cache_specs
from repro_torch.parallel.stages import cache_specs, dp_axes, param_specs

_LAYERED = ("layers", "enc_layers")     # param subtrees with a layer dim
_ROW_TYPES = {"collective": str, "msg_bytes": int, "nranks": int,
              "algorithm": str, "protocol": str, "segments": int,
              "compressed": bool, "predicted_s": float}


def _dim_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def stack_global(g, mesh_shape: dict, spec):
    """A global torch tensor sharded by `spec` (an axis name, a tuple of
    names or None per dim) -> the mesh-stacked tensor of every device's
    local shard, on g's device (the inverse of `unstack`; replicated
    axes hold copies)."""
    names = list(mesh_shape)
    spec = tuple(spec) + (None,) * (g.ndim - len(tuple(spec)))
    shape, where, local = [], {}, []
    for dim, entry in zip(g.shape, spec):
        axes = _dim_axes(entry)             # the first axis is the major one
        parts = int(np.prod([mesh_shape[a] for a in axes]))
        if dim % parts:
            raise ValueError(f"dim {dim} does not split over {axes}")
        for a in axes:
            where[a] = len(shape)
            shape.append(mesh_shape[a])
        local.append(len(shape))
        shape.append(dim // parts)
    t = g.reshape(shape)
    perm = []
    for a in names:
        if a not in where:                  # replicated: a new size-1 dim
            t = t.unsqueeze(-1)
            where[a] = t.ndim - 1
        perm.append(where[a])
    t = t.permute(perm + local)
    lead = tuple(mesh_shape.values())
    return t.expand(lead + tuple(t.shape[len(names):])).contiguous()


def to_stacked(global_array, mesh_shape: dict, spec, device="cpu"):
    """A global numpy array sharded by `spec` -> the mesh-stacked tensor
    of every device's local shard, on `device`."""
    g = torch.from_numpy(np.array(global_array)).to(device)
    return stack_global(g, dict(mesh_shape), spec)


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


def local_shard(stacked, mesh_shape: dict, coords: dict):
    """One rank's local shard of a mesh-stacked tensor: the rank at mesh
    position `coords` ({axis: index}; a view)."""
    return stacked[tuple(coords[a] for a in mesh_shape)]


def local_params(tree, mesh_shape: dict, coords: dict, _path=()):
    """One process's local shards of a mesh-stacked tree (dicts and lists:
    the DLRM's params, the LM's, or an AdamW state): a leaf under "layers"
    or "enc_layers", (L, *mesh, ...), gives (L, *local); a 0-d leaf (the
    optimizer's count) stays as it is; every other leaf gives its row at
    `coords` (`local_shard`). Copies, so the stacked tree can be freed."""
    if isinstance(tree, dict):
        return {k: local_params(v, mesh_shape, coords, _path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(local_params(v, mesh_shape, coords, _path + (i,))
                          for i, v in enumerate(tree))
    if tree.ndim == 0:
        return tree.clone()
    if any(k in _LAYERED for k in _path):
        return local_shard(tree.movedim(0, len(mesh_shape)), mesh_shape,
                           coords).clone()
    return local_shard(tree, mesh_shape, coords).clone()


def shard_of(g, mesh_shape: dict, spec, coords: dict):
    """One process's local shard of a GLOBAL tensor `g` sharded by `spec`,
    the process at mesh position `coords`: a narrow of every sharded dim
    (a view of g), equal to the row of `stack_global(g, ...)` at
    `coords` without making it."""
    spec = tuple(spec) + (None,) * (g.ndim - len(tuple(spec)))
    for d, entry in enumerate(spec):
        axes = _dim_axes(entry)             # the first axis is the major one
        parts = int(np.prod([mesh_shape[a] for a in axes]))
        if g.shape[d] % parts:
            raise ValueError(f"dim {g.shape[d]} does not split over {axes}")
        idx = 0
        for a in axes:
            idx = idx * mesh_shape[a] + coords[a]
        size = g.shape[d] // parts
        g = g.narrow(d, idx * size, size)
    return g


def gather_global(t, spec, engine):
    """The global tensor of one process's shard `t` under `spec`: one
    engine allgather per sharded axis and dim, the minor axis first. Every
    process of the engine's mesh calls it with its own shard; each gets
    the whole (the inverse of `shard_of`)."""
    mesh = engine.mesh_shape
    spec = tuple(spec) + (None,) * (t.ndim - len(tuple(spec)))
    for d, entry in enumerate(spec):
        for a in reversed(_dim_axes(entry)):
            if mesh[a] == 1:
                continue
            x = t.movedim(d, 0).contiguous()
            g = engine.allgather(x, a)
            t = g.reshape((mesh[a] * x.shape[0],)
                          + tuple(x.shape[1:])).movedim(0, d)
    return t


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


# --------------------------------------------------------------------------
# The LM: params and caches
# --------------------------------------------------------------------------

def _tree(fn, values, specs):
    """fn(leaf, spec) over a tree of dicts, lists and tuples (walked by
    its values, so a spec's tuple is never taken for a subtree)."""
    if isinstance(values, dict):
        return {k: _tree(fn, v, specs[k]) for k, v in values.items()}
    if isinstance(values, (list, tuple)):
        return type(values)(_tree(fn, v, s) for v, s in zip(values, specs))
    return fn(values, specs)


def _tree_to_stacked(values, specs, mesh_shape: dict, device,
                     layered: bool = False, coords=None):
    """Global numpy leaves -> mesh-stacked tensors; `layered` leaves
    (spec (None, ...)) keep their layer dim in front: (L, *mesh, ...).
    With `coords`, the local shards of the process there: (L, *local)."""
    D = len(mesh_shape)

    def put(g, spec):
        if coords is not None:
            return shard_of(torch.from_numpy(np.array(g)), mesh_shape, spec,
                            coords).contiguous().to(device)
        t = to_stacked(g, mesh_shape, spec, device)
        return t.movedim(D, 0).contiguous() if layered else t
    return _tree(put, values, specs)


def _tree_from_stacked(values, specs, mesh_shape: dict,
                       layered: bool = False):
    D = len(mesh_shape)

    def get(t, spec):
        return from_stacked(t.movedim(0, D) if layered else t, mesh_shape,
                            spec)
    return _tree(get, values, specs)


def lm_params_from_jax(params_np, cfg, mesh_shape: dict, serve: bool = False,
                       device="cpu", coords=None):
    """The reference LM param tree (numpy leaves, global arrays) -> the
    port's mesh-stacked params, in the FSDP layout or (serve=True) the
    serving layout; with `coords`, the local shards of the process at
    that mesh position (no stacked copy)."""
    specs = param_specs(cfg, mesh_shape.get("model", 1), serve=serve)
    return {k: _tree_to_stacked(v, specs[k], mesh_shape, device,
                                layered=k in _LAYERED, coords=coords)
            for k, v in params_np.items()}


def lm_params_to_jax(params, cfg, mesh_shape: dict, serve: bool = False):
    """Inverse of `lm_params_from_jax`: the reference tree as numpy."""
    specs = param_specs(cfg, mesh_shape.get("model", 1), serve=serve)
    return {k: _tree_from_stacked(v, specs[k], mesh_shape,
                                  layered=k in _LAYERED)
            for k, v in params.items()}


def _decode_specs(cfg, pcfg, mesh_shape: dict, batch: int, s_max: int,
                  s_enc: int):
    return cache_specs(cfg, pcfg, mesh_shape.get("model", 1), s_max,
                       s_enc=s_enc, dp=dp_axes(mesh_shape, batch))


def decode_caches_from_jax(caches_np, cfg, pcfg, mesh_shape: dict,
                           batch: int, s_max: int, s_enc: int = 0,
                           device="cpu"):
    """The reference decode caches (a list of per-layer dicts of global
    numpy arrays) -> the port's mesh-stacked caches."""
    return _tree_to_stacked(
        caches_np, _decode_specs(cfg, pcfg, mesh_shape, batch, s_max, s_enc),
        mesh_shape, device)


def decode_caches_to_jax(caches, cfg, pcfg, mesh_shape: dict, batch: int,
                         s_max: int, s_enc: int = 0):
    """Inverse of `decode_caches_from_jax`."""
    return _tree_from_stacked(
        caches, _decode_specs(cfg, pcfg, mesh_shape, batch, s_max, s_enc),
        mesh_shape)


def prefill_caches_to_jax(caches, cfg, pcfg, mesh_shape: dict, batch: int,
                          s: int):
    """The port's layer-stacked prefill caches -> the reference's global
    (L, B, S, ...) numpy arrays (`serve.prefill_cache_specs`)."""
    specs = prefill_cache_specs(cfg, pcfg, mesh_shape.get("model", 1), s,
                                dp=dp_axes(mesh_shape, batch))
    return _tree_from_stacked(caches, specs, mesh_shape, layered=True)


# --------------------------------------------------------------------------
# The optimizer state
# --------------------------------------------------------------------------

_OPT = ("master", "m", "v")


def _split_opt(leaves):
    """A state-leaf tree ({path: {"master", "m", "v"}}) -> one
    param-shaped tree per state name."""
    if isinstance(leaves, dict) and "master" in leaves:
        return {n: leaves[n] for n in _OPT}
    parts = {k: _split_opt(v) for k, v in leaves.items()}
    return {n: {k: parts[k][n] for k in parts} for n in _OPT}


def _join_opt(trees):
    """Inverse of `_split_opt`."""
    first = trees[_OPT[0]]
    if not isinstance(first, dict):
        return dict(trees)
    return {k: _join_opt({n: trees[n][k] for n in _OPT}) for k in first}


def opt_state_from_jax(state_np, cfg, mesh_shape: dict, device="cpu",
                       coords=None):
    """The reference AdamW state (`repro.optim.adamw_init`'s tree of
    global numpy arrays: {"leaves": {path: {"master", "m", "v"}},
    "count"}) -> the port's, each leaf mesh-stacked like its param (the
    FSDP layout), or with `coords` the local shards there."""
    split = _split_opt(state_np["leaves"])
    leaves = _join_opt({n: lm_params_from_jax(split[n], cfg, mesh_shape,
                                              device=device, coords=coords)
                        for n in _OPT})
    count = torch.tensor(int(np.asarray(state_np["count"])),
                         dtype=torch.int32, device=device)
    return {"leaves": leaves, "count": count}


def opt_state_to_jax(state, cfg, mesh_shape: dict):
    """Inverse of `opt_state_from_jax`: the reference state as numpy."""
    split = _split_opt(state["leaves"])
    leaves = _join_opt({n: lm_params_to_jax(split[n], cfg, mesh_shape)
                        for n in _OPT})
    return {"leaves": leaves,
            "count": np.asarray(int(state["count"]), np.int32)}
