"""The executor's region index, as the indexed kernels take it.

An index is `(unit, rows (1, ranks, 1), units (k, ranks, units/k))`, as
`core/engine.py::_region_index` builds it: segment j of rank r is the
`unit`-row units `units[j, r, :]` of stacked row `rows[0, r, 0]`. K1's
`fused_combine_at` and K2/K3's `quantize_blocks_at` /
`dequantize_blocks_at` check their indices here, each index object once
(the executor caches its indices and the path is host-bound).
`gather_regions` copies a region out and `scatter_regions` writes one
back: the executor's deferred gather and write and the plain versions'
(`ref.py`) are these two functions.
"""
from __future__ import annotations

import math

import torch

# id(index) -> (index, device): indices already checked. Holding the index
# keeps its id from being reused while the entry lives; bounded FIFO.
_CHECKED: dict = {}
_CHECKED_MAX = 4096


def check_index(who: str, name: str, index, device) -> None:
    """Raise unless `index` is a region index on `device`."""
    hit = _CHECKED.get(id(index))
    if hit is not None and hit[0] is index and hit[1] == device:
        return
    unit, ridx, uidx = index
    for idx in (ridx, uidx):
        if idx.device != device or idx.dtype != torch.int64 or \
                not idx.is_contiguous():
            raise ValueError(f"{who}: {name}'s index must be contiguous "
                             f"int64 on {device}, got {idx.dtype} on "
                             f"{idx.device}")
    if ridx.ndim != 3 or uidx.ndim != 3 or ridx.shape[0] != 1 or \
            ridx.shape[2] != 1 or uidx.shape[1] != ridx.shape[1] or \
            int(unit) < 1:
        raise ValueError(f"{who}: {name}'s index has shapes "
                         f"{tuple(ridx.shape)} and {tuple(uidx.shape)}, not "
                         f"(1, ranks, 1) and (k, ranks, units)")
    if len(_CHECKED) >= _CHECKED_MAX:
        _CHECKED.pop(next(iter(_CHECKED)))
    _CHECKED[id(index)] = (index, device)


def check_in_place(who: str, a, out_dtype, out) -> None:
    """Raise unless a combine may write back into its target `a`: the
    result keeps a's dtype and no `out` is given beside it."""
    if out is not None or out_dtype != a.dtype:
        raise ValueError(f"{who}: an in-place write takes no `out` and "
                         f"keeps a's dtype {a.dtype}, not {out_dtype}")


def row_and_unit(who: str, name: str, t, unit: int) -> tuple:
    """(elements per stacked row, elements per unit) of buffer `t`."""
    if t.ndim < 2 or t.shape[1] % unit:
        raise ValueError(f"{who}: {name} of shape {tuple(t.shape)} is not "
                         f"cut in units of {unit} rows")
    rest = math.prod(t.shape[2:])
    return t.shape[1] * rest, unit * rest


def gather_regions(t, index) -> torch.Tensor:
    """Every segment of a region of the rank-stacked buffer `t`, as a
    (k, ranks, seg) copy: segment j of rank r is the `unit`-row units
    `units[j, r, :]` of stacked row `rows[0, r, 0]`."""
    unit, ridx, uidx = index
    g = t.reshape(t.shape[0], t.shape[1] // unit, -1)[ridx, uidx]
    return g.reshape(g.shape[0], g.shape[1], -1)


def scatter_regions(t, index, val) -> None:
    """Write `val`, a (k, ranks, seg) tensor, into the region `index` of
    the rank-stacked buffer `t`: `gather_regions`' inverse."""
    unit, ridx, uidx = index
    view = t.reshape(t.shape[0], t.shape[1] // unit, -1)
    view.index_put_((ridx, uidx), val.reshape(uidx.shape + view.shape[2:]))
