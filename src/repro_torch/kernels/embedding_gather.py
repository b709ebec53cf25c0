"""K5 wrappers: the embedding row gather as a CUDA kernel on Hopper.

Replaces the TPU kernel `repro/kernels/embedding_gather.py::gather_rows`
(Pallas, body `_kernel`, one row per grid step from scalar-prefetched
indices): `out[i] = table[idx[i]]`. One kernel template
(csrc/embedding_gather.cu) serves two entry points, each one launch for
every table of every stacked rank:

* `gather_rows`: rows of (G, V, D) tables at (G, B) indices the caller
  has clipped into [0, V), as the TPU kernel trusts them;
* `lookup_rows`: the DLRM lookup itself, global ids shifted by each
  rank's first row, misses zero, written straight into the (G, B, T*D)
  concat layout; a miss reads no table row.

Each group of threads keeps several rows in flight (ids, then row loads,
then stores) on a grid of the resident blocks, copies in 16-byte units
where the row length and pointers allow it, does not pad D, and uses
64-bit table offsets (the full DLRM table stack holds 1.28e10 elements).
It is memory-bound on the H100. Its plain versions are `ref.gather_rows`
and `ref.lookup_rows`; each pair agrees bitwise. Both entry points count
their launches on `gather_rows.launches`, K5's count.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_VEC_BYTES = (16, 8, 4, 2, 1)
_MAX_ROWS = 2**31 - 1     # output rows per launch (32-bit row numbers)


def _vec_bytes(row_bytes: int, *tensors) -> int:
    """The widest unit dividing the row and every base pointer."""
    return next(w for w in _VEC_BYTES if row_bytes % w == 0
                and all(t.data_ptr() % w == 0 for t in tensors))


def _check_rows(name: str, rows: int) -> None:
    if rows > _MAX_ROWS:
        raise ValueError(f"{name}: {rows} output rows exceed one launch's "
                         f"{_MAX_ROWS}")


def gather_rows(table, indices):
    """Launch K5 on CUDA tensors: (G, V, D) tables and (G, B) int32
    indices -> (G, B, D). Raises on anything it cannot take."""
    if table.device.type != "cuda" or indices.device != table.device:
        raise ValueError(f"gather_rows: needs CUDA tensors on one device, "
                         f"got {table.device} and {indices.device}")
    if indices.dtype != torch.int32:
        raise TypeError(f"gather_rows: indices must be int32, got "
                        f"{indices.dtype}")
    if table.ndim != 3 or indices.ndim != 2:
        raise ValueError(f"gather_rows: needs (G, V, D) tables with (G, B) "
                         f"indices, got {tuple(table.shape)} and "
                         f"{tuple(indices.shape)}")
    if not (table.is_contiguous() and indices.is_contiguous()):
        raise ValueError("gather_rows: operands must be contiguous")
    G, V, D = table.shape
    if indices.shape[0] != G:
        raise ValueError(f"gather_rows: {G} tables but indices for "
                         f"{indices.shape[0]}")
    B = indices.shape[1]
    _check_rows("gather_rows", G * B)
    out = torch.empty((G, B, D), dtype=table.dtype, device=table.device)
    row_bytes = D * table.element_size()
    if out.numel():
        if V == 0:
            raise ValueError("gather_rows: cannot gather from an empty table")
        rc = _build.library().k5_gather_rows(
            table.data_ptr(), indices.data_ptr(), out.data_ptr(), G, V, B,
            row_bytes, _vec_bytes(row_bytes, table, out),
            _build.stream_handle(table))
        gather_rows.launches += 1
        _build.check(rc, "gather_rows")
    return out


gather_rows.launches = 0


def lookup_rows(tables, ids, lo):
    """Launch K5 as the DLRM lookup on CUDA tensors: stacked tables (G, T,
    rows_l, D), global ids (G, B, T) int32 read through their own strides
    (a stride-0 expand is read in place), `lo` (G,) int64, each stacked
    rank's first row -> (G, B, T*D) with `out[g, b, t*D:(t+1)*D] =
    tables[g, t, ids[g, b, t] - lo[g]]` where that row is in [0, rows_l)
    (int32 arithmetic), else +0.0. Counted as a K5 launch. Raises on
    anything it cannot take."""
    if tables.device.type != "cuda" or ids.device != tables.device \
            or lo.device != tables.device:
        raise ValueError(f"lookup_rows: needs CUDA tensors on one device, "
                         f"got {tables.device}, {ids.device} and "
                         f"{lo.device}")
    if ids.dtype != torch.int32 or lo.dtype != torch.int64:
        raise TypeError(f"lookup_rows: needs int32 ids and int64 lo, got "
                        f"{ids.dtype} and {lo.dtype}")
    if tables.ndim != 4 or ids.ndim != 3 or lo.ndim != 1:
        raise ValueError(f"lookup_rows: needs (G, T, rows_l, D) tables, "
                         f"(G, B, T) ids and (G,) lo, got "
                         f"{tuple(tables.shape)}, {tuple(ids.shape)} and "
                         f"{tuple(lo.shape)}")
    G, T, rows_l, D = tables.shape
    B = ids.shape[1]
    if ids.shape[0] != G or ids.shape[2] != T or lo.shape[0] != G:
        raise ValueError(f"lookup_rows: {G} x {T} tables but ids "
                         f"{tuple(ids.shape)} and lo {tuple(lo.shape)}")
    if not (tables.is_contiguous() and lo.is_contiguous()):
        raise ValueError("lookup_rows: tables and lo must be contiguous")
    if rows_l > 2**31 - 1:
        raise ValueError(f"lookup_rows: {rows_l} rows per table exceed the "
                         f"int32 ids' range")
    _check_rows("lookup_rows", G * B * T)
    out = torch.empty((G, B, T * D), dtype=tables.dtype,
                      device=tables.device)
    row_bytes = D * tables.element_size()
    if out.numel():
        if rows_l == 0:
            raise ValueError("lookup_rows: cannot look up in empty tables")
        sg, sb, st = ids.stride()
        rc = _build.library().k5_lookup_rows(
            tables.data_ptr(), ids.data_ptr(), lo.data_ptr(), out.data_ptr(),
            G, T, rows_l, B, sg, sb, st, row_bytes,
            _vec_bytes(row_bytes, tables, out), _build.stream_handle(tables))
        gather_rows.launches += 1
        _build.check(rc, "lookup_rows")
    return out
