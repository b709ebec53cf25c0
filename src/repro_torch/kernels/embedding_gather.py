"""K5 wrapper: the embedding row gather as a CUDA kernel on Hopper.

Replaces the TPU kernel `repro/kernels/embedding_gather.py::gather_rows`
(Pallas, body `_kernel`, one row per grid step from scalar-prefetched
indices): `out[i] = table[idx[i]]`. The kernel
(csrc/embedding_gather.cu) is batched over stacked tables — every table
of every stacked rank in one launch — copies each row in 16-byte units
where the row length and pointers allow it, does not pad D, and uses
64-bit offsets throughout (the full DLRM table stack holds 1.28e10
elements). It is memory-bound on the H100. Like the TPU kernel it trusts
the caller to have clipped the indices into [0, V). Its plain version is
`ref.gather_rows`; the two agree bitwise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_VEC_BYTES = (16, 8, 4, 2, 1)


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
    out = torch.empty((G, B, D), dtype=table.dtype, device=table.device)
    row_bytes = D * table.element_size()
    if out.numel():
        if V == 0:
            raise ValueError("gather_rows: cannot gather from an empty table")
        vec = next(w for w in _VEC_BYTES if row_bytes % w == 0
                   and table.data_ptr() % w == 0 and out.data_ptr() % w == 0)
        lib = _build.library()
        rc = lib.k5_gather_rows(table.data_ptr(), indices.data_ptr(),
                                out.data_ptr(), G, V, B, row_bytes, vec,
                                _build.stream_handle(table))
        gather_rows.launches += 1
        _build.check(rc, "gather_rows")
    return out


gather_rows.launches = 0
