"""Plain reference of the Table 2 DLRM's inference: one copy of the
tables and the FC stack on one device, plain PyTorch.

It imports nothing of the program and takes no tensor the program was
handed or made: `tables_of(t)` makes table t again from the seed, and
the FC stack and the ids are the benchmark's own. The concat vector is
each query's row of every table, in table order; the FC stack is
x @ w + b with ReLU between layers, in `dtype` (float64 for the
reference, bfloat16 for the control). TF32 is off: a float32 product in
TF32 would be a lower precision than the configuration states.
"""
from __future__ import annotations

import torch

BLOCK = 16384        # queries a block of the float64 FC stack


def concat(tables_of, ids, n_tables: int, dim: int):
    """ids (Q, n_tables) -> the concat vectors (Q, n_tables dim), float32:
    one table made at a time, its rows for every query gathered."""
    q = ids.shape[0]
    out = torch.empty((q, n_tables * dim), device=ids.device)
    for t in range(n_tables):
        tab = tables_of(t)
        out[:, t * dim:(t + 1) * dim] = tab[ids[:, t].long()]
        del tab
    return out


def mlp(fcs, x, dtype):
    """The FC stack in `dtype`: (Q, concat) -> (Q, out) float64."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ws = [(fc["w"].to(dtype), fc["b"].to(dtype)) for fc in fcs]
    outs = []
    for lo in range(0, x.shape[0], BLOCK):
        h = x[lo:lo + BLOCK].to(dtype)
        for i, (w, b) in enumerate(ws):
            h = h @ w + b
            if i < len(ws) - 1:
                h = torch.relu(h)
        outs.append(h.double())
    return torch.cat(outs)


def logits(tables_of, fcs, ids, n_tables: int, dim: int,
           dtype=torch.float64):
    """(Q, n_tables) ids -> (Q, out_dim) logits, float64."""
    return mlp(fcs, concat(tables_of, ids, n_tables, dim), dtype)


def gap(served, want) -> float:
    """The widest error of a served logit against the reference's, as a
    share of the reference logits' root mean square; inf where a served
    logit is not a number."""
    want = want.double()
    rms = float(want.pow(2).mean().sqrt())
    err = (served.double() - want).abs()
    if bool(err.isnan().any()):
        return float("inf")
    return float(err.max()) / max(rms, 1e-300)


def concat_sharded(tables, ids):
    """The concat vectors from tables laid out by shard, (tp, n_tables,
    rows / tp, dim): row r of table t is tables[r // (rows / tp), t,
    r % (rows / tp)]. (Q, n_tables) ids -> (Q, n_tables dim)."""
    rows_l = tables.shape[2]
    ids = ids.long()
    t = torch.arange(tables.shape[1], device=tables.device)
    return tables[ids // rows_l, t, ids % rows_l].reshape(ids.shape[0], -1)
