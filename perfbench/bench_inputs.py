"""Every input of the benchmark, made from `--seed` on the device.

Each tensor has its own generator, seeded from the run's seed and the
tensor's place (`sub_seed`), so any one of them can be made again on its
own: the reference makes again what it compares against, and takes
nothing the program was handed or made. Every seed gets the same sizes;
only the values differ.
"""
from __future__ import annotations

import hashlib
import math

import torch


def sub_seed(seed: int, *parts) -> int:
    """A 63-bit seed for one tensor of the run with seed `seed`."""
    h = hashlib.sha256(repr((int(seed),) + parts).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(device, seed: int, *parts) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *parts))


def allreduce_row(elems: int, seed: int, j: int, rank: int, device):
    """Rank `rank`'s input of the `j`-th call of the pool: (elems,) fp32,
    standard normal."""
    g = generator(device, seed, "allreduce", j, rank)
    return torch.randn((elems,), generator=g, device=device)


def allreduce_input(ranks: int, elems: int, seed: int, j: int, device):
    """Every rank's input of the pool's `j`-th call, stacked: (ranks,
    elems)."""
    out = torch.empty((ranks, elems), device=device)
    for r in range(ranks):
        out[r] = allreduce_row(elems, seed, j, r, device)
    return out


def dlrm_table(cfg: dict, seed: int, t: int, device):
    """Table `t` whole: (rows_per_table, emb_dim) fp32, normal with the
    configuration's `table_std`."""
    g = generator(device, seed, "table", t)
    out = torch.empty((cfg["rows_per_table"], cfg["emb_dim"]), device=device)
    return out.normal_(0.0, cfg["init"]["table_std"], generator=g)


def dlrm_tables(cfg: dict, seed: int, tp: int, device):
    """All tables, laid out by shard: (tp, n_tables, rows / tp, emb_dim);
    shard m holds every table's rows [m rows / tp, (m + 1) rows / tp)."""
    rows, dim = cfg["rows_per_table"], cfg["emb_dim"]
    if rows % tp:
        raise ValueError(f"{rows} rows do not split over {tp} shards")
    out = torch.empty((tp, cfg["n_tables"], rows // tp, dim), device=device)
    for t in range(cfg["n_tables"]):
        out[:, t] = dlrm_table(cfg, seed, t, device).view(tp, rows // tp, dim)
    return out


def dlrm_fc(cfg: dict, seed: int, device) -> list:
    """The FC stack, global: layer i's weight (d_i, d_i+1), normal with
    std 1 / sqrt(d_i), and bias (d_i+1,), normal with `bias_std`."""
    dims = ((cfg["n_tables"] * cfg["emb_dim"],) + tuple(cfg["fc_dims"])
            + (cfg["out_dim"],))
    fcs = []
    for i, (k, n) in enumerate(zip(dims, dims[1:])):
        w = torch.empty((k, n), device=device).normal_(
            0.0, 1.0 / math.sqrt(k), generator=generator(device, seed, "w", i))
        b = torch.empty((n,), device=device).normal_(
            0.0, cfg["init"]["bias_std"],
            generator=generator(device, seed, "b", i))
        fcs.append({"w": w, "b": b})
    return fcs


def dlrm_ids(cfg: dict, seed: int, batch: int, pool: int, device):
    """The pool of request batches: (pool, batch, n_tables) int32 row ids,
    uniform over each table's rows."""
    g = generator(device, seed, "ids", batch, pool)
    return torch.randint(0, cfg["rows_per_table"],
                         (pool, batch, cfg["n_tables"]), generator=g,
                         device=device, dtype=torch.int32)
