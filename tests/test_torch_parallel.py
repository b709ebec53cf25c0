"""The port's `ParCtx` (sharded linear algebra through the engine)
against the reference's, on the (pod, data, model) = (1, 2, 4) mesh.

Each rank's local array is made from a seed with numpy (integer values,
so every sum is exact) and goes through `repro.parallel.ops.ParCtx`
under `shard_map` and through `repro_torch.parallel.ParCtx` with the
ranks stacked on the CPU; the results must be equal BITWISE.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import ParallelConfig as JParallelConfig
from repro.core.engine import CollectiveEngine as JaxEngine
from repro.core.topology import make_mesh
from repro.parallel.ops import ParCtx as JParCtx
from repro_torch.configs import ParallelConfig
from repro_torch.core import CollectiveEngine
from repro_torch.parallel import ParCtx

AXES = ("pod", "data", "model")
SHAPE = (1, 2, 4)


def _ints(local, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-4, 5, SHAPE + tuple(local)).astype(np.float32)


def _both(fn, arrays, **pcfg):
    """(reference, port) of `fn(ctx, *locals)` on every rank, stacked."""
    mesh = make_mesh(SHAPE, AXES)
    jctx = JParCtx(engine=JaxEngine(mesh), mesh=mesh,
                   pcfg=JParallelConfig(**pcfg))
    spec = P(*AXES)

    def body(*xs):
        return fn(jctx, *(x[0, 0, 0] for x in xs))[None, None, None]

    g = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec,) * len(arrays),
                              out_specs=spec, check_vma=False))
    ref = np.asarray(g(*map(jnp.asarray, arrays)))
    tctx = ParCtx(engine=CollectiveEngine(dict(zip(AXES, SHAPE)),
                                          device="cpu"),
                  pcfg=ParallelConfig(**pcfg))
    out = fn(tctx, *map(torch.from_numpy, arrays)).numpy()
    assert ref.shape == out.shape, (ref.shape, out.shape)
    assert np.array_equal(ref, out)
    return out


@pytest.mark.parametrize("dim", [0, 1, -1])
def test_gather_fsdp(dim):
    _both(lambda c, w: c.gather_fsdp(w, dim), [_ints((4, 6), 0)])


@pytest.mark.parametrize("sp", [False, True])
def test_row_parallel_finish(sp):
    _both(lambda c, y: c.row_parallel_finish(y, seq_dim=1),
          [_ints((2, 8, 5), 1)], sequence_parallel=sp)


def test_sp_allgather_seq():
    out = _both(lambda c, x: c.sp_allgather_seq(x, seq_dim=1),
                [_ints((2, 3, 5), 2)], sequence_parallel=True)
    assert out.shape == SHAPE + (2, 12, 5)


def test_dense():
    _both(lambda c, x, w: c.dense(x, w), [_ints((2, 3, 6), 3),
                                          _ints((3, 5), 4)])


@pytest.mark.parametrize("cm", [False, True])
def test_col_parallel_matmul(cm):
    out = _both(lambda c, x, w: c.col_parallel_matmul(x, w, seq_dim=1),
                [_ints((2, 3, 6), 5), _ints((3, 5), 6)],
                sequence_parallel=True, collective_matmul=cm)
    assert out.shape == SHAPE + (2, 12, 5)


def test_tp_rank_and_slice():
    ctx = ParCtx(engine=CollectiveEngine(dict(zip(AXES, SHAPE)),
                                         device="cpu"),
                 pcfg=ParallelConfig())
    assert ctx.tp == 4 and ctx.fsdp == 2 and ctx.tp_axis == "model"
    assert ctx.tp_rank().shape == (1, 1, 4)
    x = torch.arange(4 * 8, dtype=torch.float32).reshape(4, 8)
    x = x.expand(SHAPE + (4, 8))
    sl = ctx.tp_slice(x, 2, dim=-1)
    assert sl.shape == SHAPE + (4, 2)
    for r in range(4):
        assert torch.equal(sl[0, 1, r], x[0, 1, r, :, 2 * r:2 * r + 2])
