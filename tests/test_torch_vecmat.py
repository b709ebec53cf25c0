"""Use case 1 (`repro_torch/launch/distributed_vecmat.py`) against the
JAX example's `dist` (`examples/distributed_vecmat.py`).

The same x and w, made from a seed with numpy, go through the example's
`dist` body — copied here, run under `shard_map` on the 8 host devices
with the JAX engine's queue — and through `distributed_vecmat` on the
port's engine on the CPU, ranks stacked: BITWISE equal on small
integer-valued inputs (every partial and every sum is exact in fp32),
within atol 1e-4 on normal ones, and within the example's 1e-2 of the
single-copy product. The queue model prices the example's request
pattern to the reference's numbers exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import CollectiveEngine as JaxEngine
from repro.core import Communicator as JaxComm
from repro.core.hw_spec import ACCL_CLUSTER as JAX_ACCL
from repro.core.topology import make_mesh
from repro_torch.core import CollectiveEngine
from repro_torch.launch import distributed_vecmat as vm

TILES = 4
_ENV = {}


def _env():
    if not _ENV:
        mesh = make_mesh((8,), ("x",))
        _ENV["e"] = (JaxEngine(mesh, backend="microcode"), mesh,
                     CollectiveEngine({"x": 8}, device="cpu"))
    return _ENV["e"]


def _jax_dist(engine, mesh, x, w):
    """The example's `dist` (examples/distributed_vecmat.py), as there."""
    size = w.shape[1]
    tile = size // TILES

    def dist(xs, ws):
        reqs = []
        for t in range(TILES):
            partial = xs @ ws[:, t * tile:(t + 1) * tile]
            reqs.append(engine.ireduce(partial, "x",
                                       algorithm="binomial_tree"))
        # materialize: FIFO drain of the outstanding tile reductions
        return jnp.concatenate([r.wait() for r in reqs])

    g = jax.jit(jax.shard_map(dist, mesh=mesh,
                              in_specs=(P("x"), P("x", None)),
                              out_specs=P(), check_vma=False))
    return np.asarray(g(jnp.asarray(x), jnp.asarray(w)))


def _port(engine, x, w):
    xs = torch.from_numpy(x).reshape(8, -1)
    ws = torch.from_numpy(w).reshape(8, -1, w.shape[1])
    return vm.distributed_vecmat(engine, xs, ws, TILES).numpy()


@pytest.mark.parametrize("size", [64, 256])
def test_vecmat_bitwise_on_integer_inputs(size):
    jeng, mesh, eng = _env()
    rng = np.random.default_rng(size)
    w = rng.integers(-8, 9, size=(size, size)).astype(np.float32)
    x = rng.integers(-8, 9, size=(size,)).astype(np.float32)
    got = _port(eng, x, w)
    ref = _jax_dist(jeng, mesh, x, w)
    assert got.shape == ref.shape == (size,)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, x @ w)


@pytest.mark.parametrize("size", [64, 256])
def test_vecmat_close_on_normal_inputs(size):
    jeng, mesh, eng = _env()
    rng = np.random.default_rng(100 + size)
    w = rng.normal(size=(size, size)).astype(np.float32)
    x = rng.normal(size=(size,)).astype(np.float32)
    got = _port(eng, x, w)
    np.testing.assert_allclose(got, _jax_dist(jeng, mesh, x, w), rtol=0,
                               atol=1e-4)
    err = np.abs(got.astype(np.float64) - x.astype(np.float64) @ w).max()
    assert err < 1e-2, err


def test_vecmat_runs_one_binomial_reduce_per_tile():
    """Each tile is one queued binomial-tree reduce, drained FIFO."""
    _jeng, _mesh, _ = _env()
    eng = CollectiveEngine({"x": 8}, device="cpu")
    x = np.ones((64,), np.float32)
    w = np.ones((64, 64), np.float32)
    _port(eng, x, w)
    assert eng.queue.stats["issued"] == eng.queue.stats["executed"] == TILES
    assert eng.queue.outstanding() == []
    assert [t[:2] for t in eng.trace_log] == \
        [("reduce", "binomial_tree")] * TILES


@pytest.mark.parametrize("size", [512, 4096])
def test_queue_model_equals_reference(size):
    """The CLI's model columns: the tile reductions' makespan and serial
    cost on ACCL_CLUSTER equal the reference's for the same queue, and
    the queue overlaps (t_queue < t_serial), as the example asserts."""
    jeng, _mesh, eng = _env()
    m = vm.queue_model(eng, size, TILES)
    comm = JaxComm(axis="x", size=8, hw=JAX_ACCL)
    seq = jeng.queue
    for _ in range(TILES):
        seq.issue("reduce", np.zeros((size // TILES,), np.float32), "x",
                  algorithm="binomial_tree")
    t_queue = seq.makespan("x", comm=comm)
    t_serial = seq.serial_cost("x", comm=comm)
    seq.clear()
    assert (m["t_queue_s"], m["t_serial_s"]) == (t_queue, t_serial)
    assert m["t_queue_s"] < m["t_serial_s"]
    assert eng.queue.outstanding() == []     # model-only: nothing queued


def test_cli_on_cpu(capsys):
    assert vm.main(["--device", "cpu", "--sizes", "64,128", "--reps",
                    "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == ("size,single_us,dist_us,measured_x,"
                        "model_blocking_x,model_offload_x,overlap_x")
    assert [ln.split(",")[0] for ln in lines[1:]] == ["64", "128"]


def test_cli_runs_on_the_card_unless_told_otherwise():
    """Without --device the CLI asks for the card: it raises on a machine
    without one (and builds its engine there on one that has it)."""
    if torch.cuda.is_available():
        assert vm.main(["--sizes", "64", "--reps", "1"]) == 0
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vm.main(["--sizes", "64"])
