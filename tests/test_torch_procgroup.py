"""One rank per process (`repro_torch/core/procgroup.py`) against the
stacked executor, the stacked engine and the JAX engine.

One spawned world per world size n in {2, 3, 4} (`launch/procs.spawn`,
gloo, the CPU, a `file://` store): each child runs the cases of
`_torch_procs_cases.py` on its own rank's shard and saves its results;
the parent stacks them.
  * the executor's grid: every `GENERATORS` entry that accepts n, at
    segments 1 and 4, codec None and int8, on integer-valued and normal
    fp32, bf16 for the ring and bidi_ring allreduce, and a hierarchical
    allreduce on a (2, 2) product — each rank's result BITWISE the
    stacked `execute_program`'s row on the same program and input, and
    its K1/K2/K3 calls exactly what its share of the program implies
    (`procgroup.implied_launches`);
  * the engine (n = 4): one blocking collective of each kind and the
    (2, 2) two-axis allreduce, equal to the JAX engine under `shard_map`
    and BITWISE the stacked port engine, on integer-valued fp32;
  * the queue: phase 7b's mix drained BITWISE the blocking calls;
  * use case 1: `distributed_vecmat` over 4 processes equal to the
    stacked run, bitwise on integer inputs, within 1e-4 on normal ones;
  * the streaming ops on inputs that require grad: outputs and grads
    within 1e-5 of the stacked engine's;
  * the entry points: no card without device='cpu', a mismatched program
    raises, a child that raises fails the world, and the step context of
    every LM family builds on a process's engine.
"""
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import PartitionSpec as P

import _torch_procs_cases as C
from repro.core import CollectiveEngine as JaxEngine
from repro.core.topology import make_mesh
from repro_torch.core import CollectiveEngine
from repro_torch.core.engine import execute_program
from repro_torch.core.procgroup import implied_launches
from repro_torch.launch import distributed_vecmat as vm
from repro_torch.launch import procs

SIZES = (2, 3, 4)
GRID = [(n, key) for n in SIZES for key, *_ in C.grid(n)]
_WORLDS: dict = {}
_DIRS: dict = {}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """n -> the per-rank results of one spawned n-process world."""
    def get(n):
        if n not in _WORLDS:
            d = tmp_path_factory.mktemp(f"world{n}")
            procs.spawn(C.run, n, backend="gloo", device="cpu",
                        args=(str(d),))
            _DIRS[n] = d
            _WORLDS[n] = [torch.load(d / f"rank{r}.pt") for r in range(n)]
        return _WORLDS[n]
    return get


@pytest.mark.parametrize("n,key", GRID, ids=[f"n{n}-{k}" for n, k in GRID])
def test_executor_bitwise_stacked(worlds, n, key):
    res = worlds(n)
    _key, sched, segments, codec, inputs = next(
        c for c in C.grid(n) if c[0] == key)
    prog = C.program(sched, segments, codec)
    X = torch.from_numpy(np.stack(C.grid_inputs(key, sched, n, codec,
                                                inputs)))
    if codec == "bf16":
        X = X.bfloat16()
    want = execute_program(prog, X)
    for r in range(n):
        got, counts = res[r]["grid"][key]
        assert got.dtype == want.dtype and torch.equal(got, want[r]), \
            f"rank {r}"
        assert counts == implied_launches(prog, r, tuple(got.shape)), \
            f"rank {r}"


@pytest.mark.parametrize("n", SIZES)
def test_transport_posts_one_batch_per_exchange(worlds, n):
    """The grid moved real messages, unstaged on the CPU."""
    stats = [r["grid"]["transport"] for r in worlds(n)]
    for st in stats:
        assert st["exchanges"] > 0 and st["messages"] >= st["exchanges"]
        assert st["staged_bytes"] == 0 and st["staged_ms"] == 0.0


_JAX = {}


def _jax_run(shape, axes, call, X):
    """`call(engine, local)` on every device of the reference's mesh;
    results stacked by mesh position."""
    if (shape, axes) not in _JAX:
        _JAX[shape, axes] = make_mesh(shape, axes)
    mesh = _JAX[shape, axes]
    eng = JaxEngine(mesh, backend="microcode")
    lead = len(axes)
    idx = (0,) * lead
    g = jax.jit(jax.shard_map(lambda xs: call(eng, xs[idx])[(None,) * lead],
                              mesh=mesh, in_specs=P(*axes),
                              out_specs=P(*axes), check_vma=False))
    return np.asarray(g(jnp.asarray(X)))


_CALLS = [(name, call, local, {"x": 4})
          for name, call, local in C.ENGINE_CALLS] + \
    [(name, call, local, C.MESH2) for name, call, local in C.MESH2_CALLS]


@pytest.mark.parametrize("name,call,local,mesh", _CALLS,
                         ids=[c[0] for c in _CALLS])
def test_engine_matches_jax_and_stacked(worlds, name, call, local, mesh):
    from repro.core import plugins as jplugins
    from repro.core.schedule import Schedule as JSchedule
    from repro.core.schedule import Sel as JSel
    from repro.core.schedule import Step as JStep
    from repro_torch.core import plugins as tplugins
    from repro_torch.core.schedule import Schedule, Sel, Step
    res = worlds(4)
    lead = tuple(mesh.values())
    X = C.engine_input(name, lead, local)
    got = torch.stack([res[r][name] for r in range(4)]).reshape(
        lead + tuple(res[0][name].shape))
    jplugins.register_collective("shift_exchange",
                                 C.shift_generator(JSchedule, JStep, JSel),
                                 algorithm="ring_shift")
    tplugins.register_collective("shift_exchange",
                                 C.shift_generator(Schedule, Step, Sel),
                                 algorithm="ring_shift")
    try:
        ref = _jax_run(lead, tuple(mesh), call, X)
        stacked = call(CollectiveEngine(mesh, device="cpu"),
                       torch.from_numpy(X))
    finally:
        jplugins.unregister_collective("shift_exchange")
        tplugins.unregister_collective("shift_exchange")
    assert torch.equal(got, stacked)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_queue_drain_bitwise_blocking(worlds):
    """Phase 7b's mix drained one rank per process: bitwise the same
    calls blocking, and coalesced as the stacked queue coalesces."""
    res = worlds(4)
    for r in range(4):
        drained, blocking = res[r]["queue"], res[r]["queue_blocking"]
        assert len(drained) == len(blocking) == 6
        for i, (a, b) in enumerate(zip(drained, blocking)):
            assert torch.equal(a, b), f"rank {r} request {i}"
    q = C.queue_inputs(4)
    eng = CollectiveEngine({"x": 4}, device="cpu")
    reqs = C.issue_queue(eng, q, torch.from_numpy)
    eng.queue.drain()
    assert res[0]["queue_stats"] == dict(eng.queue.stats)
    assert res[0]["queue_stats"]["coalesced_buckets"] == 1
    for i, req in enumerate(reqs):
        if i == 4:                   # a reduce: defined at its root only
            assert torch.equal(res[2]["queue"][i], req.result[2])
            continue
        got = torch.stack([res[r]["queue"][i] for r in range(4)])
        assert torch.equal(got, req.result), f"request {i}"


@pytest.mark.parametrize("kind", ["int", "normal"])
def test_vecmat_four_processes(worlds, kind):
    y = worlds(4)[0][f"vecmat_{kind}"]
    x, w = C.vecmat_inputs(C.VECMAT_SIZE, kind)
    eng = CollectiveEngine({"x": 4}, device="cpu")
    want = vm.distributed_vecmat(
        eng, torch.from_numpy(x).reshape(4, -1),
        torch.from_numpy(w).reshape(4, -1, C.VECMAT_SIZE), C.TILES)
    assert y.shape == (C.VECMAT_SIZE,)
    if kind == "int":
        assert torch.equal(y, want)
        np.testing.assert_array_equal(y.numpy(), x @ w)
    else:
        np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=0,
                                   atol=1e-4)


def test_mismatched_program_raises(worlds):
    for r in range(4):
        assert "different programs" in worlds(4)[r]["mismatch"]


@pytest.mark.parametrize("i", range(len(C.GRAD_OPS)),
                         ids=[op for op, _ in C.GRAD_OPS])
def test_streaming_ops_differentiate_per_process(worlds, i):
    """`allgather_matmul`, `matmul_reduce_scatter` and `ring_attention`
    on inputs that require grad, one rank per process: outputs and grads
    within rtol = atol = 1e-5 of the stacked engine's on the same inputs
    and cotangents (a process's products are 2-D, the stacked engine's
    batched over the ranks: on the CPU they may sum in another order)."""
    op, shapes = C.GRAD_OPS[i]
    ins = C.grad_inputs(4, shapes, 20 + i)
    got = [worlds(4)[r]["grads"][op] for r in range(4)]
    cot = np.random.default_rng(30 + i).standard_normal(
        (4,) + tuple(got[0][0].shape)).astype(np.float32)
    want = C.grad_call(CollectiveEngine({"x": 4}, device="cpu"), op, ins,
                       cot)
    for j, w in enumerate(want):
        np.testing.assert_allclose(torch.stack([g[j] for g in got]).numpy(),
                                   w.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=str(j))


@pytest.mark.parametrize("arch", C.FAMILY_ARCHS)
def test_make_ctx_every_family_per_process(worlds, arch):
    """`stages.make_ctx` builds the step context of every LM family (the
    MoE, SSM, hybrid, audio and VLM ones as the dense one) on each
    process's `ProcessGroupEngine`: local shards (no mesh dims lead), TP
    2, and each process's TP rank its model coordinate."""
    from repro_torch.configs import get_config
    for r in range(4):
        got = worlds(4)[r]["families"][arch]
        assert got["family"] == get_config(arch).family
        assert got["engine"] == "ProcessGroupEngine"
        assert got["lead"] == 0 and got["local"] and got["tp"] == 2
        assert got["coords"] == {"pod": 0, "data": r // 2, "model": r % 2}
        assert got["tp_rank"] == got["coords"]["model"]


def test_engine_over_part_of_the_world(worlds):
    """A `ProcessGroupEngine` over global ranks (3, 1) of four, the others
    creating its groups alongside: mesh rank 0 is global rank 3, its
    allreduce and allgather take the members in mesh order (bitwise on
    integer values), and a checkpoint saved per process through the
    mesh's group is written by its rank 0 in mesh order."""
    from repro_torch.checkpoint import load_checkpoint
    w = worlds(4)
    got = {r: w[r]["subset"] for r in range(4)}
    assert got[0] is None and got[2] is None
    x3, x1 = C.subset_input(3), C.subset_input(1)
    for r, pos in zip(C.SUBSET, (0, 1)):
        assert got[r]["mesh_rank"] == pos and got[r]["coords"] == {"x": pos}
        assert torch.equal(got[r]["allreduce"], x3 + x1)
        assert torch.equal(got[r]["allgather"].reshape(-1),
                           torch.cat([x3, x1]))
    tree, _ = load_checkpoint(str(_DIRS[4] / "subset_ckpt"), 0,
                              {"w": torch.empty(12)})
    assert torch.equal(tree["w"], torch.cat([x3, x1]))


def test_engine_needs_the_card_by_default():
    """Without `device`, the per-process engine asks for CUDA and raises
    without it — before it looks for a process group."""
    code = ("import torch\n"
            "from repro_torch.core.procgroup import ProcessGroupEngine\n"
            "assert not torch.cuda.is_available()\n"
            "try:\n"
            "    ProcessGroupEngine({'x': 2})\n"
            "except RuntimeError as e:\n"
            "    assert 'CUDA' in str(e), e\n"
            "else:\n"
            "    raise SystemExit('no error')\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


@pytest.mark.parametrize("fn", ["fail_fast", "hang"])
def test_failed_child_fails_the_world(fn):
    """Rank 1 raises (`fail_fast`) or never sends (`hang`) while rank 0
    waits on it: the world fails within the group timeout, not later."""
    t0 = time.perf_counter()
    with pytest.raises(mp.ProcessRaisedException):
        procs.spawn(getattr(C, fn), 2, backend="gloo", device="cpu",
                    timeout_s=5)
    assert time.perf_counter() - t0 < 60
