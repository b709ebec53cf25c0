"""The port's collective offload path against the JAX engine, end to end.

One numpy input per case, made from a seed, goes through the reference
`repro.core.CollectiveEngine` under `shard_map` on the 8 host devices and
through `repro_torch.core.CollectiveEngine(device="cpu")` with the ranks
stacked; the results must be equal BITWISE — every collective, algorithm
x segments {1, 4} x codec {None, int8}, fp32 and bf16, and the (2, 4)
two-axis allreduce. On the CPU the port runs its kernels' plain versions.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import CollectiveEngine as JaxEngine
from repro.core.topology import make_mesh
from repro_torch.core import CollectiveEngine

_ENVS = {}


def _env(shape, axes, backend="microcode"):
    key = (shape, axes, backend)
    if key not in _ENVS:
        mesh = make_mesh(shape, axes)
        _ENVS[key] = (JaxEngine(mesh, backend=backend), mesh,
                      CollectiveEngine(dict(zip(axes, shape)),
                                       backend=backend, device="cpu"))
    return _ENVS[key]


def _jax(mesh, axes, fn, X, dtype):
    """Run `fn(local)` on every device; rows stacked by mesh position."""
    lead = len(axes)
    idx = (0,) * lead
    spec = P(*axes)

    def body(xs):
        return fn(xs[idx])[(None,) * lead]

    g = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=spec,
                              out_specs=spec, check_vma=False))
    out = g(jnp.asarray(X).astype(dtype))
    return np.asarray(out.astype(jnp.float32))


def _both(call, X, dtype="float32", shape=(8,), axes=("x",),
          backend="microcode"):
    """(reference result, port result), both as float32 numpy."""
    jeng, mesh, teng = _env(shape, axes, backend)
    ref = _jax(mesh, axes, lambda v: call(jeng, v), X, dtype)
    xt = torch.from_numpy(np.array(X)).to(getattr(torch, dtype))
    out = call(teng, xt)
    return ref, out.float().numpy()


def _bitwise(ref, out):
    assert ref.shape == out.shape, (ref.shape, out.shape)
    assert np.array_equal(ref, out), \
        f"{int(np.sum(ref != out))} elements differ"


def _normal(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


ALLREDUCE = ["ring", "bidi_ring", "recursive_doubling", "halving_doubling",
             "auto"]


@pytest.mark.parametrize("codec", [None, "int8"])
@pytest.mark.parametrize("segments", [1, 4])
@pytest.mark.parametrize("algo", ALLREDUCE)
def test_allreduce_fp32(algo, segments, codec):
    # int8 cases use a flat local array: for a (2048, 3) one the reference's
    # compiler leaves the dequantize-add of recursive doubling's LAST step
    # uncontracted in column 2 only (two roundings there, one elsewhere);
    # the port contracts everywhere, as the reference does on flat arrays
    X = _normal((8, 2048, 3) if codec is None else (8, 6144), seed=1)
    _bitwise(*_both(lambda e, v: e.allreduce(
        v, "x", algorithm=algo, segments=segments, compression=codec), X))


@pytest.mark.parametrize("codec", [None, "int8"])
@pytest.mark.parametrize("segments", [1, 4])
@pytest.mark.parametrize("algo", ["ring", "bidi_ring", "halving_doubling"])
def test_allreduce_bf16(algo, segments, codec):
    X = _normal((8, 4096), seed=2)
    _bitwise(*_both(lambda e, v: e.allreduce(
        v, "x", algorithm=algo, segments=segments, compression=codec),
        X, dtype="bfloat16"))


@pytest.mark.parametrize("op", ["max", "min", "mul"])
def test_allreduce_ops(op):
    X = _normal((8, 1000), seed=3)
    _bitwise(*_both(lambda e, v: e.allreduce(
        v, "x", op=op, algorithm="ring", segments=4), X))


@pytest.mark.parametrize("codec", [None, "int8"])
@pytest.mark.parametrize("segments", [1, 4])
@pytest.mark.parametrize("algo", ["ring", "recursive_halving", "auto"])
def test_reduce_scatter(algo, segments, codec):
    X = _normal((8, 8192), seed=4)
    _bitwise(*_both(lambda e, v: e.reduce_scatter(
        v, "x", algorithm=algo, segments=segments, compression=codec), X))


@pytest.mark.parametrize("segments", [1, 4])
@pytest.mark.parametrize("algo", ["ring", "recursive_doubling", "auto"])
def test_allgather(algo, segments):
    X = _normal((8, 96), seed=5)
    _bitwise(*_both(lambda e, v: e.allgather(
        v, "x", algorithm=algo, segments=segments), X))


@pytest.mark.parametrize("segments", [1, 4])
@pytest.mark.parametrize("algo", ["one_to_all", "binomial_tree"])
def test_bcast(algo, segments):
    X = _normal((8, 96, 2), seed=6)
    _bitwise(*_both(lambda e, v: e.bcast(
        v, "x", root=3, algorithm=algo, segments=segments), X))


@pytest.mark.parametrize("algo", ["ring", "all_to_one", "binomial_tree"])
def test_reduce(algo):
    X = _normal((8, 100), seed=7)
    _bitwise(*_both(lambda e, v: e.reduce(
        v, "x", root=2, algorithm=algo), X))


@pytest.mark.parametrize("algo", ["ring", "all_to_one", "binomial_tree"])
def test_gather(algo):
    X = _normal((8, 24), seed=8)
    _bitwise(*_both(lambda e, v: e.gather(
        v, "x", root=5, algorithm=algo), X))


@pytest.mark.parametrize("segments", [1, 4])
@pytest.mark.parametrize("algo", ["linear", "bruck", "auto"])
def test_alltoall(algo, segments):
    X = _normal((8, 16, 5), seed=9)
    _bitwise(*_both(lambda e, v: e.alltoall(
        v, "x", algorithm=algo, segments=segments), X))


_MATMUL_JAX = {}


def _matmul_both(name, X, W, segments, use_pallas, inputs):
    """(reference, port) of a streaming matmul on the 8-rank ring: X and
    W stacked by rank; the reference under shard_map with its engine's
    `use_pallas` (K4 in interpret mode when on)."""
    key = (name, X.shape, W.shape, segments, use_pallas)
    if key not in _MATMUL_JAX:
        mesh = make_mesh((8,), ("x",))
        jeng = JaxEngine(mesh, use_pallas=use_pallas)

        def body(xs, ws):
            return getattr(jeng, name)(xs[0], ws[0], "x",
                                       segments=segments)[None]

        _MATMUL_JAX[key] = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(P("x"), P("x")), out_specs=P("x"),
            check_vma=False))
    ref = np.asarray(_MATMUL_JAX[key](jnp.asarray(X), jnp.asarray(W)))
    teng = CollectiveEngine({"x": 8}, device="cpu")
    out = getattr(teng, name)(torch.from_numpy(X), torch.from_numpy(W), "x",
                              segments=segments).numpy()
    if inputs == "int":
        _bitwise(ref, out)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    return teng


def _matmul_inputs(inputs, x_shape, w_shape, seed):
    if inputs == "int":
        rng = np.random.default_rng(seed)
        return (rng.integers(-4, 5, x_shape).astype(np.float32),
                rng.integers(-4, 5, w_shape).astype(np.float32))
    return _normal(x_shape, seed), _normal(w_shape, seed + 1)


@pytest.mark.parametrize("inputs", ["int", "normal"])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("segments", [1, 2, 4])
def test_allgather_matmul(segments, use_pallas, inputs):
    X, W = _matmul_inputs(inputs, (8, 8, 24), (8, 24, 16), seed=20)
    teng = _matmul_both("allgather_matmul", X, W, segments, use_pallas,
                        inputs)
    assert teng.trace_log[-1] == ("allgather_matmul", "ring", "x",
                                  8 * 24 * 4)


@pytest.mark.parametrize("inputs", ["int", "normal"])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("segments", [1, 2, 4])
def test_matmul_reduce_scatter(segments, use_pallas, inputs):
    X, W = _matmul_inputs(inputs, (8, 32, 12), (8, 12, 16), seed=21)
    teng = _matmul_both("matmul_reduce_scatter", X, W, segments, use_pallas,
                        inputs)
    assert teng.trace_log[-1] == ("matmul_reduce_scatter", "ring", "x",
                                  32 * 16 * 4)


def test_matmul_reduce_scatter_needs_divisible_rows():
    teng = CollectiveEngine({"x": 8}, device="cpu")
    with pytest.raises(ValueError, match="rows"):
        teng.matmul_reduce_scatter(torch.ones(8, 12, 4), torch.ones(8, 4, 2),
                                   "x")


def test_send_recv_and_barrier():
    X = _normal((8, 33), seed=10)
    _bitwise(*_both(lambda e, v: e.send_recv(v, "x", shift=3), X))
    _bitwise(*_both(lambda e, v: e.barrier("x"), X[:, :1]))


@pytest.mark.parametrize("coll", ["allreduce", "reduce_scatter", "allgather",
                                  "bcast", "alltoall"])
def test_native_backend(coll):
    X = np.round(_normal((8, 64), seed=11) * 8)   # exact sums in any order
    call = {
        "allreduce": lambda e, v: e.allreduce(v, "x"),
        "reduce_scatter": lambda e, v: e.reduce_scatter(v, "x"),
        "allgather": lambda e, v: e.allgather(v, "x"),
        "bcast": lambda e, v: e.bcast(v, "x", root=6),
        "alltoall": lambda e, v: e.alltoall(v, "x"),
    }[coll]
    _bitwise(*_both(call, X, backend="native"))


@pytest.mark.parametrize("codec", [None, "int8"])
@pytest.mark.parametrize("algo", ["auto", "hierarchical:ring+ring",
                                  "hierarchical:ring+recursive_doubling"])
def test_two_axis_allreduce(algo, codec):
    X = _normal((2, 4, 768), seed=12)
    _bitwise(*_both(lambda e, v: e.allreduce(
        v, ("pod", "data"), algorithm=algo, compression=codec), X,
        shape=(2, 4), axes=("pod", "data")))


@pytest.mark.parametrize("coll", ["reduce_scatter", "allgather", "bcast"])
def test_two_axis_collectives(coll):
    X = _normal((2, 4, 96), seed=13)
    call = {
        "reduce_scatter": lambda e, v: e.reduce_scatter(
            v, ("pod", "data"), algorithm="hierarchical:ring+ring"),
        "allgather": lambda e, v: e.allgather(
            v, ("pod", "data"), algorithm="hierarchical:ring+ring"),
        "bcast": lambda e, v: e.bcast(v, ("pod", "data"), root=0),
    }[coll]
    _bitwise(*_both(call, X, shape=(2, 4), axes=("pod", "data")))


def test_one_axis_of_two_axis_mesh():
    """A collective over one axis runs every group along the other."""
    X = _normal((2, 4, 64), seed=14)
    _bitwise(*_both(lambda e, v: e.allreduce(v, "data", algorithm="ring"),
                    X, shape=(2, 4), axes=("pod", "data")))
    _bitwise(*_both(lambda e, v: e.reduce_scatter(v, "pod"), X,
                    shape=(2, 4), axes=("pod", "data")))


def test_registered_collective():
    from repro.core import plugins as jplugins
    from repro.core.schedule import Schedule as JSchedule
    from repro.core.schedule import Sel as JSel
    from repro.core.schedule import Step as JStep
    from repro_torch.core import plugins as tplugins
    from repro_torch.core.schedule import Schedule, Sel, Step

    def make(S, St, Se):
        def gen(comm, op="add"):
            return S(name="shift_exchange", collective="shift_exchange",
                     nranks=comm.size,
                     steps=(St(perm=tuple(comm.ring_perm(1)), op=op,
                               send_sel=Se.all(), recv_sel=Se.all(),
                               bytes_frac=1.0, uniform=True),),
                     chunks=1, result="full", relay="original")
        return gen

    jplugins.register_collective("shift_exchange",
                                 make(JSchedule, JStep, JSel),
                                 algorithm="ring_shift")
    tplugins.register_collective("shift_exchange",
                                 make(Schedule, Step, Sel),
                                 algorithm="ring_shift")
    try:
        X = _normal((8, 16), seed=15)
        _bitwise(*_both(lambda e, v: e.collective("shift_exchange", v, "x"),
                        X))
    finally:
        jplugins.unregister_collective("shift_exchange")
        tplugins.unregister_collective("shift_exchange")


def test_trace_log_and_schedule_cache():
    eng = CollectiveEngine({"x": 8}, device="cpu")
    X = torch.from_numpy(_normal((8, 64), seed=16))
    eng.allreduce(X, "x", algorithm="ring")
    eng.allreduce(X, "x", algorithm="ring")
    assert eng.stats["gen_calls"] == 1
    assert eng.stats["sched_cache_hits"] == 1
    assert eng.trace_log[-1] == ("allreduce", "ring", "x", 64 * 4)


@pytest.mark.parametrize("coll,codec,copies", [
    ("reduce_scatter", None, 0), ("reduce_scatter", "int8", 0),
    ("allreduce", None, 7), ("allreduce", "int8", 7)])
def test_plain_combine_gathers_no_operand(monkeypatch, coll, codec, copies):
    """A combine reads its payload and target in place: an uncompressed
    one through K1's indexed entry point (one call per exchange), an int8
    one through the indexed K2 and K3 (one call each per exchange). A
    ring's copy exchanges (the allreduce's 7 allgather steps) are one
    indexed copy each, payload and target in place: nothing is gathered."""
    from repro_torch.core import engine as tengine
    from repro_torch.kernels import ops as tops
    seen = {"gather": 0, "at": 0, "quantize_at": 0, "dequantize_at": 0,
            "copy": 0}

    def count(name, fn):
        def wrapped(*a, **kw):
            seen[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tengine, "_gather", count("gather", tengine._gather))
    for name, attr in (("at", "fused_combine_at"),
                       ("quantize_at", "quantize_int8_at"),
                       ("dequantize_at", "dequantize_int8_at"),
                       ("copy", "region_copy")):
        monkeypatch.setattr(tops, attr, count(name, getattr(tops, attr)))
    X = torch.from_numpy(_normal((8, 2048), seed=17))
    eng = CollectiveEngine({"x": 8}, device="cpu")
    getattr(eng, coll)(X, "x", algorithm="ring", compression=codec)
    assert seen["gather"] == 0
    assert seen["copy"] == copies
    assert seen["at"] == (7 if codec is None else 0)
    assert seen["quantize_at"] == seen["dequantize_at"] == \
        (0 if codec is None else 7)


def test_engine_needs_the_card_by_default():
    """Without `device`, the engine asks for CUDA and raises without it."""
    code = ("import torch\n"
            "from repro_torch.core import CollectiveEngine\n"
            "assert not torch.cuda.is_available()\n"
            "try:\n"
            "    CollectiveEngine({'x': 8})\n"
            "except RuntimeError as e:\n"
            "    assert 'CUDA' in str(e)\n"
            "else:\n"
            "    raise SystemExit('no error')\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


@pytest.mark.parametrize("spec,gshape,local", [
    (("pod", "data"), (2 * 3, 4 * 5, 7), (3, 5, 7)),
    ((("pod", "data"),), (8 * 2, 3), (2, 3)),
    ((None, "data"), (3, 4 * 2), (3, 2)),
])
def test_convert_global_arrays(spec, gshape, local):
    """A JAX global array sharded by `spec` <-> the port's mesh-stacked
    tensor, and the same allreduce on both sides."""
    from repro_torch import convert
    jeng, mesh, teng = _env((2, 4), ("pod", "data"))
    G = _normal(gshape, seed=17)
    stacked = convert.to_stacked(G, teng.mesh_shape, spec)
    assert tuple(stacked.shape) == (2, 4) + local
    assert np.array_equal(
        convert.from_stacked(stacked, teng.mesh_shape, spec), G)
    g = jax.jit(jax.shard_map(
        lambda v: jeng.allreduce(v, ("pod", "data")), mesh=mesh,
        in_specs=P(*spec), out_specs=P(*spec), check_vma=False))
    ref = np.asarray(g(jnp.asarray(G)))
    out = convert.from_stacked(teng.allreduce(stacked, ("pod", "data")),
                               teng.mesh_shape, spec)
    assert np.array_equal(ref, out)


def test_convert_selector_table_rows():
    """The reference's tuning table pins the port's selector to the same
    choices, and an untuned port emits the same table."""
    from repro.core.selector import Selector as JSelector
    from repro.core.topology import Communicator as JComm
    from repro_torch import convert
    from repro_torch.core.selector import Selector
    from repro_torch.core.topology import Communicator
    jcomm, tcomm = JComm(axis="x", size=8), Communicator(axis="x", size=8)
    for codec in (None, "int8"):
        rows = JSelector().table_rows("allreduce", jcomm, codec=codec)
        assert Selector().table_rows("allreduce", tcomm, codec=codec) == rows
        tuned = Selector()
        tuned.set_tuning("allreduce", "ring", segments=2)   # overridden
        tuned.apply_table(convert.table_rows(rows))
        for r in rows:
            c = tuned.choose("allreduce", r["msg_bytes"], tcomm, codec=codec)
            assert (c.algorithm, c.segments) == (r["algorithm"],
                                                 r["segments"])
