"""One rank per process, continued: the per-process engine's native
backend, streaming matmuls and `ring_attention`, `ParCtx` and the DLRM
on local shards, against the stacked port and the JAX package.

One spawned world of 4 processes (`launch/procs.spawn`, gloo, the CPU)
runs `_torch_streams_cases.py::run`; the parent stacks each rank's
results and holds them:
  * the native backend (`torch.distributed`'s collectives): on
    integer-valued fp32 BITWISE the stacked native engine and equal to
    the JAX engine's native backend under `shard_map`; on normal values
    the sums within (n - 1) u sum|x| of the exact float64 sum (gloo adds
    in its own order), everything else bitwise;
  * `allgather_matmul` and `matmul_reduce_scatter` at segments 1 and 2:
    BITWISE the stacked engine, equal to the JAX engine on integer
    values and within 1e-5 on normal ones, K4 called n x segments and
    once per call on each rank;
  * `ring_attention`, causal and full, segments 1 and 2: fp32 within
    rtol = atol = 1e-5 of the JAX engine, bf16 by
    `test_torch_ring_attention._check`'s rule;
  * the reduced DLRM on (1, 1, 4) (and (1, 2, 2)) with params carried
    from the JAX init through `convert.local_params`: BITWISE the JAX
    `dlrm_forward` with params in {-1, 0, 1}, within 1e-5 of it and
    BITWISE the stacked port with normal ones, one K5 and (under
    collective_matmul) one K4 call per batch on each rank; params drawn
    per process from a seed, against the reference gathered outside
    the engine;
  * a mismatched ring call raises (their grads one rank per process:
    `test_torch_procgroup.py::test_streaming_ops_differentiate_per_process`
    and `test_torch_procgroup_lm.py`).
Without a spawn: `ParCtx`'s local mode against the stacked mode's rows,
the per-process `Builder`, `convert.local_shard`, the batch helpers.
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

import _torch_streams_cases as C
import test_torch_dlrm as TD
import test_torch_ring_attention as RA
from repro.core import CollectiveEngine as JaxEngine
from repro.core.topology import make_mesh
from repro_torch import convert
from repro_torch.configs import ParallelConfig, reduced
from repro_torch.configs.dlrm import DLRMConfig
from repro_torch.core import CollectiveEngine
from repro_torch.launch import procs
from repro_torch.models import dlrm
from repro_torch.models.common import Builder
from repro_torch.parallel import ParCtx

U32 = 2.0 ** -24
_WORLD: dict = {}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The per-rank results of one spawned 4-process world."""
    if not _WORLD:
        d = tmp_path_factory.mktemp("streams")
        params = {(kind, m): TD._params_np(kind, mesh["model"])
                  for _k, m, kind, _cm, _be in C.DLRM_CASES
                  for mesh in [C.DLRM_MESHES[m]]}
        torch.save(params, d / "params.pt")
        procs.spawn(C.run, C.N, backend="gloo", device="cpu", args=(str(d),))
        _WORLD["params"] = params
        _WORLD["ranks"] = [torch.load(d / f"rank{r}.pt", weights_only=False)
                           for r in range(C.N)]
    return _WORLD


def _stacked(world, part, key, lead):
    got = [world["ranks"][r][part][key] for r in range(C.N)]
    return torch.stack(got).reshape(lead + tuple(got[0].shape))


_JAX_MESHES: dict = {}


def _jax_mesh(shape, axes):
    if (shape, axes) not in _JAX_MESHES:
        _JAX_MESHES[shape, axes] = make_mesh(shape, axes)
    return _JAX_MESHES[shape, axes]


def _jax_run(mesh_shape, call, X, backend="microcode", *more):
    """`call(engine, *locals)` on every device of the reference's mesh,
    results stacked by mesh position."""
    axes = tuple(mesh_shape)
    mesh = _jax_mesh(tuple(mesh_shape.values()), axes)
    eng = JaxEngine(mesh, backend=backend)
    lead = len(axes)
    idx = (0,) * lead
    g = jax.jit(jax.shard_map(
        lambda *xs: call(eng, *(x[idx] for x in xs))[(None,) * lead],
        mesh=mesh, in_specs=(P(*axes),) * (1 + len(more)),
        out_specs=P(*axes), check_vma=False))
    return np.asarray(g(jnp.asarray(X), *map(jnp.asarray, more)))


# -- the native backend ------------------------------------------------------

_NATIVE = [(name, call, local, C.MESH1, kind)
           for name, call, local in C.NATIVE_CALLS for kind in C.KINDS] + \
    [(name, call, local, C.MESH2, kind)
     for name, call, local in C.NATIVE_MESH2_CALLS for kind in C.KINDS]


@pytest.mark.parametrize("name,call,local,mesh,kind", _NATIVE,
                         ids=[f"{c[0]}-{c[4]}" for c in _NATIVE])
def test_native_backend(world, name, call, local, mesh, kind):
    lead = tuple(mesh.values())
    X = C.native_input(name, lead, local, kind)
    got = _stacked(world, "native", (name, kind), lead)
    stacked = call(CollectiveEngine(mesh, backend="native", device="cpu"),
                   torch.from_numpy(X))
    assert got.shape == stacked.shape and got.dtype == stacked.dtype
    if kind == "int" or name not in C.NATIVE_SUMS:
        assert torch.equal(got, stacked)
    if kind == "int":
        ref = _jax_run(mesh, call, X, "native")
        np.testing.assert_array_equal(got.numpy(), ref)
        return
    if name in C.NATIVE_SUMS:
        # gloo's order of sums: within (n - 1) u sum|x| of the exact sum
        exact = call(CollectiveEngine(mesh, backend="native", device="cpu"),
                     torch.from_numpy(X).double())
        mag = call(CollectiveEngine(mesh, backend="native", device="cpu"),
                   torch.from_numpy(np.abs(X)).double())
        n = int(np.prod(lead))
        assert bool(((got.double() - exact).abs()
                     <= (n - 1) * U32 * mag).all())


def test_native_backend_runs_no_program(world):
    """The native calls compiled nothing and moved their bytes through
    `Transport.collective`."""
    for r in range(C.N):
        res = world["ranks"][r]["native"]
        assert res["programs"] == 0
        assert res["stats"]["collectives"] > 0
        assert res["stats"]["exchanges"] == 0


# -- the streaming matmuls ---------------------------------------------------

@pytest.mark.parametrize("key,op,seg,kind,xs,ws", C.STREAM_CASES,
                         ids=[c[0] for c in C.STREAM_CASES])
def test_streaming_matmul(world, key, op, seg, kind, xs, ws):
    X, W = C.stream_inputs(key, xs, ws, kind)
    got = torch.stack([world["ranks"][r]["streams"][key][0]
                       for r in range(C.N)])
    teng = CollectiveEngine(C.MESH1, device="cpu")
    stacked = getattr(teng, op)(torch.from_numpy(X), torch.from_numpy(W),
                                "x", segments=seg)
    assert torch.equal(got, stacked)
    ref = _jax_run(C.MESH1, lambda e, x, w: getattr(e, op)(
        x, w, "x", segments=seg), X, "microcode", W)
    if kind == "int":
        np.testing.assert_array_equal(got.numpy(), ref)
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    want_k4 = C.N * seg if op == "allgather_matmul" else 1
    for r in range(C.N):
        _y, k4, log = world["ranks"][r]["streams"][key]
        assert k4 == want_k4
        assert log == teng.trace_log[-1]


# -- ring attention ----------------------------------------------------------

@pytest.mark.parametrize("key,dtype,causal,seg", C.RING_CASES,
                         ids=[c[0] for c in C.RING_CASES])
def test_ring_attention(world, key, dtype, causal, seg):
    qkv = [np.array(torch.from_numpy(t).to(getattr(torch, dtype)).float())
           for t in C.ring_inputs()]
    kw = dict(causal=causal, segments=seg)
    want, want_log = RA._reference((C.N,), ("x",), "x", qkv, dtype, **kw)
    res = [world["ranks"][r]["streams"]["ring", key] for r in range(C.N)]
    got = torch.cat([y for y, _log in res], dim=1)
    assert got.dtype == getattr(torch, dtype)
    RA._check(got.float().numpy(), want, dtype, qkv, causal)
    for _y, log in res:
        assert [log] == want_log


def test_mismatched_ring_call_raises(world):
    for r in range(C.N):
        assert "different allgather_matmul calls" in \
            world["ranks"][r]["streams"]["mismatch"]


# -- the DLRM one rank per process ------------------------------------------

CFG = reduced()


@pytest.mark.parametrize("key,m,kind,cm,backend", C.DLRM_CASES,
                         ids=[c[0] for c in C.DLRM_CASES])
def test_dlrm_per_process(world, key, m, kind, cm, backend):
    mesh = C.DLRM_MESHES[m]
    shape = tuple(mesh.values())
    params_np = world["params"][kind, m]
    idx = C.dlrm_requests(CFG.rows_per_table, CFG.n_tables)
    res = [world["ranks"][r]["dlrm"][key] for r in range(C.N)]
    got = res[0]["logits"]
    for r in res[1:]:
        assert torch.equal(r["logits"], got)
    # the stacked port on the same params
    ctx = ParCtx(engine=CollectiveEngine(mesh, backend=backend,
                                         device="cpu"),
                 pcfg=ParallelConfig(collective_matmul=cm, backend=backend))
    params = convert.dlrm_params_from_jax(params_np, CFG, mesh)
    stacked = dlrm.unstack_batch(dlrm.DLRM(params, ctx)(
        dlrm.stack_batch(torch.from_numpy(idx), mesh)), mesh)
    want = np.asarray(TD._jax_fn(shape, "forward", collective_matmul=cm)(
        params_np, jnp.asarray(idx)))
    if kind == "int" or backend == "microcode":
        assert torch.equal(got, stacked)
    if kind == "int":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the concat vector: bitwise the reference's lookup, each rank's own
    # slots direct indexing of its own table slice
    vec = np.asarray(TD._jax_fn(shape, "lookup")(params_np,
                                                 jnp.asarray(idx)))
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["lookup"].numpy(), vec)
        np.testing.assert_array_equal(out["assembled"].numpy(), vec)
        coords = dict(zip(mesh, np.unravel_index(r, shape)))
        lo = coords["model"] * (CFG.rows_per_table // mesh["model"])
        mine = (idx >= lo) & (idx < lo + CFG.rows_per_table // mesh["model"])
        own = out["own"].reshape(C.DLRM_B, CFG.n_tables, -1).numpy()
        full = vec.reshape(C.DLRM_B, CFG.n_tables, -1)
        np.testing.assert_array_equal(own[mine], full[mine])
        assert not own[~mine].any()
        # one K5 launch a batch; K4 once under collective_matmul
        assert out["launches"]["gather_rows"] == 1
        assert out["launches"]["matmul_tiled"] == int(cm)


def test_dlrm_params_drawn_per_process(world):
    """Params drawn per process from a seed: replicated params equal on
    every process, table shards distinct, the logits equal on every
    process and within 1e-5 of the float64 reference gathered outside
    the engine."""
    res = [world["ranks"][r]["dlrm"]["init"] for r in range(C.N)]
    for r in res[1:]:
        assert torch.equal(r["head"], res[0]["head"])
        assert torch.equal(r["logits"], res[0]["logits"])
        assert not torch.equal(r["tables"], res[0]["tables"])
    for r in res:
        np.testing.assert_allclose(r["logits"].double().numpy(),
                                   r["reference"].numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_dlrm_serve_cli_procs():
    from repro_torch.launch import dlrm_serve
    assert dlrm_serve.main(["--device", "cpu", "--rows", "64", "--tables",
                            "4", "--batch-size", "8", "--batches", "2",
                            "--procs", "2", "--backend", "native"]) == 0


def test_dlrm_serve_procs_needs_the_card():
    """`--procs` without `--device cpu` asks for CUDA and raises without
    it, before any process starts."""
    code = ("import torch\n"
            "from repro_torch.launch import dlrm_serve\n"
            "assert not torch.cuda.is_available()\n"
            "try:\n"
            "    dlrm_serve.main(['--procs', '2', '--rows', '64'])\n"
            "except RuntimeError as e:\n"
            "    assert 'CUDA' in str(e), e\n"
            "else:\n"
            "    raise SystemExit('no error')\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


# -- without a spawn ---------------------------------------------------------

class _OneProcess:
    """A stand-in per-process engine: one rank's mesh position."""

    def __init__(self, mesh_shape, coords):
        self.mesh_shape, self.coords = dict(mesh_shape), dict(coords)
        self.device = torch.device("cpu")

    stack_shape = ()

    def comm_rank(self, axis):
        return self.coords[axis]


MESH3 = {"pod": 1, "data": 2, "model": 4}
POSITIONS = [dict(zip(MESH3, np.unravel_index(g, (1, 2, 4))))
             for g in range(8)]


@pytest.mark.parametrize("coords", POSITIONS,
                         ids=[f"d{c['data']}m{c['model']}" for c in POSITIONS])
def test_parctx_local_mode(coords):
    """tp_rank, tp_slice and take on a local shard equal the stacked
    mode's row at the same mesh position."""
    stacked = ParCtx(engine=CollectiveEngine(MESH3, device="cpu"),
                     pcfg=ParallelConfig())
    local = ParCtx(engine=_OneProcess(MESH3, coords), pcfg=ParallelConfig())
    at = tuple(coords[a] for a in MESH3)
    assert local.local and not stacked.local and local.lead == 0
    assert local.tp == stacked.tp == 4
    assert local.tp_rank().shape == ()
    assert local.tp_rank(2).shape == (1, 1)
    assert int(local.tp_rank()) == int(
        stacked.tp_rank().expand(1, 2, 4)[at])
    x = torch.arange(3 * 16, dtype=torch.float32).reshape(3, 16)
    xs = x.expand((1, 2, 4, 3, 16))
    assert torch.equal(local.tp_slice(x, 4, dim=-1),
                       stacked.tp_slice(xs, 4, dim=-1)[at])
    assert torch.equal(local.tp_slice(x.T, 4, dim=0),
                       stacked.tp_slice(xs.transpose(-1, -2), 4, dim=0)[at])
    index = local.tp_rank(1) * 2 + torch.arange(2)
    sidx = stacked.tp_rank(1) * 2 + torch.arange(2)
    assert torch.equal(local.take(x, index, dim=1),
                       stacked.take(xs, sidx, dim=1)[at])
    assert torch.equal(local.take(x, torch.tensor([2, 0]), dim=0),
                       stacked.take(xs, torch.tensor([2, 0]), dim=0)[at])


def test_builder_draws_each_process_its_shard():
    """Per process: each shard from its own generator (seed, the param,
    its position on the spec's axes) — equal where the spec replicates,
    distinct where it shards — and the shapes `local_shape` gives."""
    cfg = DLRMConfig(n_tables=3, emb_dim=4, rows_per_table=16,
                     fc_dims=(8, 4), out_dim=1)
    trees = [dlrm.dlrm_params(Builder("init", mesh_shape=MESH3, coords=c,
                                      seed=7), cfg, 4) for c in POSITIONS]
    stacked = dlrm.dlrm_params(Builder("shape", mesh_shape=MESH3), cfg, 4)
    for t in trees:
        assert t["tables"].shape == stacked["tables"].shape[3:]
        for fc, sfc in zip(t["fc"], stacked["fc"]):
            assert fc["w"].shape == sfc["w"].shape[3:]
    for i, a in enumerate(POSITIONS):
        for j, b in enumerate(POSITIONS):
            same_m = a["model"] == b["model"]
            assert torch.equal(trees[i]["tables"], trees[j]["tables"]) \
                == same_m
            assert torch.equal(trees[i]["fc"][-1]["w"],
                               trees[j]["fc"][-1]["w"])
    again = dlrm.dlrm_params(Builder("init", mesh_shape=MESH3,
                                     coords=POSITIONS[5], seed=7), cfg, 4)
    assert torch.equal(again["tables"], trees[5]["tables"])


def test_local_shard_and_batch_helpers():
    """`convert.local_params` picks the stacked row at a process's
    position; `local_batch` is that process's rows of `stack_batch`."""
    cfg = reduced()
    gen = torch.Generator().manual_seed(0)
    params = dlrm.dlrm_params(Builder("init", generator=gen,
                                      mesh_shape=MESH3), cfg, 4)
    x = torch.arange(16 * 3).reshape(16, 3)
    sb = dlrm.stack_batch(x, MESH3)
    for c in POSITIONS:
        at = tuple(c[a] for a in MESH3)
        loc = convert.local_params(params, MESH3, c)
        assert torch.equal(loc["tables"], params["tables"][at])
        assert torch.equal(loc["fc"][1]["w"], params["fc"][1]["w"][at])
        assert torch.equal(dlrm.local_batch(x, MESH3, c), sb[at])
