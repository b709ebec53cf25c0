"""The port's DLRM inference path (paper use case 2) against the JAX
package, at `reduced()` on the meshes (1, 2, 4) and (1, 1, 2).

The same numpy params and requests, made from a seed, go through the
reference `repro.models.dlrm` under `shard_map` on the host devices
(its Pallas kernels in interpret mode where `use_pallas` is on) and
through `repro_torch.models.dlrm` on the CPU, ranks stacked (the plain
versions of K4 and K5). Params in {-1, 0, 1} keep every partial sum an
integer below 2^24, so the two must agree BITWISE whatever their
summation order; with the reference's normal init they agree within
rtol = atol = 1e-5, and the port meets the reference's own 1e-3 against
`dlrm_reference`.
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
from repro.models import dlrm as jdlrm
from repro.models.common import Builder as JBuilder
from repro.parallel.ops import ParCtx as JParCtx
from repro_torch import convert
from repro_torch.configs import ParallelConfig, reduced
from repro_torch.core import CollectiveEngine
from repro_torch.launch.dlrm_serve import DLRMServer
from repro_torch.models import dlrm
from repro_torch.models.common import Builder
from repro_torch.parallel import ParCtx

AXES = ("pod", "data", "model")
MESHES = [(1, 2, 4), (1, 1, 2)]
BATCH = P(("pod", "data"), None)
CFG = reduced()
B = 16


def _mesh_shape(shape):
    return dict(zip(AXES, shape))


def _params_np(kind: str, tp: int, seed: int = 0):
    """Reference-shaped DLRM params as numpy: the reference's own init
    ('normal') or integers in {-1, 0, 1} ('int')."""
    b = JBuilder("init", key=jax.random.PRNGKey(seed), dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jdlrm.dlrm_params(b, CFG, tp))
    if kind == "int":
        rng = np.random.default_rng(seed)
        params = jax.tree.map(
            lambda a: rng.integers(-1, 2, a.shape).astype(np.float32), params)
    return params


def _requests(seed: int = 0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, CFG.rows_per_table,
                        (B, CFG.n_tables)).astype(np.int32)


_JAX_FNS = {}


def _jax_fn(shape, what: str, collective_matmul=False, use_pallas=False):
    """The jitted reference (one compile per case, any params)."""
    key = (shape, what, collective_matmul, use_pallas)
    if key not in _JAX_FNS:
        mesh = make_mesh(shape, AXES)
        tp = shape[-1]
        eng = JaxEngine(mesh, backend="microcode", use_pallas=use_pallas)
        ctx = JParCtx(engine=eng, mesh=mesh, pcfg=JParallelConfig(
            collective_matmul=collective_matmul))
        specs = jdlrm.dlrm_specs(CFG, tp)
        if what == "lookup":
            def body(p, i):
                return jdlrm.embedding_lookup(p["tables"], i, ctx,
                                              use_pallas=use_pallas)
        else:
            def body(p, i):
                return jdlrm.dlrm_forward(p, i, ctx, use_pallas=use_pallas)
        _JAX_FNS[key] = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(specs, BATCH), out_specs=BATCH,
            check_vma=False))
    return _JAX_FNS[key]


def _torch_ctx(shape, collective_matmul=False):
    return ParCtx(engine=CollectiveEngine(_mesh_shape(shape), device="cpu"),
                  pcfg=ParallelConfig(collective_matmul=collective_matmul))


def _torch_run(shape, params_np, idx, what: str, collective_matmul=False):
    ms = _mesh_shape(shape)
    ctx = _torch_ctx(shape, collective_matmul)
    params = convert.dlrm_params_from_jax(params_np, CFG, ms)
    stacked = dlrm.stack_batch(torch.from_numpy(idx), ms)
    if what == "lookup":
        out = dlrm.embedding_lookup(params["tables"], stacked, ctx)
    else:
        out = dlrm.DLRM(params, ctx)(stacked)
    return dlrm.unstack_batch(out, ms).numpy()


def _edge_requests(tp: int, seed: int = 0):
    """Requests holding an id at every shard edge of a `tp`-way split
    (lo - 1, lo, lo + rows_l - 1, lo + rows_l), row 0 and the last row,
    negative ids, ids past the last row and the int32 extremes; the rest
    uniform."""
    rows_l = CFG.rows_per_table // tp
    idx = _requests(seed)
    edges = [e for m in range(tp) for e in (m * rows_l - 1, m * rows_l,
                                            (m + 1) * rows_l - 1,
                                            (m + 1) * rows_l)]
    edges += [0, CFG.rows_per_table - 1, -1, -rows_l, CFG.rows_per_table,
              2**31 - 1, -2**31]
    idx.reshape(-1)[:len(edges)] = np.array(edges, dtype=np.int64)
    return idx


@pytest.mark.parametrize("ids", ["uniform", "edges"])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("shape", MESHES)
def test_embedding_lookup_bitwise(shape, use_pallas, ids):
    """The port's lookup (one K5 lookup per call, on the CPU its plain
    version) equals the reference's BITWISE: uniform ids, and ids at
    every shard edge, below 0 and past the last row (zero vectors)."""
    params = _params_np("normal", shape[-1])
    idx = _requests(1) if ids == "uniform" else _edge_requests(shape[-1], 1)
    want = np.asarray(_jax_fn(shape, "lookup", use_pallas=use_pallas)(
        params, jnp.asarray(idx)))
    got = _torch_run(shape, params, idx, "lookup")
    assert got.shape == (B, CFG.n_tables * CFG.emb_dim)
    assert np.array_equal(got, want)
    if ids == "edges":     # the out-of-range ids looked up nothing
        out = (idx < 0) | (idx >= CFG.rows_per_table)
        assert out.any() and not got.reshape(B, CFG.n_tables, -1)[out].any()


def test_embedding_lookup_reads_ids_in_place(monkeypatch):
    """embedding_lookup makes ONE K5 lookup call and no other kernel call:
    the stacked ids reach it as the stride-0 view `stack_batch` made
    (no copy), with each rank's first row as `lo`."""
    ms = _mesh_shape((1, 1, 4))
    ctx = _torch_ctx((1, 1, 4))
    params = convert.dlrm_params_from_jax(_params_np("normal", 4), CFG, ms)
    stacked = dlrm.stack_batch(torch.from_numpy(_requests(3)), ms)
    calls = []
    real = dlrm.kops.embedding_lookup_rows

    def record(tables, ids, lo):
        calls.append((tables, ids, lo))
        return real(tables, ids, lo)

    monkeypatch.setattr(dlrm.kops, "embedding_lookup_rows", record)
    monkeypatch.setattr(dlrm.kops, "embedding_gather", None)
    dlrm.embedding_lookup(params["tables"], stacked, ctx)
    (tables, ids, lo), = calls
    rows_l = CFG.rows_per_table // 4
    assert tables.shape == (4, CFG.n_tables, rows_l, CFG.emb_dim)
    assert ids.shape == (4, B, CFG.n_tables) and ids.stride()[0] == 0
    assert ids.data_ptr() == stacked.data_ptr()
    assert lo.tolist() == [m * rows_l for m in range(4)]


@pytest.mark.parametrize("collective_matmul", [False, True])
@pytest.mark.parametrize("shape", MESHES)
def test_dlrm_forward_matches_jax(shape, collective_matmul):
    """Bitwise on integer-valued params (K4 in interpret mode on the
    reference side under collective_matmul), within 1e-5 on the
    reference's normal init, and within the reference's 1e-3 of
    `dlrm_reference`."""
    tp = shape[-1]
    fn = _jax_fn(shape, "forward", collective_matmul,
                 use_pallas=collective_matmul)
    idx = _requests(2)
    ints = _params_np("int", tp, seed=3)
    want = np.asarray(fn(ints, jnp.asarray(idx)))
    got = _torch_run(shape, ints, idx, "forward", collective_matmul)
    assert got.shape == (B, CFG.out_dim)
    assert np.array_equal(got, want)
    assert np.abs(got).max() > 0

    normal = _params_np("normal", tp, seed=4)
    want = np.asarray(fn(normal, jnp.asarray(idx)))
    got = _torch_run(shape, normal, idx, "forward", collective_matmul)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    ref = dlrm.dlrm_reference(
        jax.tree.map(lambda a: torch.from_numpy(np.array(a)), normal),
        torch.from_numpy(idx))
    np.testing.assert_allclose(got, ref.numpy(), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("shape", MESHES)
def test_dlrm_params_round_trip(shape):
    params = _params_np("normal", shape[-1], seed=5)
    ms = _mesh_shape(shape)
    stacked = convert.dlrm_params_from_jax(params, CFG, ms)
    assert stacked["tables"].shape == tuple(shape) + (
        CFG.n_tables, 1000 // shape[-1], CFG.emb_dim)
    back = convert.dlrm_params_to_jax(stacked, CFG, ms)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_builder_matches_reference_shapes_and_specs():
    """Same shapes (stacked over the mesh), spec tuples and init laws
    as the reference Builder; replicas over unnamed axes are equal."""
    ms = _mesh_shape((1, 2, 4))
    gen = torch.Generator().manual_seed(0)
    params = dlrm.dlrm_params(Builder("init", generator=gen, mesh_shape=ms),
                              CFG, 4)
    ref = jdlrm.dlrm_params(JBuilder("init", key=jax.random.PRNGKey(0)),
                            CFG, 4)
    specs = dlrm.dlrm_specs(CFG, 4)
    jspecs = jdlrm.dlrm_specs(CFG, 4)
    for t, r, s, js in zip(jax.tree.leaves(params), jax.tree.leaves(ref),
                           jax.tree.leaves(specs, is_leaf=lambda x:
                                           isinstance(x, tuple)),
                           jax.tree.leaves(jspecs, is_leaf=lambda x:
                                           isinstance(x, P))):
        assert s == tuple(js)
        assert convert.from_stacked(t, ms, s).shape == r.shape
        assert torch.equal(t[:, 0], t[:, 1])          # replicated over data
    w1 = params["fc"][1]["w"]
    std = float(w1.std())
    assert abs(std - 1 / np.sqrt(CFG.fc_dims[0])) < 0.2 / np.sqrt(64)
    assert abs(float(params["tables"].std()) - 0.01) < 1e-3
    assert not params["fc"][0]["b"].any()


def test_server_on_cpu_answers_batches():
    server = DLRMServer(CFG, mesh_shape=_mesh_shape((1, 2, 4)), device="cpu",
                        seed=7)
    ctx = server.ctx
    rng = np.random.default_rng(8)
    for _ in range(3):
        idx = torch.from_numpy(rng.integers(
            0, CFG.rows_per_table, (B, CFG.n_tables)).astype(np.int32))
        out = server.serve(idx)
        stacked = dlrm.stack_batch(idx, server.mesh_shape)
        want = dlrm.unstack_batch(dlrm.dlrm_forward(
            server.model.params(), stacked, ctx), server.mesh_shape)
        assert out.shape == (B, 1) and torch.equal(out, want)
        assert torch.equal(server.lookup(idx), dlrm.lookup_shards(
            server.tables_copy(), idx))
        torch.testing.assert_close(server.reference(idx), out, rtol=1e-5,
                                   atol=1e-5)
    for bad in (idx.float(), idx[:, :3], idx[0]):
        with pytest.raises(ValueError, match="requests"):
            server.serve(bad)


def test_server_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DLRMServer(CFG)


def test_stack_batch_round_trip():
    ms = _mesh_shape((2, 2, 2))
    x = torch.arange(8 * 3).reshape(8, 3)
    st = dlrm.stack_batch(x, ms)
    assert st.shape == (2, 2, 2, 2, 3)
    want = convert.to_stacked(x.numpy(), ms, (("pod", "data"), None))
    assert torch.equal(st, want)
    assert torch.equal(dlrm.unstack_batch(st, ms), x)
