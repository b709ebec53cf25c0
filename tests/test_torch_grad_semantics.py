"""The port's autodiff contracts through the engine, on both backends,
against the JAX package's (`tests/test_grad_semantics.py`, the reference
of `repro/parallel/ops.py`'s contract): the backward differentiates the
SUM of the per-rank losses, so a TP-replicated loss comes out tp x the
true gradient, an FSDP gather's adjoint is the data-summed shard, and a
replicated param's per-rank grads need the explicit sync.

Each engine collective a training forward reaches records its adjoint
Function (`core/autograd.py`) as its output's `grad_fn`, so the CPU and
the card take one backward; each adjoint is checked against autograd
through a plain torch model of the collective. The same numpy-seeded
inputs go through the JAX shard_map programs and the port's stacked
ranks; tolerances are stated per test (fp32 throughout).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import CollectiveEngine as JaxEngine
from repro.core.topology import make_mesh
from repro_torch.configs import ParallelConfig, get_config, reduced_config
from repro_torch.core import CollectiveEngine
from _torch_train_cases import one_torch_thread  # noqa: F401
from repro_torch import tree
from repro_torch.parallel import stages
from repro_torch.parallel.ops import ParCtx, spec_axes

BACKENDS = ("microcode", "native")
N = 4


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(6, 8)).astype(np.float32)
    W = rng.normal(size=(8, 4)).astype(np.float32)
    Xb = np.random.default_rng(1).normal(size=(12, 8)).astype(np.float32)
    Xr = np.random.default_rng(2).normal(size=(12, 8)).astype(np.float32)
    return X, W, Xb, Xr


@pytest.fixture(scope="module")
def jax_grads(data):
    """The reference's three shard_map gradients on a 4-rank mesh."""
    X, W, Xb, Xr = data
    mesh = make_mesh((N,), ("m",))
    eng = JaxEngine(mesh, backend="microcode")
    Xs = X.reshape(6, 4, 2).transpose(1, 0, 2)
    Ws = W.reshape(4, 2, 4)

    def row(x, w):
        return ((eng.allreduce(x @ w, "m", algorithm="ring")) ** 2).sum()

    g_row = jax.jit(jax.shard_map(
        jax.grad(row, argnums=1), mesh=mesh, in_specs=(P("m"), P("m")),
        out_specs=P("m"), check_vma=False))(jnp.asarray(Xs), jnp.asarray(Ws))

    def fsdp(x, w_shard):
        w = eng.allgather(w_shard, "m", algorithm="ring").reshape(8, 4)
        return ((x @ w) ** 2).sum()

    g_fsdp = jax.jit(jax.shard_map(
        jax.grad(fsdp, argnums=1), mesh=mesh,
        in_specs=(P("m"), P("m", None)), out_specs=P("m", None),
        check_vma=False))(jnp.asarray(Xb), jnp.asarray(W))

    def repl(x, w):
        return ((x @ w) ** 2).sum()

    g_repl = jax.jit(jax.shard_map(
        lambda x, w: jax.grad(repl, argnums=1)(x, w)[None], mesh=mesh,
        in_specs=(P("m"), P()), out_specs=P("m"),
        check_vma=False))(jnp.asarray(Xr), jnp.asarray(W))
    return (np.asarray(g_row).reshape(8, 4), np.asarray(g_fsdp),
            np.asarray(g_repl))


def _engine(backend):
    return CollectiveEngine({"m": N}, backend=backend, device="cpu")


def _true_grad(X, W):
    w = torch.tensor(W, requires_grad=True)
    ((torch.tensor(X) @ w) ** 2).sum().backward()
    return w.grad.numpy()


@pytest.mark.parametrize("backend", BACKENDS)
def test_psum_transpose_gives_tp_factor(backend, data, jax_grads):
    """Row-parallel grads come out tp x the true grad on both backends —
    hence the 1/tp loss scale — and equal the reference's (1e-5)."""
    X, W, _, _ = data
    eng = _engine(backend)
    xs = torch.tensor(X.reshape(6, 4, 2).transpose(1, 0, 2).copy())
    ws = torch.tensor(W.reshape(4, 2, 4).copy(), requires_grad=True)
    y = eng.allreduce(torch.matmul(xs, ws), "m",
                      algorithm="ring" if backend == "microcode" else "auto")
    (y ** 2).sum().backward()
    g = ws.grad.reshape(8, 4).numpy()
    np.testing.assert_allclose(g / _true_grad(X, W), 4.0, rtol=1e-4)
    np.testing.assert_allclose(g, jax_grads[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_fsdp_gather_vjp_is_data_summed_shard(backend, data, jax_grads):
    """allgather's adjoint (a reduce-scatter through the engine) returns
    each rank the data-summed gradient of its shard (atol 1e-3, the
    reference's; 1e-5 against the reference's own)."""
    _, W, Xb, _ = data
    eng = _engine(backend)
    xs = torch.tensor(Xb.reshape(4, 3, 8))
    w_shard = torch.tensor(W.reshape(4, 2, 4), requires_grad=True)
    w = eng.allgather(w_shard, "m").reshape(4, 8, 4)
    ((torch.matmul(xs, w)) ** 2).sum().backward()
    g = w_shard.grad.reshape(8, 4).numpy()
    np.testing.assert_allclose(g, _true_grad(Xb, W), atol=1e-3)
    np.testing.assert_allclose(g, jax_grads[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_replicated_param_needs_explicit_sync(backend, data, jax_grads):
    """Per-rank grads of a replicated param sum to the true gradient (the
    grad_sync rule: allreduce over the axes its spec leaves out)."""
    _, W, _, Xr = data
    xs = torch.tensor(Xr.reshape(4, 3, 8))
    w = torch.tensor(np.broadcast_to(W, (4, 8, 4)).copy(),
                     requires_grad=True)
    ((torch.matmul(xs, w)) ** 2).sum().backward()
    per_rank = w.grad.numpy()
    np.testing.assert_allclose(per_rank, jax_grads[2], rtol=1e-5, atol=1e-5)
    synced = _engine(backend).allreduce(w.grad, "m")
    np.testing.assert_allclose(synced[0].numpy(), _true_grad(Xr, W),
                               atol=1e-3)


# --------------------------------------------------------------------------
# The adjoint Functions
# --------------------------------------------------------------------------

def _plain(name, x, w=None):
    """Each collective as plain differentiable torch over the stacked
    rank dim (`{"m": 4}`)."""
    n = x.shape[0]
    if name == "allreduce":
        return x.sum(0, keepdim=True).expand_as(x)
    if name == "allgather":
        flat = x.reshape(n, -1).reshape(1, -1)
        return flat.expand(n, flat.shape[1])
    if name == "reduce_scatter":
        s = x.reshape(n, -1).sum(0)
        return s.reshape(n, -1)
    if name == "alltoall":
        blocks = x.reshape((n, n, x.shape[1] // n) + tuple(x.shape[2:]))
        return blocks.transpose(0, 1).reshape(x.shape)
    if name == "allgather_matmul":
        xg = x.reshape(1, -1, x.shape[-1]).expand(n, -1, -1)
        return torch.matmul(xg, w)
    if name == "matmul_reduce_scatter":
        return _plain("reduce_scatter", torch.matmul(x, w)).reshape(
            n, x.shape[1] // n, w.shape[-1])
    raise ValueError(name)


CASES = {
    "allreduce": ((4, 6, 5), None),
    "allgather": ((4, 3, 5), None),
    "reduce_scatter": ((4, 8, 3), None),
    "alltoall": ((4, 8, 3), None),
    "allgather_matmul": ((4, 3, 5), (4, 5, 2)),
    "matmul_reduce_scatter": ((4, 8, 5), (4, 5, 2)),
}
FUNCTIONS = {"allreduce": "AllReduce", "allgather": "AllGather",
             "reduce_scatter": "ReduceScatter", "alltoall": "AllToAll",
             "allgather_matmul": "AllGatherMatmul",
             "matmul_reduce_scatter": "MatmulReduceScatter"}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_collective_records_its_adjoint(backend, name):
    """The output's grad_fn is the collective's own adjoint Function (not
    autograd through the executor), and its gradients equal autograd
    through the plain model of the collective (fp32, 1e-5)."""
    eng = _engine(backend)
    rng = np.random.default_rng(3)
    xs, ws = CASES[name]
    x = torch.tensor(rng.normal(size=xs).astype(np.float32),
                     requires_grad=True)
    w = None if ws is None else torch.tensor(
        rng.normal(size=ws).astype(np.float32), requires_grad=True)
    args = (x, "m") if w is None else (x, w, "m")
    y = getattr(eng, name)(*args)
    assert type(y.grad_fn).__name__ == FUNCTIONS[name] + "Backward"
    cot = torch.tensor(rng.normal(size=tuple(y.shape)).astype(np.float32))
    got = torch.autograd.grad((y * cot).sum(), [t for t in (x, w)
                                                if t is not None])
    want_y = _plain(name, x, w)
    np.testing.assert_allclose(y.detach().numpy(),
                               want_y.detach().numpy(), rtol=1e-5,
                               atol=1e-5)
    want = torch.autograd.grad((want_y * cot).sum(),
                               [t for t in (x, w) if t is not None])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_two_axis_adjoints(backend):
    """A (pod, data) product collective's adjoint is the same call over
    the same axis tuple (the inner-major flat rank places and reads back
    each shard): allgather <-> reduce_scatter, allreduce <-> allreduce,
    against autograd through the plain model (1e-5)."""
    eng = CollectiveEngine({"pod": 2, "data": 4}, backend=backend,
                           device="cpu")
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.normal(size=(2, 4, 16)).astype(np.float32),
                     requires_grad=True)
    cot = torch.tensor(rng.normal(size=(2, 4, 128)).astype(np.float32))
    y = eng.allgather(x, ("pod", "data"))
    assert type(y.grad_fn).__name__ == "AllGatherBackward"
    (g,) = torch.autograd.grad((y * cot).sum(), [x])
    # inner-major: flat rank r = intra * P + pod holds slot r
    flat = x.transpose(0, 1).reshape(8, 16)
    want_y = flat.reshape(1, 1, -1).expand(2, 4, 128)
    np.testing.assert_allclose(y.detach().numpy(), want_y.detach().numpy())
    (want,) = torch.autograd.grad((want_y * cot).sum(), [x])
    np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    z = eng.allreduce(x, ("pod", "data"))
    (g2,) = torch.autograd.grad((z * cot[..., :16]).sum(), [x])
    want2 = cot[..., :16].sum((0, 1), keepdim=True).expand(2, 4, 16)
    np.testing.assert_allclose(g2.numpy(), want2.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_max_allreduce_takes_no_gradient(backend):
    """A max allreduce is only defined on gradient-free values: its
    Function raises if a gradient reaches it (the CE stabiliser is
    detached, `lm_head_ce`)."""
    eng = _engine(backend)
    x = torch.randn(4, 5, requires_grad=True)
    y = eng.allreduce(x, "m", op="max")
    with pytest.raises(RuntimeError, match="gradient-free"):
        y.sum().backward()
    assert not eng.allreduce(x.detach(), "m", op="max").requires_grad


# --------------------------------------------------------------------------
# grad_sync
# --------------------------------------------------------------------------

MESH = {"pod": 2, "data": 2, "model": 2}


def _grads(cfg, seed=0):
    """Per-rank random grads shaped like the FSDP-layout params."""
    shapes = stages.param_shapes(cfg, MESH, 2)
    g = torch.Generator().manual_seed(seed)
    return {p: torch.randn(t.shape, generator=g).to(t.dtype)
            for p, t in tree.flatten(shapes)}


def test_grad_sync_bucketing():
    """Every param is synced over 'pod' (never sharded there), and
    grad_sync allreduces exactly the axes missing from each spec: each
    synced leaf is the sum of its copies over those axes (1e-5), and the
    returned sum of squares counts each replica once."""
    cfg = reduced_config(get_config("qwen3-0.6b"))
    specs = stages.param_specs(cfg, 2)
    for path, spec in tree.flatten(specs):
        assert "pod" not in spec_axes(spec), path
    raw = _grads(cfg)
    ctx = ParCtx(engine=CollectiveEngine(MESH, device="cpu"),
                 pcfg=ParallelConfig())
    synced, sq = stages.grad_sync(tree.unflatten(list(raw.items())),
                                  specs, ctx)
    spec_of = dict(tree.flatten(specs))
    total = 0.0
    for path, g in tree.flatten(synced):
        lay = int(path[0] == "layers")
        dims = tuple(lay + i for i, a in enumerate(MESH)
                     if a not in spec_axes(spec_of[path]))
        want = raw[path].sum(dims, keepdim=True).expand_as(raw[path])
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
        repl = int(np.prod([g.shape[d] for d in dims]))
        total += float((g ** 2).sum()) / repl
    np.testing.assert_allclose(float(sq.sum()), total, rtol=1e-5)


@pytest.mark.parametrize("compression", [None, "int8", "bf16"])
def test_grad_sync_queued_equals_blocking(compression):
    """The queued sync (itree_allreduce, every bucket issued before any
    wait) is bitwise the blocking one (tree_allreduce), with the
    gradient exchange's mesh-level price recorded."""
    cfg = reduced_config(get_config("smollm-360m"))
    specs = stages.param_specs(cfg, 2)
    raw = tree.unflatten(list(_grads(cfg, 1).items()))
    out = {}
    for queued in (True, False):
        ctx = ParCtx(engine=CollectiveEngine(MESH, device="cpu"),
                     pcfg=ParallelConfig())
        out[queued] = stages.grad_sync(raw, specs, ctx,
                                       compression=compression,
                                       use_queue=queued)
        if queued:
            assert ctx.engine.queue.stats["issued"] >= 1
            assert ctx.engine.stats.get("grad_sync_makespan_s") > 0
    for (p, a), (_, b) in zip(tree.flatten(out[True][0]),
                              tree.flatten(out[False][0])):
        assert torch.equal(a, b), p
    assert torch.equal(out[True][1], out[False][1])
