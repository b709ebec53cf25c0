"""The port's `CollectiveEngine.ring_attention` against the JAX engine's.

One numpy input per case, made from a seed, goes through the reference
`repro.core.CollectiveEngine.ring_attention` under `shard_map` on the 8
host devices (the sequence sharded over the ring axis, as
`tests/test_engine.py::test_ring_attention_matches_full` runs it) and
through the port's engine with the ranks stacked. Tolerances:

  * fp32: rtol = atol = 1e-5 — the same IEEE ops in the same order per
    element, but the two frameworks' matrix products sum the head dim and
    the key block in different orders (~1e-7 relative each);
  * bf16: one bf16 ulp of the larger of the two outputs on every element
    (the fp32 accumulators agree as above, so the final rounding to bf16
    can differ by one step where an fp32 value lies near a rounding
    boundary). At most one element in 1000 may go further, and then by
    at most 2^-7 (p @ |v|) more, p a float64 softmax: both sides round p
    to bf16 before the PV product, and the two frameworks' fp32 `exp`
    and softmax differ in the last bits, so where an fp32 p_j lies next
    to a bf16 rounding midpoint the two roundings differ by one bf16
    step (<= 2^-7 p_j), moving the output by that times |v_j| (seen once
    in the 163840 bf16 outputs of these cases, 3 ulps, in the n = 1
    case). A port that formed the scores q @ k in bf16 puts 18-24 % of
    the elements beyond one ulp (up to hundreds of ulps):
    `test_ring_attention_bf16_scores_fail` holds the check to that.

The engine's `trace_log` entry must equal the reference's. The
reference tests' own checks are mirrored on the port alone: ring
attention within 2e-4 of a full-sequence attention
(`models/attention.py::chunked_attention`), segmented within 2e-5 of
unsegmented.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import CollectiveEngine as JaxEngine
from repro.core.topology import make_mesh
from repro_torch import convert
from repro_torch.core import CollectiveEngine
from repro_torch.models.attention import chunked_attention

B, S, HD = 4, 64, 16
FP32_TOL = dict(rtol=1e-5, atol=1e-5)

_MESHES = {}


def _meshes(shape, axes):
    key = (shape, axes)
    if key not in _MESHES:
        mesh = make_mesh(shape, axes)
        _MESHES[key] = (mesh, JaxEngine(mesh))
    return _MESHES[key]


def _inputs(h, kv, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, h, HD)).astype(np.float32)
    k = rng.normal(size=(B, S, kv, HD)).astype(np.float32)
    v = rng.normal(size=(B, S, kv, HD)).astype(np.float32)
    # both sides start from the same bf16 values
    return [np.array(jnp.asarray(t, dtype).astype(jnp.float32))
            for t in (q, k, v)]


def _specs(shape, axes, axis):
    """Sequence over the ring axis; batch over the other mesh axes where
    it splits over them, else replicated."""
    other = tuple(a for a, n in zip(axes, shape) if a != axis)
    parts = int(np.prod([n for a, n in zip(axes, shape) if a in other]))
    return (other if other and B % parts == 0 else None, axis)


def _reference(shape, axes, axis, qkv, dtype, **kw):
    """(output as fp32 numpy, trace_log entries) of the JAX engine."""
    mesh, eng = _meshes(shape, axes)
    eng.trace_log.clear()
    spec = P(*_specs(shape, axes, axis))
    g = jax.jit(jax.shard_map(
        lambda a, b, c: eng.ring_attention(a, b, c, axis, **kw),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
        check_vma=False))
    out = g(*[jnp.asarray(t, dtype) for t in qkv])
    return np.asarray(out.astype(jnp.float32)), list(eng.trace_log)


def _port(shape, axes, axis, qkv, dtype, **kw):
    """(output as fp32 numpy, engine, trace_log entries) of the port."""
    mesh = dict(zip(axes, shape))
    eng = CollectiveEngine(mesh, device="cpu")
    spec = _specs(shape, axes, axis)
    tdt = getattr(torch, dtype)
    st = [convert.stack_global(torch.from_numpy(t).to(tdt), mesh, spec)
          for t in qkv]
    out = eng.ring_attention(*st, axis, **kw)
    assert out.dtype == tdt
    g = convert.unstack(out, mesh, spec)
    return g.float().numpy(), list(eng.trace_log)


def _bf16_ulp(x):
    """One bf16 step at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _pv_magnitude(qkv, causal):
    """p @ |v| per output element, p the float64 softmax of the scores
    (the scale on a bf16 rounding flip of p)."""
    q, k, v = [t.astype(np.float64) for t in qkv]
    h, kv = q.shape[2], k.shape[2]
    kr, vr = (np.repeat(t, h // kv, axis=2) for t in (k, v))
    s = np.einsum("bqhd,bshd->bhqs", q, kr) / np.sqrt(q.shape[-1])
    if causal:
        s = np.where(np.tril(np.ones((S, S), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqs,bshd->bqhd", p, np.abs(vr))


# elements of a bf16 output allowed beyond one ulp (see the module doc)
BF16_FLIPS_PER = 1000


def _check(got, want, dtype, qkv, causal):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **FP32_TOL)
        return
    diff = np.abs(got - want)
    ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    over = diff > ulp
    assert over.sum() <= over.size // BF16_FLIPS_PER, (
        f"{int(over.sum())} of {over.size} elements differ by more than "
        f"one bf16 ulp (max {float((diff / ulp).max())} ulps)")
    flip = ulp + 2.0 ** -7 * _pv_magnitude(qkv, causal)
    bad = diff > flip
    assert not bad.any(), (
        f"{int(bad.sum())} elements differ by more than one ulp plus a p "
        f"rounding flip (max {diff.max()})")


CASES = (
    # (mesh shape, axes, ring axis, H, KV, dtype, causal, segments)
    [((8,), ("x",), "x", 4, 2, dt, c, s)
     for dt in ("float32", "bfloat16") for c in (True, False)
     for s in (1, 2, 4)]
    + [((8,), ("x",), "x", 4, 4, dt, c, 1)
       for dt in ("float32", "bfloat16") for c in (True, False)]
    # n = 1: the plain softmax path
    + [((8, 1), ("x", "y"), "y", 4, 2, dt, c, 1)
       for dt in ("float32", "bfloat16") for c in (True, False)]
    # each axis of a two-axis mesh
    + [((2, 4), ("a", "b"), ax, 4, 2, "float32", c, 2)
       for ax in ("a", "b") for c in (True, False)]
)


@pytest.mark.parametrize(
    "shape,axes,axis,h,kv,dtype,causal,segments", CASES,
    ids=[f"{'x'.join(map(str, c[0]))}-{c[2]}-h{c[3]}kv{c[4]}-{c[5]}-"
         f"{'causal' if c[6] else 'full'}-seg{c[7]}" for c in CASES])
def test_ring_attention_matches_reference(shape, axes, axis, h, kv, dtype,
                                          causal, segments):
    qkv = _inputs(h, kv, dtype)
    kw = dict(causal=causal, segments=segments)
    want, want_log = _reference(shape, axes, axis, qkv, dtype, **kw)
    got, got_log = _port(shape, axes, axis, qkv, dtype, **kw)
    _check(got, want, dtype, qkv, causal)
    assert got_log == want_log


@contextlib.contextmanager
def _bf16_scores():
    """The port with its scores formed in bf16: the q @ k product of bf16
    operands, rounded to bf16, in place of the upcast fp32 product."""
    real = torch.einsum

    def einsum(eq, *operands):
        if eq == "rbqkgh,rbskh->rbkgqs":
            return real(eq, *[t.bfloat16() for t in operands]).float()
        return real(eq, *operands)

    torch.einsum = einsum
    try:
        yield
    finally:
        torch.einsum = real


CONTROL_CASES = [c for c in CASES if c[5] == "bfloat16"
                 and (c[0] == (8, 1) or (c[4] == 2 and c[7] in (1, 4)))]


@pytest.mark.parametrize(
    "shape,axes,axis,h,kv,dtype,causal,segments", CONTROL_CASES,
    ids=[f"{'x'.join(map(str, c[0]))}-{'causal' if c[6] else 'full'}-"
         f"seg{c[7]}" for c in CONTROL_CASES])
def test_ring_attention_bf16_scores_fail(shape, axes, axis, h, kv, dtype,
                                         causal, segments):
    """The bf16 check is tight enough to see the scores' precision: the
    same inputs through a port whose q @ k is a bf16 product break it."""
    qkv = _inputs(h, kv, dtype)
    kw = dict(causal=causal, segments=segments)
    want, _ = _reference(shape, axes, axis, qkv, dtype, **kw)
    with _bf16_scores():
        got, _ = _port(shape, axes, axis, qkv, dtype, **kw)
    with pytest.raises(AssertionError, match="more than one bf16 ulp"):
        _check(got, want, dtype, qkv, causal)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_full(causal):
    """tests/test_engine.py's check on the port: the context-parallel
    result equals full-sequence attention within 2e-4."""
    qkv = _inputs(4, 2, "float32")
    full = chunked_attention(*[torch.from_numpy(t) for t in qkv],
                             causal=causal, q_block=16, kv_block=16)
    got, _ = _port((8,), ("x",), "x", qkv, "float32", causal=causal)
    np.testing.assert_allclose(got, full.numpy(), atol=2e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_segmented(causal):
    """tests/test_segmentation.py's check on the port: online softmax is
    exact under any block split, so only rounding differs (2e-5)."""
    qkv = _inputs(4, 2, "float32")
    one, _ = _port((8,), ("x",), "x", qkv, "float32", causal=causal)
    two, _ = _port((8,), ("x",), "x", qkv, "float32", causal=causal,
                   segments=2)
    np.testing.assert_allclose(two, one, atol=2e-5)


def test_ring_attention_differentiable():
    """No custom backward: the stacked indexing is plain autograd, so the
    gradient of a ring attention equals the gradient of the full
    attention it computes (fp32 on both sides, different block orders:
    1e-4)."""
    qkv = [torch.from_numpy(t) for t in _inputs(4, 2, "float32")]
    mesh = {"x": 8}
    st = [convert.stack_global(t, mesh, (None, "x")).requires_grad_()
          for t in qkv]
    eng = CollectiveEngine(mesh, device="cpu")
    eng.ring_attention(*st, "x").sum().backward()
    full = [t.clone().requires_grad_() for t in qkv]
    chunked_attention(*full, causal=True, q_block=16,
                      kv_block=16).sum().backward()
    for s, f in zip(st, full):
        g = convert.unstack(s.grad, mesh, (None, "x"))
        np.testing.assert_allclose(g.numpy(), f.grad.numpy(), rtol=1e-4,
                                   atol=1e-4)
