"""The port's kernels' plain versions (K1-K5) against the JAX reference.

The same numpy inputs, made from a seed, go through
`repro_torch.kernels` (on the CPU: the plain PyTorch versions the CUDA
kernels are held to on the card) and through the reference — its Pallas
kernels in interpret mode (`repro.kernels.ops`) and its jnp codec
(`repro.core.plugins.int8_compress/decompress(use_pallas=False)`, the
path the reference engine runs). Every comparison is BITWISE. Covered:
the reciprocal scale, half-even ties, the single-rounding fp32
dequantize-add, the bf16 path, per-rank padding, and the Pallas path's
32768-element padding (valid blocks only). K5 is bitwise too; K4 (a sum
in another order) is held to the reference's own tolerances.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plugins as jplugins
from repro.kernels import embedding_gather as jeg
from repro.kernels import ops as jops
from repro_torch.core import CollectiveEngine
from repro_torch.core import engine as tengine
from repro_torch.core import plugins as tplugins
from repro_torch.kernels import embedding_gather, fused_reduce, matmul, ops, \
    quantize, ref


def _np(t):
    return np.asarray(t.float()) if t.dtype == torch.bfloat16 else \
        np.asarray(t)


def _j2np(a):
    return np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16 \
        else np.asarray(a)


def _mixed(shape, seed):
    """Heavy-tailed values spanning many binades."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * np.exp(3 * rng.normal(size=shape))
            ).astype(np.float32)


def _jax_rows(fn, X):
    """Apply a per-rank reference function to every row of X."""
    return [fn(jnp.asarray(row)) for row in X]


# -- K1: fused combine ---------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["add", "max", "min", "mul"])
def test_k1_matches_pallas_interpret(op, dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 1000)).astype(np.float32)
    y = rng.normal(size=(8, 1000)).astype(np.float32)
    want = jops.fused_combine(jnp.asarray(x).astype(dtype),
                              jnp.asarray(y).astype(dtype), op=op)
    got = ops.fused_combine(torch.from_numpy(x).to(getattr(torch, dtype)),
                            torch.from_numpy(y).to(getattr(torch, dtype)),
                            op)
    assert np.array_equal(_np(got), _j2np(want))


@pytest.mark.parametrize("op", ["add", "max", "min", "mul"])
def test_k1_matches_jnp_plugin_bf16(op):
    """bf16 combine, as the reference engine's jnp plugin computes it."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 3000)).astype(np.float32) * 100
    y = rng.normal(size=(4, 3000)).astype(np.float32)
    xb, yb = jnp.asarray(x).astype(jnp.bfloat16), \
        jnp.asarray(y).astype(jnp.bfloat16)
    want = jax.jit(lambda a, b: jplugins.combine(op, a, b))(xb, yb)
    got = tplugins.combine(op, torch.from_numpy(x).to(torch.bfloat16),
                           torch.from_numpy(y).to(torch.bfloat16))
    assert np.array_equal(_np(got), _j2np(want))


def test_k1_cast_and_in_place_out():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(3, 77)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(3, 77)).astype(np.float32))
    want = jops.fused_combine(jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
                              op="add", out_dtype=jnp.bfloat16)
    got = ops.fused_combine(x, y, "add", out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(_np(got), _j2np(want))
    expect = (x + y).clone()
    ops.fused_combine(x, y, "add", out=x)
    assert torch.equal(x, expect)


# -- K1 indexed: operands read in place through the executor's region index ---

def _recorded_combines(monkeypatch, algo, segments, X, op="add"):
    """Every indexed K1 call one port allreduce of X makes on the CPU:
    (a, a_index, b, b_index, op), operands as they were at the call."""
    calls = []
    real = ops.fused_combine_at

    def record(a, a_index, b, b_index, op="add", out_dtype=None, out=None,
               in_place=False):
        calls.append((a.clone(), a_index, b.clone(), b_index, op))
        return real(a, a_index, b, b_index, op, out_dtype, out, in_place)

    monkeypatch.setattr(ops, "fused_combine_at", record)
    CollectiveEngine({"x": 8}, device="cpu").allreduce(
        X, "x", op=op, algorithm=algo, segments=segments)
    return calls


@pytest.mark.parametrize("layout", ["aligned", "ragged"])
@pytest.mark.parametrize("segments", [1, 4])
@pytest.mark.parametrize("algo", ["ring", "bidi_ring", "halving_doubling"])
def test_k1_at_plain_version_is_gather_then_combine(monkeypatch, algo,
                                                    segments, layout):
    """The indexed K1's plain version, on the (unit, k) layouts of real
    programs, equals `ref.fused_combine` of the two `_gather`ed operands
    and the reference's Pallas kernel (interpret mode) on them, bitwise,
    one call over all of an exchange's segments. The ragged layout's
    units are 5 or 15 fp32 (not 16-byte vectors)."""
    shape = (8, 1024) if layout == "aligned" else (8, 40, 3)
    X = torch.from_numpy(_mixed(shape, seed=20))
    calls = _recorded_combines(monkeypatch, algo, segments, X)
    assert calls
    units = {(c[1][0], c[1][2].shape[0]) for c in calls}
    if segments > 1:
        assert any(k > 1 for _u, k in units), units
    for a, ai, b, bi, op in calls[:2] + calls[-2:]:
        got = ref.fused_combine_at(a, ai, b, bi, op)
        ga, gb = tengine._gather(a, ai), tengine._gather(b, bi)
        assert torch.equal(got, ref.fused_combine(ga, gb, op))
        assert torch.equal(got, torch.stack([
            ref.fused_combine(ga[j], gb[j], op) for j in range(ga.shape[0])]))
        want = jops.fused_combine(jnp.asarray(ga.numpy()),
                                  jnp.asarray(gb.numpy()), op=op)
        assert np.array_equal(got.numpy(), _j2np(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["max", "min", "mul"])
def test_k1_at_ops_match_pallas_interpret(monkeypatch, op, dtype):
    """Every op and dtype through the indexed entry point of ops, on a
    ring program's regions (every segment of an exchange), with an fp32
    -> bf16 cast."""
    X = torch.from_numpy(_mixed((8, 512), seed=21)).to(getattr(torch, dtype))
    calls = _recorded_combines(monkeypatch, "ring", 4, X, op=op)
    for a, ai, b, bi, _op in calls[:2]:
        ga, gb = tengine._gather(a, ai), tengine._gather(b, bi)
        for out_dtype in (None, "bfloat16"):
            got = ops.fused_combine_at(
                a, ai, b, bi, op,
                out_dtype=out_dtype and getattr(torch, out_dtype))
            want = jops.fused_combine(
                jnp.asarray(_np(ga)).astype(dtype),
                jnp.asarray(_np(gb)).astype(dtype), op=op,
                out_dtype=out_dtype and getattr(jnp, out_dtype))
            assert np.array_equal(_np(got), _j2np(want))


# -- K2: quantize ----------------------------------------------------------------

def _jnp_compress(X, dtype="float32"):
    """Reference engine codec, one rank row at a time."""
    f = jax.jit(jplugins.int8_compress)
    outs = [f(jnp.asarray(row).astype(dtype)) for row in X]
    return (np.stack([np.asarray(o.payload) for o in outs]),
            np.stack([np.asarray(o.scale) for o in outs]))


def test_k2_reciprocal_scale_matches_jnp():
    """Finding 1: the reference's scale is amax * f32(1/127), not a true
    division; the input is chosen so that the two differ on some blocks."""
    X = _mixed((4, 256 * 256), seed=3)
    q, s = ops.quantize_int8(torch.from_numpy(X))
    jq, js = _jnp_compress(X)
    assert np.array_equal(np.asarray(s), js)
    assert np.array_equal(np.asarray(q), jq)
    amax = np.abs(X.reshape(4, -1, 256)).max(-1)
    true_div = np.maximum(amax / np.float32(127.0), np.float32(1e-12))
    assert np.sum(true_div != js) > 0   # the input discriminates


def _tie_rows():
    """Blocks whose max is 127 * 2^e have scale exactly 2^e, so every
    (j + .5) * 2^e lands on a rounding tie."""
    ties = np.concatenate([[127.0, 0.0], np.arange(-127, 127) + 0.5])
    rows = [ties * 2.0 ** e for e in (-6, 0, 3)]
    return np.stack([np.concatenate(rows), -np.concatenate(rows)]
                    ).astype(np.float32)


def test_k2_half_even_ties():
    X = _tie_rows()
    q, s = ops.quantize_int8(torch.from_numpy(X))
    jq, js = _jnp_compress(X)
    assert np.array_equal(np.asarray(q), jq)
    assert np.array_equal(np.asarray(s), js)
    codes = np.asarray(q).reshape(2, 3, 256)[:, :, 2:]
    assert np.all(codes % 2 == 0)            # ties went to even
    assert np.sum(np.abs(codes) == 126) > 0  # 126.5 rounded down


def test_k2_per_rank_padding():
    """Each rank's row pads to whole 256-blocks on its own."""
    X = _mixed((5, 1000), seed=4)
    q, s = ops.quantize_int8(torch.from_numpy(X))
    assert tuple(q.shape) == (5, 1024) and tuple(s.shape) == (5, 4)
    jq, js = _jnp_compress(X)
    assert np.array_equal(np.asarray(q), jq)
    assert np.array_equal(np.asarray(s), js)


def test_k2_bf16_path():
    X = _mixed((3, 2048), seed=5)
    q, s = ops.quantize_int8(torch.from_numpy(X).to(torch.bfloat16))
    jq, js = _jnp_compress(X, "bfloat16")
    assert np.array_equal(np.asarray(q), jq)
    assert np.array_equal(np.asarray(s), js)


def test_k2_matches_pallas_valid_blocks():
    """The Pallas wrapper pads to 32768 elements; the valid blocks agree."""
    X = _mixed((1, 256 * 40), seed=6)
    q, s = ops.quantize_int8(torch.from_numpy(X))
    pq, ps = jops.quantize_int8(jnp.asarray(X[0]))
    assert pq.shape[0] == 32768
    assert np.array_equal(np.asarray(q)[0], np.asarray(pq)[:256 * 40])
    assert np.array_equal(np.asarray(s)[0], np.asarray(ps)[:40])


# -- K3: dequantize (+ fused consume) -----------------------------------------

def _codes(seed, rows=4, n=256 * 24):
    X = _mixed((rows, n), seed=seed)
    q, s = ref.quantize_blocks(torch.from_numpy(X))
    return q, s, n


def test_k3_copy_matches_jnp_and_pallas():
    q, s, n = _codes(7)
    got = ops.dequantize_int8(q, s, n)
    for r in range(q.shape[0]):
        c = jplugins.Compressed(jnp.asarray(q[r].numpy()),
                                jnp.asarray(s[r].numpy()))
        want = jplugins.int8_decompress(c, (n,), jnp.float32)
        assert np.array_equal(np.asarray(got[r]), np.asarray(want))
        pal = jops.dequantize_int8(
            jnp.pad(c.payload, (0, 32768 - n)),
            jnp.pad(c.scale, (0, 128 - n // 256)))
        assert np.array_equal(np.asarray(got[r]), np.asarray(pal)[:n])


def _jnp_consume(q, s, old, n, op, dtype):
    def f(qr, sr, o):
        inc = jplugins.int8_decompress(jplugins.Compressed(qr, sr), (n,),
                                       dtype)
        return jplugins.combine(op, o, inc)
    f = jax.jit(f)
    return np.stack([
        _j2np(f(jnp.asarray(q[r].numpy()), jnp.asarray(s[r].numpy()),
                jnp.asarray(old[r]).astype(dtype)))
        for r in range(q.shape[0])])


def test_k3_fp32_add_rounds_once():
    """Finding 2: the reference contracts dequantize + add into one FMA."""
    q, s, n = _codes(8)
    old = np.random.default_rng(9).normal(size=(q.shape[0], n)
                                          ).astype(np.float32)
    got = ops.dequantize_int8(q, s, n, old=torch.from_numpy(old), op="add")
    want = _jnp_consume(q, s, old, n, "add", jnp.float32)
    assert np.array_equal(np.asarray(got), want)
    two_roundings = old + ref.dequantize_blocks(q, s, n).numpy()
    assert np.sum(two_roundings != want) > 0   # the input discriminates


def test_k3_bf16_add_rounds_twice():
    q, s, n = _codes(10)
    old = np.random.default_rng(11).normal(size=(q.shape[0], n)
                                           ).astype(np.float32)
    got = ops.dequantize_int8(
        q, s, n, old=torch.from_numpy(old).to(torch.bfloat16), op="add")
    want = _jnp_consume(q, s, old, n, "add", jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(_np(got), want)


@pytest.mark.parametrize("op", ["max", "min", "mul"])
def test_k3_other_consume_ops(op):
    q, s, n = _codes(12)
    old = np.random.default_rng(13).normal(size=(q.shape[0], n)
                                           ).astype(np.float32)
    got = ops.dequantize_int8(q, s, n, old=torch.from_numpy(old), op=op)
    want = _jnp_consume(q, s, old, n, op, jnp.float32)
    assert np.array_equal(np.asarray(got), want)


def test_fma_plain_version_is_exact():
    """The plain single-rounding FMA agrees with exact rational
    arithmetic, including sums that sit on a float32 midpoint."""
    from fractions import Fraction
    rng = np.random.default_rng(14)
    a = rng.integers(-127, 128, size=4000).astype(np.float32)
    b = (rng.normal(size=4000) * np.exp(4 * rng.normal(size=4000))
         ).astype(np.float32)
    c = (rng.normal(size=4000) * np.exp(4 * rng.normal(size=4000))
         ).astype(np.float32)
    # midpoint cases: c + a*b exactly halfway between two float32s
    c[:8] = np.float32(1.0)
    a[:8] = 1.0
    b[:8] = np.float32(2.0 ** -24) * np.array([1, -1, 3, -3, 1, -1, 5, -5])
    got = ref._fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                       torch.from_numpy(c)).numpy()
    for i in range(len(a)):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        # float(Fraction) rounds correctly to float64; check float32 RN
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(v.view(np.int32)) & 1))
        assert got[i] == best, (i, a[i], b[i], c[i], got[i], best)


# -- K2/K3 indexed: a whole exchange in one call, operands read in place ------

def _recorded_codec_calls(monkeypatch, algo, segments, X, op="add"):
    """Every indexed K2 and K3 call one port int8 allreduce of X makes on
    the CPU, operands as they were at the call: ("q", src, index) and
    ("dq", q, s, n_valid, old, old_index, op)."""
    calls = []
    real_q, real_dq = ops.quantize_int8_at, ops.dequantize_int8_at

    def record_q(src, index):
        calls.append(("q", src.clone(), index))
        return real_q(src, index)

    def record_dq(q, s, n_valid, old, old_index, op="add", out=None,
                  out_dtype=None):
        calls.append(("dq", q.clone(), s.clone(), n_valid,
                      None if old is None else old.clone(),
                      old_index, op))
        return real_dq(q, s, n_valid, old, old_index, op, out, out_dtype)

    monkeypatch.setattr(ops, "quantize_int8_at", record_q)
    monkeypatch.setattr(ops, "dequantize_int8_at", record_dq)
    CollectiveEngine({"x": 8}, device="cpu").allreduce(
        X, "x", op=op, algorithm=algo, segments=segments, compression="int8")
    return calls


def _check_quantize_at(src, index):
    """ref.quantize_blocks_at == quantize of the gathered segments ==
    the reference's jnp codec per row, and its Pallas kernel (interpret
    mode) on the first row's blocks; bitwise."""
    q, s = ref.quantize_blocks_at(src, index)
    g = tengine._gather(src, index)
    g = g.reshape(-1, g.shape[2])
    rq, rs = ref.quantize_blocks(g)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    jdt = "bfloat16" if g.dtype == torch.bfloat16 else "float32"
    jq, js = _jnp_compress(_np(g), jdt)
    assert np.array_equal(q.numpy(), jq) and np.array_equal(s.numpy(), js)
    # the Pallas wrapper zero-pads to 32768: the same blocks, then more
    pq, ps = jops.quantize_int8(jnp.asarray(_np(g[0])).astype(jdt))
    assert np.array_equal(q[0].numpy(), np.asarray(pq)[:q.shape[1]])
    assert np.array_equal(s[0].numpy(), np.asarray(ps)[:s.shape[1]])
    return q, s


def _check_dequantize_at(q, s, n, old, old_index, op):
    """ref.dequantize_blocks_at == dequantize into the gathered target ==
    the reference's jnp decompress + combine per row; the first row's
    dequantize == the reference's Pallas kernel (interpret mode); all
    bitwise."""
    got = ref.dequantize_blocks_at(q, s, n, old, old_index, op)
    k, ranks = old_index[2].shape[:2]
    assert tuple(got.shape) == (k, ranks, n) and got.dtype == old.dtype
    g = tengine._gather(old, old_index).reshape(k * ranks, n)
    want = ref.dequantize_blocks(q, s, n, old=None if op == "copy" else g,
                                 op=op, out_dtype=old.dtype)
    assert torch.equal(got.reshape(k * ranks, n), want)
    jdt = jnp.bfloat16 if old.dtype == torch.bfloat16 else jnp.float32
    pal = jops.dequantize_int8(jnp.pad(jnp.asarray(q[0].numpy()),
                                       (0, 32768 - q.shape[1])),
                               jnp.pad(jnp.asarray(s[0].numpy()),
                                       (0, 128 - s.shape[1])))
    assert np.array_equal(ref.dequantize_blocks(q[:1], s[:1], n)[0].numpy(),
                          np.asarray(pal)[:n])
    if op == "copy":
        for r in range(q.shape[0]):
            c = jplugins.Compressed(jnp.asarray(q[r].numpy()),
                                    jnp.asarray(s[r].numpy()))
            jw = jplugins.int8_decompress(c, (n,), jdt)
            assert np.array_equal(_np(got.reshape(-1, n)[r]), _j2np(jw))
    else:
        jw = _jnp_consume(q, s, _np(g), n, op, jdt)
        assert np.array_equal(_np(got.reshape(-1, n)), jw)
    return got


_LAYOUTS = {"aligned": (8, 1024), "ragged": (8, 40, 3),
            "segmented": (8, 8192)}


@pytest.mark.parametrize("layout", list(_LAYOUTS))
@pytest.mark.parametrize("segments", [1, 4])
@pytest.mark.parametrize("algo", ["ring", "bidi_ring", "halving_doubling"])
def test_k2_k3_at_plain_versions_are_gather_then_codec(monkeypatch, algo,
                                                       segments, layout):
    """The indexed K2/K3 calls of a real int8 allreduce: one of each per
    compressed exchange, each plain version equal to the contiguous one
    on the gathered operands, to the reference's jnp codec and to its
    Pallas kernels (interpret mode); bitwise. The ragged layout's rows
    are short of one block (k = 1), its units 15 elements where the
    algorithm cuts 8 chunks; the segmented one has k > 1 with
    segments=4."""
    X = torch.from_numpy(_mixed(_LAYOUTS[layout], seed=22))
    calls = _recorded_codec_calls(monkeypatch, algo, segments, X)
    kinds = [c[0] for c in calls]
    assert kinds and kinds == ["q", "dq"] * (len(calls) // 2)
    ks = {c[2][2].shape[0] for c in calls if c[0] == "q"}
    if segments > 1 and layout == "segmented":
        assert max(ks) > 1, ks
    if layout == "ragged":      # k = 1 rows of 8-120 elements
        assert ks == {1}
        if algo != "bidi_ring":  # its 16 chunks pad the row to 8 each
            assert 15 in {c[2][0] for c in calls if c[0] == "q"}
    for i in sorted({0, len(calls) - 2}):
        (_, src, pay), (_, q, s, n, old, tgt, op) = calls[i], calls[i + 1]
        wq, ws = _check_quantize_at(src, pay)
        assert torch.equal(q, wq) and torch.equal(s, ws)
        _check_dequantize_at(q, s, n, old, tgt, op)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["add", "max", "min", "mul", "copy"])
def test_k2_k3_at_every_op(monkeypatch, op, dtype):
    """Every consume op and dtype through the indexed entry points of
    ops, on a segmented ring program's regions, against the reference's
    jnp codec; 'copy' with and without `old`."""
    X = torch.from_numpy(_mixed((8, 8192), seed=23)).to(getattr(torch, dtype))
    calls = _recorded_codec_calls(monkeypatch, "ring", 4,
                                  X, op="add" if op == "copy" else op)
    (_, src, pay), (_, _q, _s, n, old, tgt, rec_op) = calls[0], calls[1]
    assert rec_op == ("add" if op == "copy" else op)
    assert pay[2].shape[0] == 4
    q, s = ops.quantize_int8_at(src, pay)
    got = ops.dequantize_int8_at(q, s, n, old, tgt, op)
    assert torch.equal(got, _check_dequantize_at(q, s, n, old, tgt, op))
    out = torch.empty_like(got)
    assert ops.dequantize_int8_at(q, s, n, old, tgt, op, out=out) is out
    assert torch.equal(out, got)
    if op == "copy":
        bare = ops.dequantize_int8_at(q, s, n, None, tgt, "copy",
                                      out_dtype=old.dtype)
        assert torch.equal(bare, got)


@pytest.mark.parametrize("shape", [(8, 2048), (8, 120)])
@pytest.mark.parametrize("segments", [1, 4])
def test_int8_relay_program_matches_jax(monkeypatch, shape, segments):
    """A relay='received' program (the ring reduce) with the int8 codec:
    the port's executor quantizes each exchange in place, takes its raw
    arrivals from one contiguous K3 copy of the wire, and equals the JAX
    engine's executor bitwise."""
    from jax.sharding import PartitionSpec as P

    from repro.core import algorithms as jalgo
    from repro.core import engine as jengine
    from repro.core.topology import Communicator as JComm
    from repro.core.topology import make_mesh
    from repro_torch.core import algorithms as talgo
    from repro_torch.core.topology import Communicator as TComm
    X = _mixed(shape, seed=24)
    jprog = jalgo.ring_reduce(JComm(axis="x", size=8)).with_segments(
        segments).compile(codec="int8")
    tprog = talgo.ring_reduce(TComm(axis="x", size=8)).with_segments(
        segments).compile(codec="int8")
    assert tprog.relay == "received"
    mesh = make_mesh((8,), ("x",))
    run = jax.jit(jax.shard_map(
        lambda v: jengine.execute_program(jprog, v[0], "x")[None], mesh=mesh,
        in_specs=P("x"), out_specs=P("x"), check_vma=False))
    want = np.asarray(run(jnp.asarray(X)))
    seen = {"at": 0, "copy": 0}
    real_q, real_dq = ops.quantize_int8_at, ops.dequantize_int8
    monkeypatch.setattr(ops, "quantize_int8_at", lambda *a: (
        seen.__setitem__("at", seen["at"] + 1), real_q(*a))[1])
    monkeypatch.setattr(ops, "dequantize_int8", lambda *a, **kw: (
        seen.__setitem__("copy", seen["copy"] + 1), real_dq(*a, **kw))[1])
    got = tengine.execute_program(tprog, torch.from_numpy(X)).numpy()
    assert np.array_equal(got, want)
    assert seen["at"] == seen["copy"] == 7


# -- K4: tiled matmul, K5: embedding gather -------------------------------------

@pytest.mark.parametrize("m,k,n", [(300, 200, 100), (512, 512, 512),
                                   (64, 384, 128), (1, 128, 1),
                                   (257, 129, 65)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_matches_pallas_interpret(m, k, n, dtype):
    """The shapes and tolerances of the reference's own
    tests/test_kernels.py::test_matmul."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(m, k)).astype(np.float32)
    y = rng.normal(size=(k, n)).astype(np.float32)
    want = jops.matmul(jnp.asarray(x).astype(dtype),
                       jnp.asarray(y).astype(dtype))
    got = ops.matmul(torch.from_numpy(x).to(getattr(torch, dtype)),
                     torch.from_numpy(y).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and got.shape == (m, n)
    np.testing.assert_allclose(_np(got), _j2np(want),
                               atol=2e-2 if dtype != "float32" else 1e-3,
                               rtol=2e-2)


def test_k4_batched_equals_per_entry():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(2, 3, 5, 7)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(2, 3, 7, 4)).astype(np.float32))
    got = ops.matmul(x, y, out_dtype=torch.bfloat16)
    assert got.shape == (2, 3, 5, 4) and got.dtype == torch.bfloat16
    for i in range(2):
        for j in range(3):
            assert torch.equal(got[i, j], ref.matmul(x[i, j], y[i, j],
                                                     torch.bfloat16))


@pytest.mark.parametrize("v,d,b", [(100, 32, 16), (1000, 96, 64),
                                   (37, 128, 5)])
def test_k5_matches_pallas_interpret(v, d, b):
    """The shapes of the reference's own
    tests/test_kernels.py::test_embedding_gather, bitwise."""
    rng = np.random.default_rng(8)
    table = rng.normal(size=(v, d)).astype(np.float32)
    idx = rng.integers(0, v, size=(b,)).astype(np.int32)
    want = jops.embedding_gather(jnp.asarray(table), jnp.asarray(idx))
    got = ops.embedding_gather(torch.from_numpy(table), torch.from_numpy(idx))
    assert np.array_equal(_np(got), _j2np(want))


def test_k5_stacked_tables():
    rng = np.random.default_rng(9)
    tables = torch.from_numpy(rng.normal(size=(6, 50, 32)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 50, (6, 9)).astype(np.int32))
    got = ops.embedding_gather(tables, idx)
    assert got.shape == (6, 9, 32)
    for g in range(6):
        assert torch.equal(got[g], tables[g][idx[g].long()])


I32_MIN, I32_MAX = -2**31, 2**31 - 1


def lookup_edge_ids(los, rows_l, rows_total):
    """Ids at every shard edge (lo - 1, lo, lo + rows_l - 1, lo + rows_l
    of each rank), the first and last global rows, ids below 0 and past
    the last row, and the int32 extremes — wrapped into int32."""
    ids = [e for lo in los for e in (lo - 1, lo, lo + rows_l - 1,
                                     lo + rows_l)]
    ids += [0, rows_total - 1, -1, -rows_l, rows_total, I32_MIN, I32_MAX]
    return np.array(ids, dtype=np.int64).astype(np.int32)


def jax_rank_lookup(tables, ids, lo):
    """One rank's lookup as `repro/models/dlrm.py::embedding_lookup`
    computes it with `use_pallas`: int32 shift, hit mask, clip, the Pallas
    gather (interpret mode, D padded to 128 lanes as `repro.kernels.ops`
    pads it) per table, `jnp.where`, `jnp.moveaxis` — (T, rows_l, D)
    tables, (B, T) int32 ids -> (B, T*D)."""
    t, rows_l, dim = tables.shape
    local = jnp.asarray(ids).T - jnp.asarray(np.int32(lo))
    hit = (local >= 0) & (local < rows_l)
    safe = jnp.clip(local, 0, rows_l - 1)
    padded = jnp.pad(jnp.asarray(tables), ((0, 0), (0, 0), (0, 128 - dim)))
    rows = jnp.stack([jeg.gather_rows(padded[i], safe[i], interpret=True)
                      for i in range(t)])[..., :dim]
    rows = jnp.where(hit[..., None], rows, 0.0)
    return jnp.moveaxis(rows, 0, 1).reshape(ids.shape[0], t * dim)


_LOS = {
    "mesh": lambda g, rows_l: g * rows_l,          # each rank's first row
    "zero": lambda g, rows_l: 0,
    "negative": lambda g, rows_l: -3 * rows_l + 7 * g,
    "int32_wrap": lambda g, rows_l: I32_MAX - 5 - g * rows_l,
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("los", list(_LOS))
def test_k5_lookup_rows_matches_jax_lookup(los, dtype):
    """ref.lookup_rows, every stacked rank at once, equals the reference
    lookup body per rank BITWISE, shard edges, misses and int32
    wrap-around included; ids given as a stride-0 expand give the same."""
    rng = np.random.default_rng(10)
    G, T, rows_l, D, B = 3, 4, 20, 32, 12
    los_g = [_LOS[los](g, rows_l) for g in range(G)]
    tables = rng.normal(size=(G, T, rows_l, D)).astype(np.float32)
    ids = rng.integers(-rows_l, (G + 1) * rows_l, (B, T)).astype(np.int32)
    edges = lookup_edge_ids(los_g, rows_l, G * rows_l)
    ids.reshape(-1)[:len(edges)] = edges
    jt = jnp.asarray(tables).astype(dtype)
    want = np.stack([_j2np(jax_rank_lookup(jt[g], ids, los_g[g]))
                     for g in range(G)])
    tt = torch.from_numpy(tables).to(getattr(torch, dtype))
    lo = torch.tensor(los_g, dtype=torch.int64)
    shared = torch.from_numpy(ids)[None].expand(G, B, T)
    for ids_t in (shared, shared.contiguous()):
        got = ops.embedding_lookup_rows(tt, ids_t, lo)
        assert got.shape == (G, B, T * D) and got.dtype == tt.dtype
        assert np.array_equal(_np(got), want)
    hits = want.reshape(G, B, T, D).any(-1).sum()
    assert 0 < hits < G * B * T


def test_k5_lookup_rows_is_the_gather_sequence():
    """The plain lookup equals gather_rows of the clipped shifted ids with
    the misses zeroed, laid out (g, b, t): the definition, spelled out."""
    rng = np.random.default_rng(11)
    G, T, rows_l, D, B = 2, 3, 10, 5, 7
    tables = torch.from_numpy(rng.normal(size=(G, T, rows_l, D)).astype(
        np.float32))
    ids = torch.from_numpy(rng.integers(-5, 25, (G, B, T)).astype(np.int32))
    lo = torch.tensor([0, rows_l])
    got = ops.embedding_lookup_rows(tables, ids, lo)
    for g in range(G):
        for b in range(B):
            for t in range(T):
                local = int(ids[g, b, t]) - int(lo[g])
                want = tables[g, t, local] if 0 <= local < rows_l else \
                    torch.zeros(D)
                assert torch.equal(got[g, b, t * D:(t + 1) * D], want)


# -- wrappers, devices and imports ---------------------------------------------

def test_cpu_tensors_take_the_plain_version():
    x = torch.ones(4, 300)
    ops.reset_launch_counts()
    assert torch.equal(ops.fused_combine(x, x, "add"), 2 * x)
    q, s = ops.quantize_int8(x)
    ops.dequantize_int8(q, s, 300)
    assert torch.equal(ops.matmul(x, x.T), torch.full((4, 4), 300.0))
    assert torch.equal(ops.embedding_gather(x, torch.zeros(2, dtype=torch.int32)),
                       x[:2])
    tgt = tengine._region_index((0, 1, 2, 3), (((0, 300),),) * 4, 3, "cpu")
    assert torch.equal(ops.fused_combine_at(x, tgt, x, tgt, "add"),
                       2 * x.reshape(4, 3, 100).transpose(0, 1))
    q8, s8 = ops.quantize_int8_at(x, tgt)
    assert tuple(q8.shape) == (12, 256) and tuple(s8.shape) == (12, 1)
    assert torch.equal(ops.dequantize_int8_at(q8, s8, 100, x, tgt, "add"),
                       torch.full((3, 4, 100), 2.0))
    lookup = ops.embedding_lookup_rows(x.reshape(1, 1, 4, 300),
                                       torch.tensor([[[-1], [5]]],
                                                    dtype=torch.int32),
                                       torch.tensor([2]))
    assert torch.equal(lookup, torch.stack([torch.zeros(300), x[3]])[None])
    assert torch.equal(ops.region_copy(x, tgt, torch.zeros(4, 300), tgt), x)
    assert ops.launch_counts() == {"fused_combine": 0, "quantize_blocks": 0,
                                   "dequantize_blocks": 0, "matmul_tiled": 0,
                                   "gather_rows": 0, "region_copy": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        fused_reduce.fused_combine(torch.ones(4), torch.ones(4))
    tgt = tengine._region_index((0,), (((0, 4),),), 1, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        fused_reduce.fused_combine_at(torch.ones(1, 4), tgt,
                                      torch.ones(1, 4), tgt)
    with pytest.raises(ValueError, match="CUDA"):
        quantize.quantize_blocks_at(torch.ones(1, 4), tgt)
    with pytest.raises(ValueError, match="CUDA"):
        quantize.dequantize_blocks_at(torch.zeros(1, 256, dtype=torch.int8),
                                      torch.ones(1, 1), 4, torch.ones(1, 4),
                                      tgt)
    with pytest.raises(ValueError, match="CUDA"):
        matmul.matmul_tiled(torch.ones(1, 2, 2), torch.ones(1, 2, 2))
    with pytest.raises(ValueError, match="CUDA"):
        embedding_gather.gather_rows(torch.ones(1, 4, 2),
                                     torch.zeros(1, 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        embedding_gather.lookup_rows(torch.ones(1, 1, 4, 2),
                                     torch.zeros(1, 1, 1, dtype=torch.int32),
                                     torch.zeros(1, dtype=torch.int64))


def test_port_imports_neither_jax_nor_repro():
    """Every repro_torch module imports in a fresh process without
    loading jax or the reference package."""
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "import repro_torch.core.engine\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))"
    )
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env=dict(os.environ))
    assert int(out.stdout.strip()) >= 15
