"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one (decided in
the `card` fixture, never at import). Imports torch and the port only, so
it runs on a machine without jax:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import ParallelConfig, reduced
from repro_torch.core import CollectiveEngine, Sequencer
from repro_torch.core import engine as engine_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import embedding_gather, fused_reduce, matmul, \
    quantize, ssd_scan
from repro_torch.launch import distributed_vecmat
from repro_torch.launch.dlrm_serve import DLRMServer
from repro_torch.models import dlrm
from repro_torch.models.common import Builder
from repro_torch.parallel import ParCtx


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    # the plain fp32 products K4 is held to run in IEEE fp32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, seed, device, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(device=device, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["add", "max", "min", "mul"])
def test_k1_bitwise(card, op, dtype):
    a = _randn((8, 5000), 0, card, dtype)
    b = _randn((8, 5000), 1, card, dtype)
    before = fused_reduce.fused_combine.launches
    got = ops.fused_combine(a, b, op)
    assert fused_reduce.fused_combine.launches == before + 1
    assert torch.equal(got, ref.fused_combine(a, b, op))
    tail = ops.fused_combine(a.reshape(-1)[1:], b.reshape(-1)[:-1], op,
                             out_dtype=torch.float32)
    assert torch.equal(tail, ref.fused_combine(
        a.reshape(-1)[1:], b.reshape(-1)[:-1], op, torch.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [32768, 1000])
def test_k2_k3_bitwise(card, dtype, n):
    x = _randn((8, n), 2, card) * torch.exp(2 * _randn((8, n), 3, card))
    x = x.to(dtype)
    q, s = ops.quantize_int8(x)
    rq, rs = ref.quantize_blocks(x)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    old = _randn((8, n), 4, card, dtype)
    for op in ("copy", "add", "max", "mul"):
        kw = {} if op == "copy" else {"old": old}
        got = ops.dequantize_int8(q, s, n, op=op, out_dtype=dtype, **kw)
        want = ref.dequantize_blocks(q, s, n, op=op, out_dtype=dtype, **kw)
        assert torch.equal(got, want), op


def _ring_index(L, width, k, step, device, rows=8, spans=1):
    """Target and payload indices of ring step `step` over a (rows, L,
    width) buffer in `rows` chunks: rank d combines chunk (d - 1 - step)
    of rank d - 1 into its own — as `engine._run_exchange` builds them.
    With spans=2 each rank's region is two chunks, 3 apart."""
    c = L // rows
    tgt = tuple(tuple((((d - 1 - step + 3 * s) % rows) * c, c)
                      for s in range(spans)) for d in range(rows))
    src = tuple((d - 1) % rows for d in range(rows))
    return (engine_mod._region_index(tuple(range(rows)), tgt, k, device),
            engine_mod._region_index(src, tgt, k, device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["add", "max", "min", "mul"])
@pytest.mark.parametrize("L,width,k,spans", [
    (8 * 256, 1, 4, 1), (8 * 15, 3, 3, 1), (8 * 40, 1, 1, 1),
    (8 * 64, 1, 32, 1), (8 * 48, 1, 1, 2), (8 * 10, 3, 1, 2)])
def test_k1_at_bitwise(card, op, dtype, L, width, k, spans):
    """The indexed K1 against its plain version, on 16-byte units and on
    unaligned ones (15 elements): one launch over all k segments."""
    a = _randn((8, L, width), 19, card, dtype)
    b = _randn((8, L, width), 20, card, dtype)
    tgt, pay = _ring_index(L, width, k, 2, card, spans=spans)
    before = fused_reduce.fused_combine.launches
    got = ops.fused_combine_at(a, tgt, b, pay, op)
    assert torch.equal(got, ref.fused_combine_at(a, tgt, b, pay, op))
    assert torch.equal(got, ref.fused_combine(
        engine_mod._gather(a, tgt), engine_mod._gather(b, pay), op))
    cast = ops.fused_combine_at(a, tgt, b, pay, op, out_dtype=torch.bfloat16)
    assert torch.equal(cast, ref.fused_combine_at(
        a, tgt, b, pay, op, torch.bfloat16))
    assert fused_reduce.fused_combine.launches == before + 2


def _unit_bytes(index, width, dtype) -> int:
    return int(index[0]) * width * torch.empty(0, dtype=dtype).element_size()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["add", "max", "min", "mul"])
@pytest.mark.parametrize("L,width,k,spans,vec", [
    (8 * 256, 1, 4, 1, True), (8 * 32 * 64, 1, 32, 1, True),
    (8 * 15, 3, 3, 1, False), (8 * 10, 3, 1, 2, False)])
def test_k1_at_in_place_bitwise(card, op, dtype, L, width, k, spans, vec):
    """K1 writing back through its target's own index, one launch over all
    k segments, against its plain version bitwise: on units that take the
    16-byte vectors and on units that refuse them (15 and 30 elements),
    with the payload in another buffer and in the target's own (a ring
    step reads chunks no rank writes)."""
    tgt, pay = _ring_index(L, width, k, 2, card, spans=spans)
    assert (_unit_bytes(tgt, width, dtype) % 16 == 0) == vec
    for own in (False, True):
        a = _randn((8, L, width), 27, card, dtype)
        b = a if own else _randn((8, L, width), 28, card, dtype)
        want = a.clone()
        ref.fused_combine_at(want, tgt, want if own else b, pay, op,
                             in_place=True)
        before = fused_reduce.fused_combine.launches
        got = ops.fused_combine_at(a, tgt, b, pay, op, in_place=True)
        assert fused_reduce.fused_combine.launches == before + 1
        assert got is a and torch.equal(a, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int64])
@pytest.mark.parametrize("L,width,k,spans,shift", [
    (8 * 256, 1, 4, 1, 0), (8 * 32 * 64, 1, 32, 1, 0), (8 * 15, 3, 3, 1, 0),
    (8 * 10, 3, 1, 2, 0), (8 * 256, 1, 4, 1, 1)])
def test_region_copy_bitwise(card, dtype, L, width, k, spans, shift):
    """The indexed copy, one launch over all k segments, against its plain
    version bitwise: 16-byte units, units of 15 and 30 elements (narrower
    words), a buffer that starts one element off 16 bytes (no vectors);
    from another buffer and within one (a ring step's payload and target
    chunks are disjoint)."""
    tgt, pay = _ring_index(L, width, k, 1, card, spans=spans)
    n = 8 * L * width

    def buf(seed):
        flat = torch.empty(n + shift, dtype=dtype, device=card)[shift:]
        flat.copy_((_randn((n,), seed, "cpu") * 100).to(dtype).to(card))
        return flat.view(8, L, width)

    for own in (False, True):
        dst = buf(29)
        src = dst if own else buf(30)
        want = dst.clone()
        ref.region_copy(want if own else src, pay, want, tgt)
        before = fused_reduce.region_copy.launches
        got = ops.region_copy(src, pay, dst, tgt)
        assert fused_reduce.region_copy.launches == before + 1
        assert got is dst and torch.equal(dst, want)


@pytest.mark.parametrize("coll,algo,segments,k1,copies", [
    ("allreduce", "bidi_ring", 32, 14, 14),
    ("allgather", "ring", 16, 0, 7),
    ("alltoall", "linear", 32, 0, 7),
    ("allreduce", "recursive_doubling", 1, 3, 0)])
def test_engine_in_place_on_card_equals_cpu(card, coll, algo, segments, k1,
                                            copies):
    """The programs of the benchmark's cells on the card, written in place
    (recursive doubling deferred), bitwise equal to the CPU's plain
    versions: one K1 launch a combining exchange, one indexed copy a copy
    exchange."""
    X = _randn((8, 8 * 2 * 32 * 48), 31, "cpu").to(torch.bfloat16)
    ops.reset_launch_counts()
    gpu = getattr(CollectiveEngine({"x": 8}), coll)(
        X.to(card), "x", algorithm=algo, segments=segments)
    counts = ops.launch_counts()
    assert (counts["fused_combine"], counts["region_copy"]) == (k1, copies)
    cpu = getattr(CollectiveEngine({"x": 8}, device="cpu"), coll)(
        X, "x", algorithm=algo, segments=segments)
    assert torch.equal(gpu.cpu(), cpu)


@pytest.mark.parametrize("op", ["add", "max"])
def test_engine_segments_32_on_card_equals_cpu(card, op):
    """A 32-segment allreduce through the indexed K1 on the card, bitwise
    equal to the plain versions on the CPU; 1 launch per combining
    exchange, over all its 32 segments."""
    X = _randn((8, 8 * 32 * 64), 21, "cpu")
    ops.reset_launch_counts()
    gpu = CollectiveEngine({"x": 8}).allreduce(X.to(card), "x", op=op,
                                               algorithm="ring", segments=32)
    assert ops.launch_counts()["fused_combine"] == 7
    cpu = CollectiveEngine({"x": 8}, device="cpu").allreduce(
        X, "x", op=op, algorithm="ring", segments=32)
    assert torch.equal(gpu.cpu(), cpu)


def test_wrappers_raise_on_bad_input(card):
    a = _randn((8, 64), 5, card)
    with pytest.raises(ValueError):
        fused_reduce.fused_combine(a.t(), a.t())          # not contiguous
    tgt, pay = _ring_index(64, 1, 2, 0, card)
    fused_reduce.fused_combine_at(a, tgt, a, pay)         # takes these
    with pytest.raises(ValueError):                       # index on the CPU
        fused_reduce.fused_combine_at(
            a, (tgt[0], tgt[1].cpu(), tgt[2].cpu()), a, pay)
    with pytest.raises(ValueError):                       # buffer on the CPU
        fused_reduce.fused_combine_at(a.cpu(), tgt, a, pay)
    with pytest.raises(ValueError):                       # int32 index
        fused_reduce.fused_combine_at(a, (tgt[0], tgt[1].int(), tgt[2]), a,
                                      pay)
    with pytest.raises(ValueError):                       # index shape
        fused_reduce.fused_combine_at(a, (tgt[0], tgt[1], tgt[2][:, :4]), a,
                                      pay)
    with pytest.raises(ValueError):                       # dtypes differ
        fused_reduce.fused_combine_at(a, tgt, a.to(torch.bfloat16), pay)
    with pytest.raises(ValueError):                       # one segment's out
        fused_reduce.fused_combine_at(a, tgt, a, pay,
                                      out=torch.empty(8, 4, device=card))
    with pytest.raises(TypeError):
        quantize.quantize_blocks(a.double())
    with pytest.raises(ValueError):
        quantize.dequantize_blocks(torch.zeros(8, 100, dtype=torch.int8,
                                               device=card),
                                   torch.zeros(8, 1, device=card), 100)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,width,k,spans", [
    (8 * 256 * 32, 1, 32, 1), (8 * 1000, 1, 1, 1), (8 * 15, 1, 1, 1),
    (8 * 5, 3, 1, 1), (8 * 48, 1, 1, 2), (8 * 256, 1, 1, 2),
    (8 * 2048, 1, 4, 2)])
def test_k2_k3_at_bitwise(card, dtype, L, width, k, spans):
    """The indexed K2 and K3 against their plain versions, one launch
    each per exchange, on 16-byte units (with and without a ragged last
    block, one or two units per rank and segment) and unaligned ones (15
    elements), k = 1 to 32, every op."""
    a = _randn((8, L, width), 22, card) * torch.exp(
        2 * _randn((8, L, width), 23, card))
    a = a.to(dtype)
    b = _randn((8, L, width), 24, card, dtype)
    tgt, pay = _ring_index(L, width, k, 1, card, spans=spans)
    assert pay[2].shape[0] == k
    before = quantize.quantize_blocks.launches
    q, s = ops.quantize_int8_at(a, pay)
    assert quantize.quantize_blocks.launches == before + 1
    rq, rs = ref.quantize_blocks_at(a, pay)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    n = ref.gather_regions(a, pay).shape[2]
    before = quantize.dequantize_blocks.launches
    for op in ("copy", "add", "max", "min", "mul"):
        got = ops.dequantize_int8_at(q, s, n, b, tgt, op)
        assert torch.equal(got, ref.dequantize_blocks_at(q, s, n, b, tgt,
                                                         op)), op
    assert quantize.dequantize_blocks.launches == before + 5


def test_engine_int8_one_launch_per_exchange(card):
    """A 32-segment int8 ring allreduce: one K2 and one K3 launch per
    compressed exchange (7), bitwise equal to the plain versions on the
    CPU."""
    X = _randn((8, 8 * 32 * 256), 25, "cpu")
    ops.reset_launch_counts()
    gpu = CollectiveEngine({"x": 8}).allreduce(
        X.to(card), "x", algorithm="ring", segments=32, compression="int8")
    counts = ops.launch_counts()
    assert counts["quantize_blocks"] == counts["dequantize_blocks"] == 7
    cpu = CollectiveEngine({"x": 8}, device="cpu").allreduce(
        X, "x", algorithm="ring", segments=32, compression="int8")
    assert torch.equal(gpu.cpu(), cpu)


def test_k2_k3_at_raise_on_bad_input(card):
    a = _randn((8, 8 * 256), 26, card)
    tgt, pay = _ring_index(8 * 256, 1, 1, 0, card)
    q, s = quantize.quantize_blocks_at(a, pay)            # takes these
    quantize.dequantize_blocks_at(q, s, 256, a, tgt, "add")
    cpu_idx = (pay[0], pay[1].cpu(), pay[2].cpu())
    with pytest.raises(ValueError):                       # index on the CPU
        quantize.quantize_blocks_at(a, cpu_idx)
    with pytest.raises(ValueError):
        quantize.dequantize_blocks_at(q, s, 256, a, cpu_idx, "add")
    with pytest.raises(ValueError):                       # buffer on the CPU
        quantize.quantize_blocks_at(a.cpu(), pay)
    with pytest.raises(ValueError):                       # 4 rows, not 8
        quantize.dequantize_blocks_at(q[:4], s[:4], 256, a, tgt, "add")
    with pytest.raises(ValueError):                       # wrong n_valid
        quantize.dequantize_blocks_at(q, s, 200, a, tgt, "add")
    with pytest.raises(ValueError):                       # out inside a
        quantize.dequantize_blocks_at(q, s, 256, a, tgt, "add",
                                      out=a.reshape(-1)[:8 * 256].view(1, 8, 256))
    with pytest.raises(ValueError):                       # add needs old
        quantize.dequantize_blocks_at(q, s, 256, None, tgt, "add")
    with pytest.raises(TypeError):
        quantize.quantize_blocks_at(a.double(), pay)


@pytest.mark.parametrize("codec", [None, "int8"])
def test_engine_on_card_equals_cpu(card, codec):
    X = _randn((8, 4096 * 3), 6, "cpu")
    gpu = CollectiveEngine({"x": 8}).allreduce(
        X.to(card), "x", compression=codec, segments=4)
    cpu = CollectiveEngine({"x": 8}, device="cpu").allreduce(
        X, "x", compression=codec, segments=4)
    assert torch.equal(gpu.cpu(), cpu)


def k4_bound(x, y):
    """Per-element bound on the distance between two fp32 sums of the
    same K products in different orders: 2 K 2^-24 (|x| @ |y|)."""
    return 2 * x.shape[-1] * 2.0 ** -24 * (x.double().abs()
                                           @ y.double().abs())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (1, 257, 129, 65), (1, 1, 128, 1), (8, 32, 400, 2048), (8, 70, 33, 130),
    # both configurations and their edges, aligned (K, N % 4 == 0) or not
    (2, 1, 400, 256), (2, 32, 64, 132), (2, 33, 400, 200), (2, 64, 16, 64),
    (2, 65, 400, 256), (1, 2048, 400, 2048), (2, 1, 37, 130),
    (2, 33, 41, 66), (2, 64, 3, 7), (2, 65, 130, 131), (1, 2048, 131, 65)])
def test_k4_within_bound(card, shape, dtype):
    G, M, K, N = shape
    x = _randn((G, M, K), 7, card, dtype)
    y = _randn((G, K, N), 8, card, dtype)
    before = matmul.matmul_tiled.launches
    got = ops.matmul(x, y, out_dtype=torch.float32)
    assert matmul.matmul_tiled.launches == before + 1
    want = ref.matmul(x, y, torch.float32)
    assert got.shape == (G, M, N)
    assert bool(((got.double() - want.double()).abs()
                 <= k4_bound(x, y)).all())
    if dtype == torch.bfloat16:        # the reference's bf16 tolerance
        got16 = ops.matmul(x, y)
        assert got16.dtype == torch.bfloat16
        torch.testing.assert_close(got16.float(), want, atol=2e-2, rtol=2e-2)
    if G == 1:                          # the unbatched 2-D form
        assert torch.equal(ops.matmul(x[0], y[0], torch.float32), got[0])


def test_k5_bitwise_beyond_2_31_elements(card):
    """A (2, 33.6M, 32) fp32 stack holds 2.15e9 elements (8.6 GB): the
    second table's rows and the last row lie past 2^31 elements."""
    V = 33_600_000
    tables = torch.empty((2, V, 32), device=card)
    tables.normal_(generator=torch.Generator(card).manual_seed(9))
    assert tables.numel() > 2 ** 31
    g = torch.Generator(card).manual_seed(10)
    idx = torch.randint(0, V, (2, 1000), generator=g, device=card,
                        dtype=torch.int32)
    idx[:, -1] = V - 1
    got = ops.embedding_gather(tables, idx)
    assert torch.equal(got, ref.gather_rows(tables, idx))
    assert torch.equal(got[1, -1], tables[1, V - 1])
    del tables


@pytest.mark.parametrize("D,dtype", [(32, torch.float32), (96, torch.float32),
                                     (3, torch.float32), (5, torch.bfloat16)])
def test_k5_bitwise_row_widths(card, D, dtype):
    """16-byte rows down to 2-byte units, batched and unbatched."""
    tables = _randn((6, 500, D), 11, card, dtype)
    g = torch.Generator(card).manual_seed(12)
    idx = torch.randint(0, 500, (6, 77), generator=g, device=card,
                        dtype=torch.int32)
    before = embedding_gather.gather_rows.launches
    assert torch.equal(ops.embedding_gather(tables, idx),
                       ref.gather_rows(tables, idx))
    assert torch.equal(ops.embedding_gather(tables[2], idx[2]),
                       tables[2][idx[2].long()])
    assert embedding_gather.gather_rows.launches == before + 2


def _lookup_case(G, T, rows_l, D, B, dtype, device, seed, lo=None):
    """Tables, stride-0 ids (one request batch shared by the G ranks, as
    `stack_batch` gives them) and the mesh's `lo`, with ids at every shard
    edge, below 0, past the last row and at the int32 extremes."""
    rng = np.random.default_rng(seed)
    tables = _randn((G, T, rows_l, D), seed, device, dtype)
    lo = [g * rows_l for g in range(G)] if lo is None else lo
    ids = rng.integers(-rows_l, (G + 1) * rows_l, (B, T))
    edges = [e for x in lo for e in (x - 1, x, x + rows_l - 1, x + rows_l)]
    edges += [0, G * rows_l - 1, -1, G * rows_l, -2**31, 2**31 - 1]
    n = min(len(edges), ids.size)
    ids.reshape(-1)[:n] = edges[:n]
    ids = torch.from_numpy(ids.astype(np.int32)).to(device)
    return (tables, ids[None].expand(G, B, T),
            torch.tensor(lo, dtype=torch.int64, device=device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 1, 3, 33])
def test_k5_lookup_and_gather_bitwise(card, D, dtype):
    """lookup_rows and the redesigned gather_rows BITWISE against their
    plain versions, 16-byte rows down to 2-byte units, one K5 launch
    each; stride-0 ids read in place."""
    tables, ids, lo = _lookup_case(3, 5, 40, D, 17, dtype, card, 20)
    before = embedding_gather.gather_rows.launches
    got = ops.embedding_lookup_rows(tables, ids, lo)
    assert embedding_gather.gather_rows.launches == before + 1
    assert torch.equal(got, ref.lookup_rows(tables, ids, lo))
    assert torch.equal(got, ref.lookup_rows(tables.cpu(), ids.cpu(),
                                            lo.cpu()).to(card))
    flat = tables.reshape(15, 40, D)
    idx = torch.randint(0, 40, (15, 33), device=card, dtype=torch.int32,
                        generator=torch.Generator(card).manual_seed(21))
    assert torch.equal(ops.embedding_gather(flat, idx),
                       ref.gather_rows(flat, idx))


def test_k5_unaligned_empty_and_extreme_ranks(card):
    """An unaligned table base (4-byte units for 128-byte rows), B = 0 (no
    launch), a rank that misses every id and one that hits every id."""
    G, T, rows_l, D = 2, 3, 50, 32
    buf = _randn((G * T * rows_l * D + 1,), 22, card)
    tables = buf[1:].view(G, T, rows_l, D)
    assert tables.data_ptr() % 16 == 4
    ids = torch.randint(0, rows_l, (1, 64, T), device=card, dtype=torch.int32,
                        generator=torch.Generator(card).manual_seed(23))
    ids = ids.expand(G, 64, T)
    lo = torch.tensor([10**6, 0], dtype=torch.int64, device=card)
    got = embedding_gather.lookup_rows(tables, ids, lo)
    assert torch.equal(got, ref.lookup_rows(tables, ids, lo))
    assert not got[0].any()                               # all miss
    assert torch.equal(got[1].reshape(64, T, D),          # all hit
                       tables[1, torch.arange(T, device=card), ids[1].long()])
    idx = ids[1].T.contiguous()
    assert torch.equal(embedding_gather.gather_rows(tables[1], idx),
                       ref.gather_rows(tables[1], idx))
    before = embedding_gather.gather_rows.launches
    empty = embedding_gather.lookup_rows(tables, ids[:, :0], lo)
    assert empty.shape == (G, 0, T * D)
    assert embedding_gather.gather_rows(tables[1], idx[:, :0]).shape == \
        (T, 0, D)
    assert embedding_gather.gather_rows.launches == before


def test_k5_table_offsets_past_2_31_elements(card):
    """Rows more than 2^31 elements (and units) past the base of the table
    stack: 64-bit offsets in both entry points."""
    rows_l = 2**30 + 64
    tables = torch.empty((1, 2, rows_l, 1), device=card)   # 8.6 GB
    tail = _randn((200,), 24, card)
    tables[0, 1, -200:, 0] = tail
    ids = torch.arange(rows_l - 150, rows_l + 3, device=card,
                       dtype=torch.int32)
    ids = torch.stack([ids, ids], dim=1)[None]       # (1, 153, 2)
    ids[0, :, 0] = rows_l                            # table 0: all miss
    lo = torch.zeros(1, dtype=torch.int64, device=card)
    got = embedding_gather.lookup_rows(tables, ids, lo)
    want = torch.cat([tail[50:], torch.zeros(3, device=card)])
    assert torch.equal(got[0, :, 1], want) and not got[0, :, 0].any()
    idx = torch.stack([ids[0, :150, 1] - rows_l + 150, ids[0, :150, 1]])
    got = embedding_gather.gather_rows(tables.view(2, rows_l, 1), idx)
    assert torch.equal(got[1].reshape(-1), tail[50:])
    del tables


def test_k5_lookup_raises_on_bad_input(card):
    tables = _randn((2, 3, 10, 4), 25, card)
    ids = torch.zeros((2, 5, 3), dtype=torch.int32, device=card)
    lo = torch.zeros(2, dtype=torch.int64, device=card)
    with pytest.raises(TypeError):
        embedding_gather.lookup_rows(tables, ids.long(), lo)
    with pytest.raises(TypeError):
        embedding_gather.lookup_rows(tables, ids, lo.int())
    with pytest.raises(ValueError, match="CUDA"):
        embedding_gather.lookup_rows(tables, ids, lo.cpu())   # mixed
    with pytest.raises(ValueError):
        embedding_gather.lookup_rows(tables, ids[:, :, :2], lo)
    with pytest.raises(ValueError):
        embedding_gather.lookup_rows(tables, ids, lo[:1])
    with pytest.raises(ValueError):
        embedding_gather.lookup_rows(tables.transpose(2, 3), ids, lo)
    with pytest.raises(ValueError):
        embedding_gather.lookup_rows(tables[0], ids[0], lo)


def test_k4_k5_wrappers_raise_on_bad_input(card):
    x = _randn((1, 4, 8), 13, card)
    xt = x.transpose(1, 2)
    with pytest.raises(TypeError):
        matmul.matmul_tiled(x, xt.contiguous().double())
    with pytest.raises(ValueError):
        matmul.matmul_tiled(x, xt)                      # not contiguous
    with pytest.raises(ValueError):
        matmul.matmul_tiled(x, x)                       # shapes do not chain
    with pytest.raises(ValueError):
        matmul.matmul_tiled(x[0], xt[0].contiguous())   # not batched
    with pytest.raises(TypeError):
        matmul.matmul_tiled(x.double(), xt.contiguous().double())
    table = _randn((1, 10, 4), 14, card)
    with pytest.raises(TypeError):
        embedding_gather.gather_rows(table, torch.zeros(
            (1, 3), dtype=torch.int64, device=card))
    with pytest.raises(ValueError):
        embedding_gather.gather_rows(table.transpose(1, 2), torch.zeros(
            (1, 3), dtype=torch.int32, device=card))
    with pytest.raises(ValueError):
        embedding_gather.gather_rows(table, torch.zeros(
            (2, 3), dtype=torch.int32, device=card))


def _reduced_params(mesh_shape, device):
    gen = torch.Generator().manual_seed(15)
    b = Builder("init", generator=gen, mesh_shape=mesh_shape)
    params = dlrm.dlrm_params(b, reduced(), mesh_shape["model"])
    return {"tables": params["tables"].to(device),
            "fc": [{k: v.to(device) for k, v in fc.items()}
                   for fc in params["fc"]]}


def test_embedding_lookup_on_card_equals_cpu(card):
    ms = {"pod": 1, "data": 2, "model": 4}
    cfg = reduced()
    idx = torch.from_numpy(np.random.default_rng(16).integers(
        0, cfg.rows_per_table, (16, cfg.n_tables)).astype(np.int32))
    outs = {}
    for dev in ("cpu", card):
        ctx = ParCtx(engine=CollectiveEngine(ms, device=dev),
                     pcfg=ParallelConfig())
        params = _reduced_params(ms, dev)
        stacked = dlrm.stack_batch(idx.to(dev), ms)
        ops.reset_launch_counts()
        outs[str(dev)] = dlrm.embedding_lookup(params["tables"], stacked,
                                               ctx).cpu()
        # one K5 launch per lookup on the card, none on the CPU
        assert ops.launch_counts()["gather_rows"] == (dev == card)
    assert torch.equal(outs["cuda"], outs["cpu"])


@pytest.mark.parametrize("collective_matmul", [False, True])
def test_dlrm_server_on_card(card, collective_matmul):
    """The server on the card: K4 and K5 launch on every batch; logits
    within 1e-5 of the float64 single-copy reference."""
    cfg = reduced()
    server = DLRMServer(cfg, pcfg=ParallelConfig(
        collective_matmul=collective_matmul), seed=17)
    idx = torch.randint(0, cfg.rows_per_table, (16, cfg.n_tables),
                        generator=torch.Generator().manual_seed(18),
                        dtype=torch.int32)
    ops.reset_launch_counts()
    out = server(idx)
    counts = ops.launch_counts()
    assert counts["gather_rows"] == 1
    assert counts["matmul_tiled"] == (1 if collective_matmul else 0)
    want = server.reference(idx, dtype=torch.float64)
    torch.testing.assert_close(out.double(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(server.lookup(idx), dlrm.lookup_shards(
        server.tables_copy(), idx.to(card)))


def _ints(shape, seed, device):
    """Integer-valued fp32: every 8-rank sum is exact."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-8, 9, shape, generator=g).float().to(device)


def test_queue_drain_on_card_equals_blocking(card):
    """The mixed queue of `chip_smoke.py` phase 7b, smaller: three
    coalescing allreduces, an int8 allreduce, a reduce consuming another
    request and an issue_multi over (2, 4), drained on the card — bitwise
    equal to the blocking calls; the non-int8 requests bitwise equal to
    `simulate_drain` of the same queue; one coalesced program."""
    eng = CollectiveEngine({"x": 8})
    eng2 = CollectiveEngine({"pod": 2, "data": 4})
    small = [_ints((8, n), 30 + n, card) for n in (40, 8, 24)]
    mid, big = _ints((8, 4096), 31, card), _ints((8, 1 << 16), 32, card)
    X2 = _ints((2, 4, 1000), 33, card)

    def issue(seq):
        rs = [seq.issue("allreduce", v, "x") for v in small]
        r_mid = seq.issue("allreduce", mid, "x")
        return rs + [r_mid, seq.issue("reduce", r_mid, "x", root=2,
                                      algorithm="binomial_tree")]

    reqs = issue(eng.queue)
    r8 = eng.iallreduce(big, "x", compression="int8")
    rm = eng2.issue_multi(X2, ["data", "pod"])
    eng.queue.drain()
    eng2.queue.drain()
    assert eng.queue.stats["coalesced_buckets"] == 1
    b_mid = eng.allreduce(mid, "x")
    want = [eng.allreduce(v, "x") for v in small] + [
        b_mid, eng.reduce(b_mid, "x", root=2, algorithm="binomial_tree")]
    for r, w in zip(reqs, want):
        assert torch.equal(r.result, w)
    assert torch.equal(r8.result, eng.allreduce(big, "x", compression="int8"))
    assert torch.equal(rm.result, eng2.allreduce_multi(X2, ["data", "pod"]))
    seq = Sequencer(eng)
    sreqs = issue(seq)
    sim = seq.simulate_drain({r: list(v.cpu().numpy())
                              for r, v in zip(sreqs, small + [mid])})
    for r, s_ in zip(reqs, sreqs):
        assert np.array_equal(r.result.cpu().numpy(), np.stack(sim[s_]))


def test_queue_int8_one_k2_k3_launch_per_exchange(card):
    """A drained int8 request launches exactly one K2 and one K3 per
    compressed exchange (a ring allreduce: 7), as the blocking call does."""
    eng = CollectiveEngine({"x": 8})
    X = _randn((8, 8 * 32 * 256), 34, card)
    r = eng.iallreduce(X, "x", algorithm="ring", segments=32,
                       compression="int8")
    ops.reset_launch_counts()
    got = r.wait()
    counts = ops.launch_counts()
    assert counts["quantize_blocks"] == counts["dequantize_blocks"] == 7
    assert torch.equal(got, eng.allreduce(X, "x", algorithm="ring",
                                          segments=32, compression="int8"))


def test_vecmat_4096_on_card(card):
    """Use case 1 at 4096, 4 tiles: exactly log2(8) = 3 K1 launches per
    tile's binomial-tree reduction, the result within gamma_K (|x| @ |w|)
    of the float64 product."""
    size = 4096
    w = _randn((size, size), 35, card)
    x = _randn((size,), 36, card)
    eng = CollectiveEngine({"x": 8})
    ops.reset_launch_counts()
    y = distributed_vecmat.distributed_vecmat(
        eng, x.reshape(8, -1), w.reshape(8, -1, size), 4)
    assert ops.launch_counts()["fused_combine"] == 3 * 4
    gamma = size * 2.0 ** -24 / (1 - size * 2.0 ** -24)
    want = x.double() @ w.double()
    bound = gamma * (x.double().abs() @ w.double().abs())
    assert bool(((y.double() - want).abs() <= bound).all())


def test_lm_decode_on_card_equals_cpu(card):
    """The LM serving path on the card: 8 teacher-forced decode steps of
    reduced qwen3-0.6b (fp32) on the (1, 2, 2) mesh give the CPU port's
    tokens, with K1 launched once per engine allreduce (2 L + 3 per
    step: the embedding, two per layer, the head's max and min)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.convert import stack_global, unstack
    from repro_torch.parallel import stages
    cfg = reduced_config(get_config("qwen3-0.6b"))
    mesh = {"pod": 1, "data": 2, "model": 2}
    pcfg = ParallelConfig()
    params = stages.init_params(cfg, mesh, 2, seed=3, device="cpu",
                                serve=True)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 8)).astype(np.int32))

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        return tree.to(dev)

    out = {}
    for dev in ("cpu", card):
        dstep, _, _, _ = stages.build_decode_step(
            cfg, pcfg, mesh, s_max=8, global_batch=4, device=dev)
        cache = stages.init_cache(cfg, pcfg, mesh, 2, 4, 8, device=dev)
        p = to(params, dev)
        before = fused_reduce.fused_combine.launches
        preds = []
        for t in range(8):
            nxt, cache = dstep(p, cache, stack_global(
                toks[:, t:t + 1].to(dev), mesh, (("data",), None)), t)
            preds.append(unstack(nxt, mesh, (("data",),)).cpu())
        out[str(dev)] = torch.stack(preds, 1)
        launched = fused_reduce.fused_combine.launches - before
        assert launched == (0 if dev == "cpu"
                            else 8 * (2 * cfg.n_layers + 3))
    assert torch.equal(out["cpu"], out[str(card)])


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "mixtral-8x7b"])
def test_lm_families_served_on_card_equal_cpu(card, arch):
    """The SSM and MoE families served on the card (reduced, fp32, the
    (1, 2, 2) mesh): ServeSession's tokens (prefill, the SSM carries' or
    the KV handoff, dropless MoE decode through the engine's
    all-to-alls) equal the same session on the CPU, and K1 launches on
    the card only."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.parallel import stages
    from repro_torch.runtime import ServeSession
    cfg = reduced_config(get_config(arch))
    mesh = {"pod": 1, "data": 2, "model": 2}
    pcfg = ParallelConfig(moe_capacity_factor=8.0)
    params = stages.init_params(cfg, mesh, 2, seed=4, device="cpu",
                                serve=True)
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 8)).astype(np.int32))

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        return tree.to(dev)

    out = {}
    for dev in ("cpu", card):
        sess = ServeSession(cfg, pcfg, mesh, 2, 4, 8, 14, device=dev)
        before = fused_reduce.fused_combine.launches
        out[str(dev)] = sess.generate(to(params, dev), prompt, 6)
        launched = fused_reduce.fused_combine.launches - before
        assert (launched == 0) == (dev == "cpu")
    assert torch.equal(out["cpu"], out[str(card)])


# --------------------------------------------------------------------------
# Training: the flash backward and the collectives' adjoints on the card
# --------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 24])
def test_flash_backward_on_card_matches_cpu(card, window):
    """The flash Function's dq, dk, dv on the card equal the CPU's (fp32,
    cuBLAS vs CPU summation orders: 1e-5)."""
    from repro_torch.models.attention import flash_attention
    shapes = ((2, 64, 6, 16), (2, 64, 2, 16), (2, 64, 2, 16))
    cpu = [_randn(s, i, "cpu").requires_grad_() for i, s in
           enumerate(shapes)]
    dev = [t.detach().to(card).requires_grad_() for t in cpu]
    cot = _randn((2, 64, 6, 16), 9, "cpu")
    grads = []
    for ts, c in ((cpu, cot), (dev, cot.to(card))):
        out = flash_attention(*ts, causal=True, window=window, q_block=16,
                              kv_block=32)
        grads.append(torch.autograd.grad((out * c).sum(), ts))
    for a, b in zip(*grads):
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), atol=1e-5)


@pytest.mark.parametrize("name", ["allreduce", "allgather",
                                  "reduce_scatter", "alltoall"])
def test_adjoints_on_card_bitwise_cpu(card, name):
    """Each collective's adjoint runs through the engine on the card (K1
    for the reductions) and equals the CPU's plain versions bitwise,
    forward and backward."""
    shape = (4, 8, 6)
    outs = []
    k1 = fused_reduce.fused_combine.launches
    for device in ("cpu", card):
        eng = CollectiveEngine({"m": 4}, device=device)
        x = _randn(shape, 0, device).requires_grad_()
        y = getattr(eng, name)(x, "m")
        assert type(y.grad_fn).__name__.endswith("Backward")
        cot = _randn(tuple(y.shape), 1, device)
        (g,) = torch.autograd.grad((y * cot).sum(), [x])
        outs.append((y.detach().cpu(), g.cpu()))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    if name != "alltoall":
        assert fused_reduce.fused_combine.launches > k1


def test_allgather_matmul_adjoint_on_card(card):
    """allgather_matmul runs K4 in its forward; its adjoint (a
    reduce-scatter through the engine, and the gathered x^T dy) matches
    the CPU's (fp32, 1e-5)."""
    k4 = matmul.matmul_tiled.launches
    res = []
    for device in ("cpu", card):
        eng = CollectiveEngine({"m": 4}, device=device)
        x = _randn((4, 8, 16), 2, device).requires_grad_()
        w = _randn((4, 16, 12), 3, device).requires_grad_()
        y = eng.allgather_matmul(x, w, "m")
        cot = _randn(tuple(y.shape), 4, device)
        res.append([t.detach().cpu() for t in (y,) + torch.autograd.grad(
            (y * cot).sum(), [x, w])])
    assert matmul.matmul_tiled.launches > k4
    for a, b in zip(*res):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5)


# --------------------------------------------------------------------------
# Ring attention and the dry run's counters on the card
# --------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_on_card_matches_float64(card, causal):
    """bf16 ring attention over 8 ranks (4 q heads, 2 kv heads) within
    `chip_smoke.py::ring_bound` of a float64 attention of the same
    inputs: u |out| + (u + 2 K 2^-24) (P @ |v|), u = 2^-8; and its rms
    error within 1.2 x the rms of its bf16 roundings (`chip_smoke.py::
    ring_rms`: 0.18 u^2 (P^2 @ v^2 + out^2) per element), which the same
    inputs with bf16 scores break."""
    S, n = 512, 8
    q, k, v = (_randn((1, S, h, 32), i, card, torch.bfloat16)
               for i, h in enumerate((4, 2, 2)))
    eng = CollectiveEngine({"x": n}, device=card)
    st = [t.reshape(1, n, S // n, *t.shape[2:]).movedim(1, 0).contiguous()
          for t in (q, k, v)]

    def run():
        y = eng.ring_attention(*st, "x", causal=causal, segments=2)
        return y.movedim(0, 1).reshape(1, S, 4, 32)[0].double()

    got = run()
    kh, vh = (t[0].double().repeat_interleave(2, 1) for t in (k, v))
    s = torch.einsum("qhd,khd->hqk", q[0].double(), kh) / 32 ** 0.5
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool,
                                     device=card).triu(1), -float("inf"))
    p = torch.softmax(s, -1)
    want = torch.einsum("hqk,khd->qhd", p, vh)
    mag = torch.einsum("hqk,khd->qhd", p, vh.abs())
    u = 2.0 ** -8
    bound = u * want.abs() + (u + 2 * S * 2.0 ** -24 + 2.0 ** -20) * mag
    assert bool(((got - want).abs() <= bound).all())
    var = 0.18 * u * u * (torch.einsum("hqk,khd->qhd", p * p, vh * vh)
                          + want * want)

    def rms(y):
        return float(((y - want) ** 2).sum() / var.sum()) ** 0.5

    assert rms(got) <= 1.2
    assert eng.trace_log == [("ring_attention", "ring", "x",
                              (S // n) * 2 * 32 * 2)]
    real = torch.einsum

    def bf16_scores(eq, *operands):
        if eq == "rbqkgh,rbskh->rbkgqs":
            return real(eq, *[t.bfloat16() for t in operands]).float()
        return real(eq, *operands)

    torch.einsum = bf16_scores
    try:
        control = run()
    finally:
        torch.einsum = real
    assert rms(control) > 1.2


def test_meta_counters_equal_card_step(card):
    """A reduced qwen3-0.6b train step with SP and the collective matmul
    on the (1, 4, 2) mesh, once on 'meta' and once on the card under the
    same counters: FLOPs equal (K4's counted at its wrapper on the card),
    argument bytes equal, the programs equal in order, the card's
    launches those the meta run's kernel entry points imply."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import analysis, dryrun
    from repro_torch.optim import adamw
    from repro_torch.parallel import stages
    cfg = reduced_config(get_config("qwen3-0.6b"), param_dtype="bfloat16",
                         compute_dtype="bfloat16")
    mesh = {"pod": 1, "data": 4, "model": 2}
    pcfg = ParallelConfig(remat="none", sequence_parallel=True,
                          collective_matmul=True)
    fn, eng, args = dryrun.build_cell(cfg, ShapeConfig("t", 32, 8, "train"),
                                      mesh, pcfg)
    _, st_m = analysis.count(fn, [eng])
    ts = stages.build_train_step(cfg, pcfg, mesh, adamw.AdamWConfig(),
                                 device=card)
    params = stages.init_params(cfg, mesh, 2, device=card)
    opt = adamw.adamw_init(params)
    toks = torch.randint(0, cfg.vocab_size, (8, 32), dtype=torch.int32)
    batch = ts.put_batch({"tokens": toks, "labels": toks})
    k4 = matmul.matmul_tiled.launches
    k1 = fused_reduce.fused_combine.launches
    kc = fused_reduce.region_copy.launches
    with analysis.counting([ts.ctx.engine]) as st_c:
        ts.fn(params, opt, batch, 0)
    assert matmul.matmul_tiled.launches > k4
    launched = {"fused_combine": fused_reduce.fused_combine.launches - k1,
                "matmul_tiled": matmul.matmul_tiled.launches - k4,
                "region_copy": fused_reduce.region_copy.launches - kc}
    assert st_m.kernel_calls == st_c.kernel_calls == {
        k: v for k, v in launched.items() if v}
    assert st_c.flops == st_m.flops
    assert analysis.arg_bytes((params, opt, batch), mesh) == \
        analysis.arg_bytes(args, mesh)
    assert [(p[0], p[2], p[4]) for p in st_c.programs] == \
        [(p[0], p[2], p[4]) for p in st_m.programs]


# --------------------------------------------------------------------------
# The SSD prefill scan (csrc/ssd_scan.cu) against its plain version
# --------------------------------------------------------------------------

# (N, S, H, P, n, chunk)
SSD_CASES = {
    "granite": (8, 16384, 16, 64, 128, 256),   # Granite-4.0-H's per-card prefill
    "reduced": (4, 48, 4, 16, 16, 16),         # the reduced configs' widths
    "hymba": (4, 1024, 8, 64, 16, 256),        # hymba-1.5b's state width
    "short": (2, 100, 4, 64, 128, 256),        # a prompt shorter than a chunk
}


def _ssd_inputs(N, S, H, P, n, dtype, device, seed):
    """x, B, C normal; dt log-uniform over [1e-3, 0.1] and a over
    [-16, -1] (Mamba2's init ranges), a per sequence and head."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device).to(dtype)

    dt = torch.exp(math.log(1e-3) + rand(N, S, H) * math.log(100.0))
    return (randn(N, S, H, P), dt, -(1 + 15 * rand(N, H)), randn(N, S, n),
            randn(N, S, n))


def _rel_err(got, want) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_kernel_within_twice_the_plain_error(card, case, dtype):
    """The kernel's y and final state, and the plain version's (fp32, no
    TF32), against the recurrence in float64 (`ref.ssd_recurrence`): the
    kernel's largest error (a share of the largest entry) at most twice
    the plain version's."""
    *dims, chunk = SSD_CASES[case]
    args = _ssd_inputs(*dims, dtype, card, seed=len(case))
    launches = ssd_scan.ssd_chunked.launches
    y, h = ops.ssd_chunked(*args, chunk)
    assert ssd_scan.ssd_chunked.launches == launches + ssd_scan.LAUNCHES
    y_p, h_p = ref.ssd_chunked(*args, chunk)
    y64, h64 = ref.ssd_recurrence(*args)
    for got, plain, want in ((y, y_p, y64), (h, h_p, h64)):
        assert (got.shape, got.dtype) == (plain.shape, plain.dtype)
        err, plain_err = _rel_err(got, want), _rel_err(plain, want)
        assert err <= 2 * plain_err, (err, plain_err)


def test_ssd_kernel_reads_strided_and_mixed_operands(card):
    """The mixer's layout (x, B and C slices of one conv output, a_neg by
    head alone) gives the bits of contiguous copies; fp32 B and C beside
    bf16 x read x widened, as the all-fp32 call, y cast to bf16; float64
    operands are read as fp32."""
    N, S, H, P, n, chunk = 2, 512, 4, 64, 128, 256
    g = torch.Generator(device=card).manual_seed(5)
    conv = torch.randn((N, S, H * P + 2 * n), generator=g,
                       device=card).to(torch.bfloat16)
    xh = conv[..., :H * P].reshape(N, S, H, P)
    b, c = conv[..., H * P:H * P + n], conv[..., H * P + n:]
    dt = torch.rand((N, S, H), generator=g, device=card) * 0.1 + 1e-3
    a = -(1 + 15 * torch.rand((H,), generator=g, device=card))
    y, h = ops.ssd_chunked(xh, dt, a, b, c, chunk)
    y2, h2 = ops.ssd_chunked(xh.contiguous(), dt, a.expand(N, H).contiguous(),
                             b.contiguous(), c.contiguous(), chunk)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    y3, h3 = ops.ssd_chunked(xh, dt, a, b.float(), c.float(), chunk)
    y4, h4 = ops.ssd_chunked(xh.float(), dt, a, b.float(), c.float(), chunk)
    assert y3.dtype == torch.bfloat16
    assert torch.equal(y3, y4.to(torch.bfloat16)) and torch.equal(h3, h4)
    # a float64 model (a reference forward) is read as fp32, as the plain
    # version reads it, and y cast back
    y5, h5 = ops.ssd_chunked(xh.double(), dt, a, b.double(), c.double(),
                             chunk)
    assert y5.dtype == torch.float64
    assert torch.equal(y5, y4.double()) and torch.equal(h5, h4)


def test_ssd_kernel_raises_and_autograd_differentiates_the_plain_version(
        card):
    """A chunk that does not tile S raises; operands that require grad
    still launch the kernel (its five launches, none in the backward),
    and their gradients are the plain version's (a loss linear in y and
    the final state, so the same output gradients reach both: bitwise);
    the kernel's products are counted as the plain version's."""
    args = _ssd_inputs(2, 64, 3, 16, 16, torch.float32, card, seed=6)
    with pytest.raises(ValueError, match="does not tile"):
        ops.ssd_chunked(*args, 48)
    with pytest.raises(ValueError, match="exceed"):
        ssd_scan.ssd_chunked(*_ssd_inputs(1, 2048, 1, 16, 16, torch.float32,
                                          card, seed=7), 2048)
    g = torch.Generator(device=card).manual_seed(8)
    wy = torch.randn((2, 64, 3, 16), generator=g, device=card)
    wh = torch.randn((2, 3, 16, 16), generator=g, device=card)
    launches = ssd_scan.ssd_chunked.launches
    leaves = [t.clone().requires_grad_() for t in args]
    y, h = ops.ssd_chunked(*leaves, 16)
    assert ssd_scan.ssd_chunked.launches == launches + ssd_scan.LAUNCHES
    ((y * wy).sum() + (h * wh).sum()).backward()
    assert ssd_scan.ssd_chunked.launches == launches + ssd_scan.LAUNCHES
    want = [t.clone().requires_grad_() for t in args]
    y_r, h_r = ref.ssd_chunked(*want, 16)
    ((y_r * wy).sum() + (h_r * wh).sum()).backward()
    y64, h64 = ref.ssd_recurrence(*args)
    for got, plain, exact in ((y, y_r, y64), (h, h_r, h64)):
        assert _rel_err(got, exact) <= 2 * _rel_err(plain, exact)
    for a, b in zip(leaves, want):
        assert torch.equal(a.grad, b.grad)
    flops = ops.kernel_flops()
    with torch.no_grad():
        ops.ssd_chunked(*leaves, 16)
    assert ops.kernel_flops() - flops == ssd_scan.flops(2, 64, 3, 16, 16, 16)
    from repro_torch.launch import analysis
    meta = [t.detach().to("meta") for t in args]
    _, st = analysis.count(lambda: ref.ssd_chunked(*meta, 16))
    assert st.flops == ssd_scan.flops(2, 64, 3, 16, 16, 16)
