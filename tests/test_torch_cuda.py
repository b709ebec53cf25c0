"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one (decided in
the `card` fixture, never at import). Imports torch and the port only, so
it runs on a machine without jax:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.core import CollectiveEngine
from repro_torch.kernels import ops, ref
from repro_torch.kernels import fused_reduce, quantize


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
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


def test_wrappers_raise_on_bad_input(card):
    a = _randn((8, 64), 5, card)
    with pytest.raises(ValueError):
        fused_reduce.fused_combine(a.t(), a.t())          # not contiguous
    with pytest.raises(TypeError):
        quantize.quantize_blocks(a.double())
    with pytest.raises(ValueError):
        quantize.dequantize_blocks(torch.zeros(8, 100, dtype=torch.int8,
                                               device=card),
                                   torch.zeros(8, 1, device=card), 100)


@pytest.mark.parametrize("codec", [None, "int8"])
def test_engine_on_card_equals_cpu(card, codec):
    X = _randn((8, 4096 * 3), 6, "cpu")
    gpu = CollectiveEngine({"x": 8}).allreduce(
        X.to(card), "x", compression=codec, segments=4)
    cpu = CollectiveEngine({"x": 8}, device="cpu").allreduce(
        X, "x", compression=codec, segments=4)
    assert torch.equal(gpu.cpu(), cpu)
