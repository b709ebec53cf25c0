"""Streaming plugins — ACCL+'s in-flight unary/binary operators (§4.4.2).

"Binary operations are typically utilized to implement reductions — sum,
max, etc. Unary operators may implement compression or encryption."

Binary plugins combine the arriving chunk with the local one; unary plugins
transform chunks on the wire (compressors for compressed gradient
collectives): payloads shrink on the wire and are decompressed at the
consumer.

Port of `repro/core/plugins.py`. Every tensor here is RANK-STACKED: its
leading dim is the rank, and a codec treats each rank's row as that
rank's flat payload (the int8 codec pads every row to whole 256-element
blocks on its own — the reference's jnp wire format). The combine and the
int8 codec go through `repro_torch.kernels.ops`: the CUDA kernels on the
card, their plain versions on the CPU.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.kernels import ops as kops

# --------------------------------------------------------------------------
# Binary plugins (combine ops)
# --------------------------------------------------------------------------


def _kernel_op(name: str) -> Callable:
    return lambda old, new, out=None: kops.fused_combine(old, new, op=name,
                                                         out=out)


def _copy(old, new, out=None):
    return new if out is None else out.copy_(new)


BINARY_PLUGINS: dict[str, Callable] = {
    "copy": _copy,
    "add": _kernel_op("add"),
    "max": _kernel_op("max"),
    "min": _kernel_op("min"),
    "mul": _kernel_op("mul"),
}


def combine(op: str, old, new, out=None):
    """Apply a binary plugin (K1 for every op but 'copy'); `out` (which
    may be `old` itself) receives the result in place."""
    return BINARY_PLUGINS[op](old, new, out=out)


# --------------------------------------------------------------------------
# Unary plugins (compressors)
# --------------------------------------------------------------------------

class Compressed(NamedTuple):
    """Wire format: payload + per-block scales (empty for cast codecs)."""

    payload: torch.Tensor
    scale: torch.Tensor


QUANT_BLOCK = 256  # elements per int8 scale block


def _per_rank(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def bf16_compress(x) -> Compressed:
    return Compressed(x.to(torch.bfloat16),
                      torch.zeros((0,), dtype=torch.float32, device=x.device))


def bf16_decompress(c: Compressed, shape, dtype):
    return c.payload.to(dtype).reshape((-1,) + tuple(shape))


def bf16_consume(c: Compressed, old, op: str, out=None):
    return combine(op, old, c.payload.to(old.dtype).reshape(old.shape),
                   out=out)


def int8_compress(x) -> Compressed:
    """Per-block symmetric int8 quantization of each rank's flat payload."""
    q, s = kops.quantize_int8(x.reshape(x.shape[0], -1))
    return Compressed(q, s)


def int8_decompress(c: Compressed, shape, dtype):
    """Codes back to (ranks, *shape) of `dtype`."""
    flat = kops.dequantize_int8(c.payload, c.scale, _per_rank(shape),
                                out_dtype=dtype)
    return flat.reshape((-1,) + tuple(shape))


def int8_consume(c: Compressed, old, op: str, out=None):
    """Decompress and combine into `old` in one pass (K3 fused): an fp32
    add rounds once, as the reference's contracted multiply-add does."""
    rows, n = old.shape[0], _per_rank(old.shape[1:])
    res = kops.dequantize_int8(
        c.payload, c.scale, n, old=old.reshape(rows, n), op=op,
        out=None if out is None else out.view(rows, n))
    return res.reshape(old.shape)


def int8_compress_at(t, index) -> Compressed:
    """Quantize every segment of a region of the rank-stacked buffer `t`
    (a `core/engine.py::_region_index` triple), read in place: one wire
    of k * ranks rows, segment j's rows j * ranks..(j + 1) * ranks - 1."""
    return Compressed(*kops.quantize_int8_at(t, index))


def int8_consume_at(c: Compressed, old, index, op: str):
    """Decompress a whole exchange's wire and combine it with `op` into
    the region `index` of the rank-stacked buffer `old`, read in place:
    a (k, ranks, seg) result (K3 fused, as `int8_consume`)."""
    unit, _rows, uidx = index
    seg = uidx.shape[2] * unit * _per_rank(old.shape[2:])
    return kops.dequantize_int8_at(c.payload, c.scale, seg, old, index, op)


class Codec(NamedTuple):
    compress: Callable     # (ranks, ...) payload -> Compressed
    decompress: Callable   # (Compressed, per-rank shape, dtype) -> payload
    wire_bytes_per_elem: float
    # Scale-block granularity in elements. Wire segmentation only admits
    # segment sizes that are whole blocks (per-segment scale reuse): every
    # scale is computed from exactly the elements it would see
    # unsegmented, so segmented codec wires are bitwise-identical to
    # unsegmented ones. 1 = elementwise codec, any segmentation is exact.
    block_elems: int = 1
    # (Compressed, old, op, out=None) -> combined: decompress at the
    # consume site, fused with the combine plugin
    consume: Optional[Callable] = None
    # A whole exchange at once, its operands read in place through the
    # executor's region indices (the executor takes them only as a pair;
    # None: it gathers the operands):
    # (buffer, index) -> Compressed of every segment, stacked in j order
    compress_at: Optional[Callable] = None
    # (Compressed, buffer, index, op) -> (k, ranks, seg) combined
    consume_at: Optional[Callable] = None


CODECS: dict[str, Codec] = {
    "bf16": Codec(bf16_compress, bf16_decompress, 2.0, 1, bf16_consume),
    "int8": Codec(int8_compress, int8_decompress, 1.0 + 4.0 / QUANT_BLOCK,
                  QUANT_BLOCK, int8_consume, int8_compress_at,
                  int8_consume_at),
}


def get_codec(name: str) -> Codec:
    if name not in CODECS:
        raise ValueError(f"unknown codec {name!r}; have {sorted(CODECS)}")
    return CODECS[name]


# --------------------------------------------------------------------------
# Collective registry — "new collectives without re-synthesis" (§4.2)
# --------------------------------------------------------------------------
#
# In ACCL+ a new collective is new uC firmware: a new microprogram over the
# fixed DMA/packetizer primitive set, deployed without re-synthesizing the
# circuit. Here the analogue is a schedule generator registered at runtime:
# it lowers through the same compiler and `execute_program` data plane as
# every built-in and gets priced by the selector next to its sibling
# algorithms.

# name -> {algorithm -> (schedule_fn, protocols)}
CUSTOM_COLLECTIVES: dict[str, dict[str, tuple]] = {}
# bumped on every registry mutation; Selector choice caches key on it so
# (un)registering a collective invalidates stale picks
_REGISTRY_VERSION = 0


def registry_version() -> int:
    return _REGISTRY_VERSION


# Registration probe grid: the sizes x segments x codecs a user schedule
# generator must verify on BEFORE it enters the registry — the "no
# re-synthesis, still safe" property. Pow2 and non-pow2 sizes so both
# generator branches are exercised; int8 exercises the blocked-codec
# rules. Generators are free to ValueError on sizes they don't serve.
_PROBE_SIZES = (4, 5, 8)
_PROBE_SEGMENTS = (1, 4)
_PROBE_CODECS = (None, "int8")


def _probe_verify(name: str, algorithm: str, schedule_fn: Callable) -> None:
    """Compile + fully verify the generator across the probe grid.

    Raises `VerifyError` (chained, with the failing probe point named)
    so a broken user schedule is rejected at registration time with an
    actionable diagnostic instead of hanging the fabric at run time.
    """
    import inspect

    from repro_torch.core.topology import Communicator
    from repro_torch.core.verify import VerifyError, verify_program

    try:
        params = inspect.signature(schedule_fn).parameters
        extra_required = [
            p.name for p in list(params.values())[1:]
            if p.default is inspect.Parameter.empty
            and p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                           inspect.Parameter.KEYWORD_ONLY)]
    except (TypeError, ValueError):
        extra_required = None
    if extra_required:
        # Can't probe a generator whose extra arguments we can't supply;
        # it still verifies on every compile (structural) and under
        # REPRO_VERIFY=full.
        return
    for n in _PROBE_SIZES:
        comm = Communicator(axis="x", size=n)
        try:
            sched = schedule_fn(comm)
        except ValueError:
            continue  # generator declares it cannot serve this size
        for segments in _PROBE_SEGMENTS:
            for codec in _PROBE_CODECS:
                try:
                    prog = sched.compile(segments=segments, codec=codec,
                                         verify="off")
                    verify_program(prog, sched, level="full")
                except VerifyError as e:
                    raise VerifyError(
                        e.rule,
                        f"cannot register collective {name!r} "
                        f"(algorithm {algorithm!r}): verification failed "
                        f"at probe nranks={n} segments={segments} "
                        f"codec={codec!r}: {e}",
                        op_index=e.op_index, rank=e.rank,
                        step=e.step) from e


def register_collective(name: str, schedule_fn: Callable,
                        algorithm: str = "custom",
                        protocols: tuple = ("rendezvous",),
                        verify: bool = True) -> None:
    """Register an out-of-tree collective.

    schedule_fn(comm, **kwargs) -> Schedule; `root`/`op` keyword
    parameters are forwarded by the engine when the generator declares
    them. A generator that cannot serve a communicator (e.g. requires
    pow2 ranks) should raise ValueError — the selector skips it, like
    the built-ins' pow2 filter. Multiple algorithms may be registered
    under one collective name — the selector prices them all (under
    `protocols`) and `algorithm="auto"` picks the cheapest, exactly like
    the built-in table.

    Unless `verify=False`, the generator is compiled and FULLY verified
    (core/verify.py) across a probe grid of communicator sizes x
    segment counts x codecs before it enters the registry: a malformed
    schedule is rejected here, with rule/op/rank diagnostics, not
    discovered as wrong numerics or a hang at run time.
    """
    global _REGISTRY_VERSION
    if not callable(schedule_fn):
        raise TypeError(f"schedule_fn for {name!r} must be callable")
    if verify:
        _probe_verify(name, algorithm, schedule_fn)
    CUSTOM_COLLECTIVES.setdefault(name, {})[algorithm] = (
        schedule_fn, tuple(protocols))
    _REGISTRY_VERSION += 1


def unregister_collective(name: str, algorithm: Optional[str] = None) -> None:
    """Remove a registered collective (all algorithms if none named)."""
    global _REGISTRY_VERSION
    if algorithm is None:
        CUSTOM_COLLECTIVES.pop(name, None)
    else:
        CUSTOM_COLLECTIVES.get(name, {}).pop(algorithm, None)
    _REGISTRY_VERSION += 1


def custom_generator(name: str, algorithm: str) -> Optional[Callable]:
    entry = CUSTOM_COLLECTIVES.get(name, {}).get(algorithm)
    return entry[0] if entry is not None else None


def custom_candidates(name: str):
    """(algorithm, schedule_fn, protocols) triples registered for `name`."""
    for algo, (fn, protos) in CUSTOM_COLLECTIVES.get(name, {}).items():
        yield algo, fn, protos
