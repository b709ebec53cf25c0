"""The port's dry run (`launch/dryrun.py`) and its counters
(`launch/analysis.py`) at reduced size on the CPU.

  * the counters on hand-counted programs: a loop of products, an engine
    allreduce's wire bytes (ICI and DCN) against its program's
    `fabric_wire_bytes`, the int8 codec's padded wire and
    `allgather_matmul`'s adjoint against the reference's compiled ones,
    the streaming ring ops, K4's products on 'meta' and through
    `ops.matmul`, the launches the kernel entry points imply, the
    argument bytes a step never reads;
  * `make_production_mesh`, `cache_shapes` and `ops.fused_add` against
    the reference's;
  * a reduced qwen3-0.6b train step and prefill on the (1, 4, 2) mesh
    against the reference's step lowered and compiled here on the same
    mesh (`test_torch_dryrun_families.py`'s helper, which does so for
    every family): argument bytes equal `memory_analysis()`'s; FLOPs and
    wire bytes equal `repro.launch.analysis.analyze_hlo`'s, but for the
    two differences the compiler makes (see `test_train_step_against_
    compiled_reference`);
  * one dry-run result of each kind, and a SKIP(full-attn) cell, through
    `benchmarks/roofline.py::fmt_table`.

`repro.launch.analysis` is imported, never `repro.launch.dryrun` (which
sets XLA_FLAGS for the whole process at import).
"""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from benchmarks.roofline import fmt_table
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.configs.base import ParallelConfig as JaxParallelConfig
from repro.core.compat import shard_map
from repro.core.engine import CollectiveEngine as JaxEngine
from repro.core.topology import make_mesh as jax_make_mesh
from repro.kernels import ops as jax_ops
from repro.launch import analysis as jax_analysis
from repro.parallel import stages as jax_stages
from repro_torch.configs import ParallelConfig, get_config, reduced_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.core import CollectiveEngine
from repro_torch.core.topology import make_mesh
from repro_torch.kernels import ops
from repro_torch.launch import analysis, dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.parallel import stages

import test_torch_dryrun_families as families

MESH = {"pod": 1, "data": 4, "model": 2}
B, S = 8, 64
LAYERS = 2


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# -- the counters on hand-counted programs ----------------------------------

@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_loop_of_products_counts_every_trip(device):
    """An eager loop runs every trip: 10 x 2 M N K (the reference's
    analyzer multiplies a loop body by its trip count)."""
    x = torch.zeros(8, 64, 128, device=device)
    w = torch.zeros(8, 128, 32, device=device)

    def loop():
        y = x
        for _ in range(10):
            y = torch.matmul(x, w) + y[..., :1]
        return y

    _, st = analysis.count(loop)
    assert st.flops == 10 * 2 * 8 * 64 * 128 * 32


def test_k4_counted_on_meta_and_through_ops():
    """`ops.matmul` on 'meta' runs K4's plain version, an aten product
    the dispatch mode counts; K4's own count (`kernel_flops`, the card's
    ctypes launches) does not move, so nothing is counted twice. On the
    card the same 2 G M N K comes from the wrapper
    (`tests/test_torch_cuda.py::test_meta_counters_equal_card_step`)."""
    k0 = ops.kernel_flops()
    for device in ("meta", "cpu"):
        x = torch.zeros(4, 32, 48, dtype=torch.bfloat16, device=device)
        w = torch.zeros(4, 48, 16, dtype=torch.bfloat16, device=device)
        out, st = analysis.count(lambda: ops.matmul(x, w, torch.float32))
        assert out.shape == (4, 32, 16) and out.dtype == torch.float32
        assert st.flops == 2 * 4 * 32 * 48 * 16
    assert ops.kernel_flops() == k0


def _padded_wire(prog, elems: int, block: int = 256) -> float:
    """int8 wire bytes per rank of `prog` on `elems` elements a rank: each
    exchange's segment padded to whole `block`s of codes, one fp32 scale
    per block."""
    total = 0.0
    for mult, k, body, _region in prog.exchange_terms():
        send = next(op for op in body if type(op).__name__ == "Send")
        seg = elems * send.bytes_frac / k
        total += mult * k * math.ceil(seg / block) * (block + 4)
    return total


@pytest.mark.parametrize("axis,compression", [
    ("data", None), ("data", "int8"), (("pod", "data"), None)])
def test_allreduce_wire_bytes_equal_program(axis, compression):
    """One engine allreduce: its wire bytes per rank, ICI and DCN, are
    its executed program's `fabric_wire_bytes` on the executed buffer
    (the two-axis allreduce's pod steps ride DCN); an int8 program's are
    its exchanges' padded codes and scales, which the codec sends, where
    `fabric_wire_bytes` prices 1 + 4/256 bytes an element."""
    mesh = {"pod": 2, "data": 4}
    eng = CollectiveEngine(mesh, device="cpu")
    x = torch.zeros(2, 4, 1000)
    _, st = analysis.count(
        lambda: eng.allreduce(x, axis, compression=compression), [eng])
    assert len(st.programs) == 1
    name, sched, shape, codec, ax = st.programs[0]
    assert (name, codec, ax) == ("allreduce", compression, axis)
    prog = sched.compile(codec=compression)
    fab = prog.fabric_wire_bytes(4 * math.prod(shape[1:]), eng.comm(axis))
    want = fab["ici"] + fab["dcn"] if compression is None else \
        _padded_wire(prog, math.prod(shape[1:]))
    assert st.coll_wire_bytes == want > 0
    assert st.coll_dcn_bytes == fab["dcn"]
    assert (fab["dcn"] > 0) == isinstance(axis, tuple)


@pytest.mark.parametrize("algorithm,coded,plain,elems", [
    ("recursive_doubling", 2, 0, 1000), ("ring", 3, 3, 250)])
def test_int8_wire_counts_padded_blocks(algorithm, coded, plain, elems):
    """An int8 allreduce of 1000 fp32 a rank over 4 ranks sends, in each
    compressed exchange, `elems` codes padded to whole 256-element blocks
    and one fp32 scale per block, and the ring's allgather phase its
    fp32 chunks as they are: recursive doubling 2 x (1024 + 4 x 4) B, the
    ring 3 x (256 + 4) + 3 x 1000 B. The reference's compiled allreduce
    moves the same bytes (its jnp codec pads alike); 1 + 4/256 B a
    compressed element, the priced wire, is less."""
    blocks = -(-elems // 256)
    hand = coded * blocks * (256 + 4) + plain * elems * 4
    assert hand > coded * elems * (1 + 4 / 256) + plain * elems * 4
    eng = CollectiveEngine({"x": 4}, device="cpu")
    _, st = analysis.count(lambda: eng.allreduce(
        torch.zeros(4, 1000), "x", algorithm=algorithm, compression="int8"),
        [eng])
    assert st.coll_wire_bytes == hand and st.coll_dcn_bytes == 0
    jmesh = jax_make_mesh((4,), ("x",))
    jeng = JaxEngine(jmesh)
    fn = jax.jit(shard_map(
        lambda v: jeng.allreduce(v, "x", algorithm=algorithm,
                                 compression="int8"),
        mesh=jmesh, in_specs=P("x"), out_specs=P("x"), check_vma=False))
    compiled = fn.lower(jax.ShapeDtypeStruct(
        (4000,), jnp.float32, sharding=NamedSharding(jmesh, P("x")))).compile()
    assert jax_analysis.analyze_hlo(compiled.as_text()).coll_wire_bytes \
        == hand
    assert st.coll_by_kind == {"allreduce": [1, st.coll_wire_bytes]}


def test_streaming_ring_wire_bytes():
    """The ring ops run no program: ring_attention rotates k and v n - 1
    times, allgather_matmul the x shard n - 1 times; a 'pod' ring rides
    DCN."""
    eng = CollectiveEngine({"pod": 2, "x": 4}, device="meta")
    q, k = _meta(2, 4, 1, 16, 4, 8), _meta(2, 4, 1, 16, 2, 8)
    kb = 16 * 2 * 8 * 4
    _, st = analysis.count(lambda: eng.ring_attention(q, k, k, "x"), [eng])
    assert st.coll_by_kind == {"ring_attention": [1, 2 * 3 * kb]}
    assert st.coll_dcn_bytes == 0
    _, st = analysis.count(lambda: eng.ring_attention(q, k, k, "pod"), [eng])
    assert st.coll_dcn_bytes == st.coll_wire_bytes == 2 * 1 * kb
    x, w = _meta(2, 4, 8, 32), _meta(2, 4, 32, 16)
    _, st = analysis.count(lambda: eng.allgather_matmul(x, w, "x"), [eng])
    assert st.coll_by_kind == {"allgather_matmul": [1, 3 * 8 * 32 * 4]}
    # 4 ring steps, each one product per stacked rank (8)
    assert st.flops == 4 * 8 * 2 * 8 * 32 * 16


@pytest.mark.parametrize("n", [2, 4])
def test_allgather_matmul_grad_wire_equals_reference(n):
    """allgather_matmul and its adjoint move what the reference's
    compiled `jax.grad` of the same call moves: the forward ring's n - 1
    shards and, backward, one reduce-scatter of dy w^T ((n - 1) shards
    again). dw reads the shards the forward's ring brought; a second
    allgather of x for it (the port's backward before) moved (n - 1)
    shards more than the reference."""
    m, k, p = 8, 32, 16
    shard = m * k * 4
    eng = CollectiveEngine({"x": n}, device="cpu")
    x = torch.zeros(n, m, k, requires_grad=True)
    w = torch.zeros(n, k, p, requires_grad=True)

    def step():
        y = eng.allgather_matmul(x, w, "x")
        torch.autograd.grad(y.sum(), [x, w])

    _, st = analysis.count(step, [eng])
    assert st.coll_wire_bytes == 2 * (n - 1) * shard
    assert [p[0] for p in st.programs] == ["reduce_scatter"]
    jmesh = jax_make_mesh((n,), ("x",))
    jeng = JaxEngine(jmesh)

    def loss(xl, wl):
        return jeng.allgather_matmul(xl, wl, "x").sum()

    fn = jax.jit(shard_map(jax.grad(loss, argnums=(0, 1)), mesh=jmesh,
                           in_specs=(P("x"), P("x")),
                           out_specs=(P("x"), P("x")), check_vma=False))
    sds = lambda shape: jax.ShapeDtypeStruct(  # noqa: E731
        shape, jnp.float32, sharding=NamedSharding(jmesh, P("x")))
    compiled = fn.lower(sds((n * m, k)), sds((n * k, p))).compile()
    assert jax_analysis.analyze_hlo(compiled.as_text()).coll_wire_bytes \
        == st.coll_wire_bytes


@pytest.mark.parametrize("device", ["meta", "cpu"])
@pytest.mark.parametrize("algorithm,compression,want", [
    ("ring", None, {"fused_combine": 3, "region_copy": 3}),
    ("recursive_doubling", "int8", {"quantize_blocks": 2,
                                    "dequantize_blocks": 2})])
def test_kernel_calls_counted(device, algorithm, compression, want):
    """The launches the kernel entry points imply, alike on 'meta' and
    on the CPU (where the plain versions launch nothing): a 4-rank ring
    allreduce combines in its 3 reduce-scatter exchanges (K1 each) and
    copies in its 3 allgather exchanges (the indexed copy each, both
    written in place); an int8 recursive doubling quantizes and
    dequantizes each of its 2 exchanges once (K2, K3)."""
    eng = CollectiveEngine({"x": 4}, device=device)
    _, st = analysis.count(lambda: eng.allreduce(
        torch.zeros(4, 1024, device=device), "x", algorithm=algorithm,
        compression=compression), [eng])
    assert st.kernel_calls == want


def test_unread_arguments_counted():
    """`memory` reports the argument bytes no op of the step read (what
    jit drops from a compiled step): an argument the step never touches,
    not one a kernel entry point reads on 'meta' (K5's lookup gives its
    output alone there, and reads the tables all the same)."""
    mesh = {"x": 4}
    tables = _meta(4, 3, 10, 8)
    ids = _meta(4, 5, 3, dtype=torch.int32)
    lo = _meta(4, dtype=torch.int64)
    unused = _meta(4, 100)
    x = _meta(4, 7)
    args = (tables, ids, lo, unused, x)

    def step():
        return ops.embedding_lookup_rows(tables, ids, lo), x * 2

    out, st = analysis.count(step)
    mem = analysis.memory(args, out, st, mesh)
    assert mem["unread_argument_bytes"] == 100 * 4
    assert mem["argument_bytes"] == (3 * 10 * 8 * 4 + 5 * 3 * 4 + 8
                                     + 100 * 4 + 7 * 4)


def test_peak_bytes_track_lifetimes():
    """Live bytes peak while a temporary and its successor coexist, and
    autograd's saved tensors stay live until the backward frees them."""
    x = torch.zeros(1000, 1000, requires_grad=True)
    mb = 4 * 1000 * 1000

    def step():
        y = (x * 2).exp()          # x * 2 dies after exp; exp is saved
        y.sum().backward()

    _, st = analysis.count(step)
    assert st.end_bytes == mb      # x.grad
    assert 2 * mb <= st.peak_bytes <= 3 * mb + 64


# -- meshes, cache shapes, fused_add against the reference ------------------

@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("tp", [16, 2])
def test_make_production_mesh_matches_reference(monkeypatch, multi_pod, tp):
    """The reference builds its 256/512-device mesh with `jax.make_mesh`;
    its shape and axis names, captured at that call, are the port's."""
    from repro.launch import mesh as jax_mesh_mod
    monkeypatch.setattr(jax_mesh_mod.jax, "make_mesh",
                        lambda shape, axes, **kw: dict(zip(axes, shape)))
    want = jax_mesh_mod.make_production_mesh(multi_pod=multi_pod, tp=tp)
    got = make_production_mesh(multi_pod=multi_pod, tp=tp)
    assert got == want and list(got) == list(want)
    assert make_mesh(tuple(got.values()), tuple(got)) == got


def _axes(spec) -> tuple:
    """A spec as a tuple of axis tuples (P folds a 1-tuple to its name)."""
    return tuple(() if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in spec)


CACHE_CASES = {
    "qwen": ("qwen3-0.6b", {}, 0),
    "qwen_int8": ("qwen3-0.6b", {"kv_cache_dtype": "int8"}, 0),
    "qwen_no_seq_shard": ("qwen3-0.6b", {"decode_seq_shard": False}, 0),
    "mamba": ("mamba2-1.3b", {}, 0),
    "hymba": ("hymba-1.5b", {}, 0),
    "whisper": ("whisper-medium", {}, 12),
}


@pytest.mark.parametrize("case", sorted(CACHE_CASES))
def test_cache_shapes_match_reference(case):
    """Each cache leaf: the port's stacked local shape and dtype equal the
    reference's ShapeDtypeStruct's shard shape and dtype; the specs
    equal."""
    arch, pkw, s_enc = CACHE_CASES[case]
    jcfg = jax_reduced_config(jax_get_config(arch))
    cfg = reduced_config(get_config(arch))
    jmesh = jax_make_mesh((1, 4, 2), ("pod", "data", "model"))
    batch, s_max = 8, 32
    dp = stages.dp_axes(MESH, batch)
    assert dp == jax_stages.dp_axes(jmesh, batch)
    want = jax_stages.cache_shapes(jcfg, JaxParallelConfig(**pkw), jmesh, 2,
                                   batch, s_max, s_enc=s_enc, dp=dp)
    got = stages.cache_shapes(cfg, ParallelConfig(**pkw), MESH, 2, batch,
                              s_max, s_enc=s_enc, dp=dp)
    wl = jax.tree.leaves(want)
    gl = jax.tree.leaves(got)
    assert len(wl) == len(gl) > 0
    for w, g in zip(wl, gl):
        assert g.device.type == "meta"
        assert tuple(g.shape[:3]) == (1, 4, 2)
        assert tuple(g.shape[3:]) == tuple(
            NamedSharding(jmesh, w.sharding.spec).shard_shape(w.shape))
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
    wspec = jax_stages.cache_specs(jcfg, JaxParallelConfig(**pkw), 2, s_max,
                                   s_enc=s_enc, dp=dp)
    gspec = stages.cache_specs(cfg, ParallelConfig(**pkw), 2, s_max,
                               s_enc=s_enc, dp=dp)
    assert [_axes(s) for s in jax.tree.leaves(
        wspec, is_leaf=lambda x: isinstance(x, P))] == [
        _axes(s) for s in jax.tree.leaves(
            gspec, is_leaf=lambda x: isinstance(x, tuple))]


@pytest.mark.parametrize("shape", [(8,), (1000, 7), (3, 5, 64), (4096,)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_add_matches_reference(shape, dtype):
    """tests/test_kernels.py::test_fused_add's inputs: the port's
    `ops.fused_add` (K1's plain version here) is bitwise the reference's
    (the Pallas kernel in interpret mode)."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=shape), dtype)
    y = jnp.asarray(rng.normal(size=shape), dtype)
    want = np.asarray(jax_ops.fused_add(x, y).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = ops.fused_add(torch.from_numpy(np.array(x.astype(jnp.float32)))
                        .to(tdt),
                        torch.from_numpy(np.array(y.astype(jnp.float32)))
                        .to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.float().numpy(), want)


# -- a reduced step against the reference's compiled step -------------------

def _reference(kind: str, remat: str, backend: str = "microcode"):
    """(memory_analysis, analyze_hlo stats) of the reference's reduced
    qwen3-0.6b step compiled on the (1, 4, 2) mesh of the host devices
    (`test_torch_dryrun_families.py`'s helper, which lowers every
    reference cell)."""
    return families.reference("qwen3-0.6b", kind,
                              {"remat": remat, "backend": backend},
                              tuple(MESH.values()))


def _port(kind: str, remat: str, backend: str = "microcode"):
    return families.port("qwen3-0.6b", kind,
                         {"remat": remat, "backend": backend},
                         tuple(MESH.values()))


def test_prefill_against_compiled_reference():
    """The same dots and the same programs: argument bytes, FLOPs per
    device and wire bytes per device all equal."""
    mem, hlo = _reference("prefill", "none")
    pmem, st = _port("prefill", "none")
    assert pmem["argument_bytes"] == mem.argument_size_in_bytes
    assert st.flops / 8 == hlo.flops
    assert st.coll_wire_bytes == hlo.coll_wire_bytes


def test_native_prefill_against_compiled_reference():
    """backend='native': the port's native collectives (the engine's
    `_native*` hooks) counted by the reference's ring model of XLA's
    collectives give the compiled step's wire bytes; FLOPs as before."""
    mem, hlo = _reference("prefill", "none", backend="native")
    pmem, st = _port("prefill", "none", backend="native")
    assert pmem["argument_bytes"] == mem.argument_size_in_bytes
    assert st.flops / 8 == hlo.flops
    assert st.coll_ops > 0 and not st.programs
    assert st.coll_wire_bytes == hlo.coll_wire_bytes


@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_step_against_compiled_reference(remat):
    """Argument bytes (params, AdamW state, batch, the step count) equal.
    Two differences are the compiler's, each counted exactly:

      * wire bytes: the port moves one FSDP gather of the tied embedding
        table more — the embedding's and the head's gathers of the same
        shard are one ring allgather after XLA's common-subexpression
        elimination, (n - 1) x the shard's bytes over 'data';
      * FLOPs under remat: the port's checkpoint reruns each block's
        forward whole, where XLA drops one attention product of the
        recomputed forward that the backward never reads — per layer
        2 B_l S^2 H_l hd on each device (none without remat).
    """
    _, cfg = families.configs("qwen3-0.6b")
    mem, hlo = _reference("train", remat)
    pmem, st = _port("train", remat)
    assert pmem["argument_bytes"] == mem.argument_size_in_bytes
    assert pmem["unstacked_argument_bytes"] == 4      # the step count
    b_l, h_l = B // MESH["data"], cfg.n_heads // MESH["model"]
    dropped = 0 if remat == "none" else \
        LAYERS * 2 * b_l * S * S * h_l * cfg.resolved_head_dim
    assert st.flops / 8 == hlo.flops + dropped
    shard = cfg.vocab_size * cfg.d_model * 4 // 8
    assert st.coll_wire_bytes == hlo.coll_wire_bytes + (
        MESH["data"] - 1) * shard


# -- results through the reference's table ----------------------------------

SMALL_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 64, 8, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 64, 8, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 64, 8, "decode"),
    "long_500k": SHAPES["long_500k"],
}


@pytest.fixture
def small_cells(monkeypatch):
    """Reduced configs and shapes on the (1, 4, 2) mesh: the dry run's
    own code path."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: reduced_config(get_config(a)))
    monkeypatch.setattr(dryrun, "SHAPES", SMALL_SHAPES)
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod=False, tp=16: dict(MESH))


def test_results_render_through_fmt_table(small_cells, tmp_path):
    rows = [dryrun.run_cell("qwen3-0.6b", shape, False, ParallelConfig())
            for shape in ("train_4k", "prefill_32k", "decode_32k",
                          "long_500k")]
    rows.append(dryrun.run_dlrm_cell(False, ParallelConfig()))
    assert [r["status"] for r in rows] == ["OK"] * 3 + [
        "SKIP(full-attn)", "OK"]
    for r in rows[:3] + rows[4:]:
        assert r["roofline"]["hw"] == r["hw"] == "tpu-v5e"
        assert r["memory"]["peak_bytes_est"] == (
            r["memory"]["argument_bytes"] + r["memory"]["output_bytes"]
            + r["memory"]["temp_bytes"] - r["memory"]["alias_bytes"])
        assert r["roofline"]["global_flops"] > 0
    assert rows[0]["roofline"]["coll_by_kind"].keys() >= {
        "allgather", "reduce_scatter", "allreduce"}
    assert rows[4]["chips"] == 8 and rows[4]["mesh"] == "1x4x2"
    table = fmt_table(rows).splitlines()
    assert len(table) == 2 + len(rows)
    assert "SKIP(full-attn)" in table[5]
    dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                 "--results", str(tmp_path)])
    saved = json.loads(
        (tmp_path / "qwen3-0.6b_decode_32k_single_base.json").read_text())
    assert saved["status"] == "OK" and saved["mesh"] == "1x4x2"
    assert saved["roofline"].keys() >= {
        "flops_per_device", "coll_wire_bytes_per_device", "t_compute_s",
        "t_memory_floor_s", "t_collective_s", "dominant", "n_loops"}


def test_meta_results_match_plain_versions(monkeypatch):
    """On 'meta' each kernel entry point gives the kernel's result alone
    (its output, no plain-version temporaries): every call an fp32, a
    bf16 and an int8 allreduce and a DLRM lookup make on the CPU, replayed
    on 'meta', gives the plain version's shapes and dtypes."""
    names = ("fused_combine", "fused_combine_at", "quantize_int8_at",
             "dequantize_int8_at", "embedding_lookup_rows")
    real = {n: getattr(ops, n) for n in names}
    calls = []

    def recorder(name):
        def call(*a, **k):
            out = real[name](*a, **k)
            calls.append((name, a, k, out))
            return out
        return call

    for n in names:
        monkeypatch.setattr(ops, n, recorder(n))
    eng = CollectiveEngine({"x": 8}, device="cpu")
    x = torch.randn(8, 3000)
    eng.allreduce(x, "x")
    eng.allreduce(x.bfloat16(), "x", algorithm="ring", segments=4)
    eng.allreduce(x, "x", compression="int8")
    tables = torch.randn(8, 3, 10, 4)
    ids = torch.randint(0, 80, (8, 5, 3), dtype=torch.int32)
    lo = torch.arange(8) * 10
    ops.embedding_lookup_rows(tables, ids, lo)
    assert {c[0] for c in calls} == set(names) - {"fused_combine"}
    ops.fused_combine(x, x, "max", torch.bfloat16)
    to_meta = lambda t: t.to("meta") if isinstance(t, torch.Tensor) else (  # noqa: E731
        tuple(to_meta(e) for e in t) if isinstance(t, tuple) else t)
    for name, a, k, out in calls:
        got = real[name](*to_meta(a), **{n: to_meta(v) for n, v in k.items()})
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        out if isinstance(out, tuple) else (out,)):
            assert g.device.type == "meta"
            assert (tuple(g.shape), g.dtype) == (tuple(w.shape), w.dtype), \
                name
