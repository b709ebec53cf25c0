"""The port's static verifier (`repro_torch/core/verify.py`) against the
reference's mutation matrix (`tests/test_verify.py`).

  * Every built-in program the per-rank executor runs compiles and
    FULLY verifies in the port: every `GENERATORS` entry at n 2, 3, 4,
    5, 8, segments 1, 2, 4, codecs None, bf16, int8, and the
    hierarchical compositions on the (P, M) product shapes
    (VERIFY_EXHAUSTIVE=1 adds n 12 and 16 and segments 8).
  * The mutation matrix: one minimally broken schedule or program per
    rule id, built alike in both packages; in each package the owning
    pass — and only that pass — rejects it with the rule id, and the two
    packages' rule ids agree one for one. Both `RULES` tables are equal.
  * `plugins.register_collective`'s verify gate: a verified schedule
    enters the registry, a broken one is refused with its rule and the
    failing probe point, and `verify=False` opts out.
"""
import dataclasses
import os
import types

import pytest

from repro.core import algorithms as j_algorithms
from repro.core import hierarchical as j_hierarchical
from repro.core import plugins as j_plugins
from repro.core import program as j_program
from repro.core import schedule as j_schedule
from repro.core import topology as j_topology
from repro.core import verify as j_verify
from repro_torch.core import algorithms, hierarchical, plugins, program, \
    schedule, topology, verify


def _pkg(alg, hier, prog, sched, topo, ver, plug):
    return types.SimpleNamespace(
        algorithms=alg, hierarchical=hier, verify=ver, plugins=plug,
        Copy=prog.Copy, Compress=prog.Compress, Decompress=prog.Decompress,
        Program=prog.Program, RecvCombine=prog.RecvCombine, Send=prog.Send,
        StreamChain=prog.StreamChain, Schedule=sched.Schedule,
        Sel=sched.Sel, Step=sched.Step, Communicator=topo.Communicator,
        ProductComm=topo.ProductComm)


PORT = _pkg(algorithms, hierarchical, program, schedule, topology, verify,
            plugins)
REF = _pkg(j_algorithms, j_hierarchical, j_program, j_schedule, j_topology,
           j_verify, j_plugins)


def _comm(pk, n):
    return pk.Communicator(axis="x", size=n)


def _pcomm(pk, P, M):
    return pk.ProductComm(
        outer=pk.Communicator(axis="pod", size=P, is_dcn=True),
        inner=pk.Communicator(axis="x", size=M))


# --------------------------------------------------------------------------
# 1. The built-in sweep
# --------------------------------------------------------------------------

EXHAUSTIVE = bool(os.environ.get("VERIFY_EXHAUSTIVE"))
SIZES = (2, 3, 4, 5, 8) + ((12, 16) if EXHAUSTIVE else ())
SEGMENTS = (1, 2, 4) + ((8,) if EXHAUSTIVE else ())
CODECS = (None, "bf16", "int8")
SHAPES = ((2, 2), (2, 4), (4, 2), (3, 4)) + \
    (((4, 4), (2, 8)) if EXHAUSTIVE else ())


@pytest.mark.parametrize("coll,algo", sorted(algorithms.GENERATORS),
                         ids=[f"{c}-{a}" for c, a in
                              sorted(algorithms.GENERATORS)])
def test_builtin_programs_verify(coll, algo):
    gen = algorithms.GENERATORS[(coll, algo)]
    checked = 0
    for n in SIZES:
        try:
            sched = gen(_comm(PORT, n))
        except ValueError:
            continue  # pow2-only generator on a non-pow2 size
        for segments in SEGMENTS:
            for codec in CODECS:
                sched.compile(segments=segments, codec=codec, verify="full")
                checked += 1
    assert checked >= len(SEGMENTS) * len(CODECS) * 2


@pytest.mark.parametrize("coll", ["allreduce", "reduce_scatter",
                                  "allgather", "bcast"])
def test_hierarchical_programs_verify(coll):
    checked = 0
    for P, M in SHAPES:
        for inter in hierarchical.inter_candidates(coll, P):
            try:
                sched = hierarchical.hierarchical_schedule(
                    coll, _pcomm(PORT, P, M), intra="ring", inter=inter)
            except ValueError:
                continue
            for segments in (1, 2):
                for codec in (None, "int8"):
                    sched.compile(segments=segments, codec=codec,
                                  verify="full")
                    checked += 1
    assert checked > 0


def test_rules_tables_equal():
    assert verify.RULES == j_verify.RULES
    assert {p for p, _ in verify.RULES.values()} == {
        "structural", "exchange", "deadlock", "level", "dataflow"}


# --------------------------------------------------------------------------
# 2. The mutation matrix: (program, schedule, owning pass, rule)
# --------------------------------------------------------------------------

def _passes(pk):
    v = pk.verify
    return {
        "structural": lambda p, s: v.structural_pass(p),
        "exchange": lambda p, s: v.exchange_pass(p, full=True),
        "deadlock": lambda p, s: v.deadlock_pass(p),
        "level": lambda p, s: v.level_pass(p),
        "dataflow": lambda p, s: v.dataflow_pass(p, s),
        "stream": lambda p, s: v.stream_pass(p),
    }


def mut_dropped_recv(pk):
    sched = pk.algorithms.recursive_doubling_allreduce(_comm(pk, 4))
    s0 = sched.steps[0]
    mut = dataclasses.replace(
        sched, steps=(dataclasses.replace(s0, perm=s0.perm[:-1]),)
        + sched.steps[1:])
    return mut.compile(verify="off"), mut, "exchange", "XM_UNMATCHED_RECV"


def mut_byte_count(pk):
    n = 4
    perm = tuple(_comm(pk, n).ring_perm(1))
    sched = pk.Schedule(
        name="mut", collective="allreduce", nranks=n, chunks=n,
        result="full",
        steps=(pk.Step(perm=perm, op="copy",
                       send_sel=pk.Sel.chunk(lambda r, s: r),
                       recv_sel=pk.Sel.range(
                           lambda r, s: ((r - 1) % (n - 1), 2)),
                       bytes_frac=1.0 / n),))
    return sched.compile(verify="off"), sched, "exchange", \
        "XM_BYTES_MISMATCH"


def mut_bytes_frac(pk):
    sched = pk.algorithms.ring_reduce_scatter(_comm(pk, 4))
    mut = dataclasses.replace(
        sched, steps=tuple(dataclasses.replace(s, bytes_frac=1.0)
                           for s in sched.steps))
    return mut.compile(verify="off"), mut, "exchange", "XM_BYTES_FRAC"


def mut_scale_block(pk):
    perm = ((0, 1), (1, 0))
    body = (pk.Copy("load", pk.Sel.all(), step=0), pk.Compress("int8"),
            pk.Send(perm, bytes_frac=1.0), pk.Decompress("bf16"),
            pk.RecvCombine("add", pk.Sel.all(), step=0))
    prog = pk.Program(name="mut", collective="allreduce", nranks=2,
                      chunks=1, relay="buffer", segments=1, codec="int8",
                      ops=body)
    return prog, None, "exchange", "XM_SCALE_BLOCK"


def mut_self_send(pk):
    sched = pk.algorithms.recursive_doubling_allreduce(_comm(pk, 4))
    s0 = sched.steps[0]
    mut = dataclasses.replace(
        sched, steps=(dataclasses.replace(
            s0, perm=((0, 0), (2, 3), (3, 2)), mask_recv=True),)
        + sched.steps[1:])
    return mut.compile(verify="off"), mut, "deadlock", "DL_SELF_SEND"


def mut_read_before_write(pk):
    n = 4
    perm = tuple(_comm(pk, n).ring_perm(1))
    sched = pk.Schedule(
        name="mut", collective="allgather", nranks=n, chunks=n,
        result="full",
        steps=tuple(
            pk.Step(perm=perm, op="copy",
                    send_sel=pk.Sel.chunk(lambda r, s: (r + 1) % n),
                    recv_sel=pk.Sel.chunk(lambda r, s: r),
                    bytes_frac=1.0 / n, uniform=True)
            for _ in range(n - 1)))
    return sched.compile(verify="off"), sched, "dataflow", \
        "DF_READ_BEFORE_WRITE"


def mut_combine_unwritten(pk):
    n = 4
    perm = tuple(_comm(pk, n).ring_perm(1))
    sched = pk.Schedule(
        name="mut", collective="allgather", nranks=n, chunks=n,
        result="full",
        steps=(pk.Step(perm=perm, op="add",
                       send_sel=pk.Sel.chunk(lambda r, s: r),
                       recv_sel=pk.Sel.chunk(lambda r, s: (r - 1) % n),
                       bytes_frac=1.0 / n),))
    return sched.compile(verify="off"), sched, "dataflow", \
        "DF_COMBINE_UNWRITTEN"


def mut_double_write(pk):
    n = 4
    perm = tuple(_comm(pk, n).ring_perm(1))
    step = pk.Step(perm=perm, op="copy",
                   send_sel=pk.Sel.chunk(lambda r, s: r),
                   recv_sel=pk.Sel.chunk(lambda r, s: (r - 1) % n),
                   bytes_frac=1.0 / n)
    sched = pk.Schedule(name="mut", collective="allgather", nranks=n,
                        chunks=n, result="full", steps=(step, step))
    return sched.compile(verify="off"), sched, "dataflow", "DF_DOUBLE_WRITE"


def mut_truncated_ring(pk):
    sched = pk.algorithms.ring_allgather(_comm(pk, 4))
    mut = dataclasses.replace(sched, steps=sched.steps[:-1])
    return mut.compile(verify="off"), mut, "dataflow", "DF_COVERAGE"


def _tagged_allreduce(pk, level_perm=((0, 1), (1, 0)), level_sizes="auto"):
    P = M = 2
    perm = pk.hierarchical._expand_intra_perm(level_perm, P)
    if level_sizes == "auto":
        level_sizes = (("inter", P), ("intra", M))
    step = pk.Step(perm=perm, op="add", send_sel=pk.Sel.all(),
                   recv_sel=pk.Sel.all(), bytes_frac=1.0,
                   level="intra", level_perm=level_perm)
    return pk.Schedule(name="tagged", collective="allreduce", nranks=P * M,
                       steps=(step,), chunks=1, result="full",
                       level_sizes=level_sizes)


def mut_orphan_level(pk):
    sched = _tagged_allreduce(pk, level_sizes=None)
    return sched.compile(verify="off"), sched, "level", "LV_ORPHAN_LEVEL"


def mut_level_perm_range(pk):
    good = _tagged_allreduce(pk)
    mut = dataclasses.replace(good, steps=(dataclasses.replace(
        good.steps[0], level_perm=((0, 1), (1, 5))),))
    return mut.compile(verify="off"), mut, "level", "LV_PERM_MISMATCH"


def mut_level_perm_expansion(pk):
    good = _tagged_allreduce(pk)
    mut = dataclasses.replace(good, steps=(dataclasses.replace(
        good.steps[0], level_perm=((1, 0), (0, 1))),))
    return mut.compile(verify="off"), mut, "level", "LV_PERM_MISMATCH"


def mut_unsafe_stream_chain(pk):
    perm = ((0, 1), (1, 0))
    chunks = 6

    def body(load_off, comb_off, step):
        return (pk.Copy("load",
                        pk.Sel.range(lambda r, s, o=load_off: (o, 2)),
                        step=step),
                pk.Send(perm, bytes_frac=2.0 / chunks),
                pk.RecvCombine("copy",
                               pk.Sel.range(lambda r, s, o=comb_off: (o, 2)),
                               step=step))

    # wave 2's payload head [1, 2) overlaps wave 1's combine tail [1, 2)
    chain = pk.StreamChain(segments=2,
                           bodies=(body(2, 0, 0), body(1, 4, 1)))
    prog = pk.Program(name="mut", collective="custom", nranks=2,
                      chunks=chunks, relay="buffer", segments=2, codec=None,
                      ops=(chain,))
    return prog, None, "stream", "DF_STREAM_UNSAFE"


MUTATIONS = [mut_dropped_recv, mut_byte_count, mut_bytes_frac,
             mut_scale_block, mut_self_send, mut_read_before_write,
             mut_combine_unwritten, mut_double_write, mut_truncated_ring,
             mut_orphan_level, mut_level_perm_range,
             mut_level_perm_expansion, mut_unsafe_stream_chain]


def _rejects_only(pk, prog, sched, owning_pass):
    """The rule the owning pass raises, every other pass accepting, and
    the rule `verify_program` reports."""
    rule = None
    for name, fn in _passes(pk).items():
        if name == owning_pass:
            with pytest.raises(pk.verify.VerifyError) as ei:
                fn(prog, sched)
            rule = ei.value.rule
        else:
            fn(prog, sched)  # must not raise
    with pytest.raises(pk.verify.VerifyError) as ei:
        pk.verify.verify_program(prog, sched, level="full")
    assert ei.value.rule == rule
    return rule


@pytest.mark.parametrize("mutation", MUTATIONS,
                         ids=[m.__name__[4:] for m in MUTATIONS])
def test_mutation_rejected_by_its_own_pass(mutation):
    prog, sched, owning, rule = mutation(PORT)
    assert rule in verify.RULES
    assert _rejects_only(PORT, prog, sched, owning) == rule
    jprog, jsched, jowning, jrule = mutation(REF)
    assert (jowning, jrule) == (owning, rule)
    assert _rejects_only(REF, jprog, jsched, jowning) == rule


def test_mutation_matrix_covers_the_rules():
    """Every program rule has its broken program here: the single-pass
    mutations above, the dsts drift and the shared walk's ST_* rules
    below (DL_DEP_CYCLE is the queue's, `test_torch_sequencer.py`)."""
    covered = {m(PORT)[3] for m in MUTATIONS} | {
        "XM_DSTS_MISMATCH", "ST_BODY_SHAPE", "ST_SEL_BOUNDS", "ST_PERM_DUP",
        "ST_PERM_RANGE"}
    assert set(verify.RULES) - {"DL_DEP_CYCLE"} == covered


def test_dropped_recv_names_the_rank():
    prog, sched, _o, _r = mut_dropped_recv(PORT)
    err = pytest.raises(verify.VerifyError, verify.verify_program, prog,
                        sched).value
    assert err.rank == 2 and "receive nothing" in str(err)


def test_dsts_drift():
    """A compiled RecvCombine.dsts tampered out from under its perm."""
    for pk in (PORT, REF):
        sched = pk.algorithms.binomial_tree_bcast(_comm(pk, 4))
        prog = sched.compile(verify="off")

        def bad(op):
            if isinstance(op, pk.RecvCombine) and op.dsts is not None:
                return dataclasses.replace(
                    op, dsts=op.dsts + (3,) if 3 not in op.dsts
                    else op.dsts[:-1])
            return op
        mut = dataclasses.replace(prog, ops=tuple(bad(o) for o in prog.ops))
        with pytest.raises(pk.verify.VerifyError) as ei:
            pk.verify.exchange_pass(mut, full=False)
        assert ei.value.rule == "XM_DSTS_MISMATCH"


def test_tagged_schedule_verifies_clean():
    sched = _tagged_allreduce(PORT)
    verify.verify_program(sched.compile(verify="off"), sched, level="full")


def test_structural_rules():
    """ST_BODY_SHAPE, ST_SEL_BOUNDS, ST_PERM_DUP and ST_PERM_RANGE fire
    from the shared IR walk, in both packages alike."""
    for pk in (PORT, REF):
        torn = pk.Program(name="mut", collective="allreduce", nranks=2,
                          chunks=1, relay="buffer", segments=1, codec=None,
                          ops=(pk.Copy("load", pk.Sel.all(), step=0),
                               pk.Send(((0, 1), (1, 0)))))
        err = pytest.raises(pk.verify.VerifyError, pk.verify.verify_program,
                            torn, None).value
        assert err.rule == "ST_BODY_SHAPE"
        wide = dataclasses.replace(torn, ops=(
            pk.Copy("load", pk.Sel.all(), step=0),
            pk.Send(((0, 1), (1, 2))),
            pk.RecvCombine("copy", pk.Sel.all(), step=0)))
        err = pytest.raises(pk.verify.VerifyError, pk.verify.verify_program,
                            wide, None).value
        assert err.rule == "ST_PERM_RANGE"
        n = 4
        sched = pk.Schedule(
            name="mut", collective="allgather", nranks=n, chunks=n,
            result="full",
            steps=(pk.Step(perm=tuple(_comm(pk, n).ring_perm(1)), op="copy",
                           send_sel=pk.Sel.chunk(lambda r, s: r + n),
                           recv_sel=pk.Sel.chunk(lambda r, s: (r - 1) % n),
                           bytes_frac=1.0 / n),))
        err = pytest.raises(pk.verify.VerifyError, pk.verify.verify_program,
                            sched.compile(verify="off"), sched).value
        assert err.rule == "ST_SEL_BOUNDS"
        pk.verify.verify_program(sched.compile(verify="off"), sched,
                                 level="structural")
        dup = pk.algorithms.recursive_doubling_allreduce(_comm(pk, 4))
        mutd = dataclasses.replace(dup, steps=(dataclasses.replace(
            dup.steps[0], perm=((0, 1), (1, 0), (2, 1), (3, 2)),
            mask_recv=True),) + dup.steps[1:])
        err = pytest.raises(pk.verify.VerifyError, pk.verify.verify_program,
                            mutd.compile(verify="off"), mutd).value
        assert err.rule == "ST_PERM_DUP"


def test_verify_error_carries_addressing():
    prog, sched, _o, _r = mut_truncated_ring(PORT)
    err = pytest.raises(verify.VerifyError, verify.verify_program, prog,
                        sched).value
    assert err.rule == "DF_COVERAGE"
    assert err.rank is not None
    assert "[DF_COVERAGE]" in str(err)
    assert isinstance(err, ValueError)


# --------------------------------------------------------------------------
# 3. The registration gate
# --------------------------------------------------------------------------

def _good_scatter(comm, root: int = 0):
    Schedule, Sel, Step = schedule.Schedule, schedule.Sel, schedule.Step
    n = comm.size
    steps = tuple(
        Step(perm=((root, (root + i + 1) % n),), op="copy",
             send_sel=Sel.chunk(lambda r, s, i=i: (root + i + 1) % n),
             recv_sel=Sel.chunk(lambda r, s, i=i: (root + i + 1) % n),
             bytes_frac=1.0 / n, mask_recv=True)
        for i in range(n - 1))
    return Schedule(name="linear", collective="vscatter", nranks=n,
                    steps=steps, chunks=n, result="shard",
                    owned_chunk=lambda r: r, relay="original")


def _broken_scatter(comm, root: int = 0):
    n = comm.size
    sched = _good_scatter(comm, root)
    # receive window twice the payload: a byte-count mismatch on the wire
    steps = tuple(
        dataclasses.replace(
            s, recv_sel=schedule.Sel.range(
                lambda r, s_, i=i: ((root + i + 1) % n, 1)
                if (root + i + 1) % n == n - 1
                else ((root + i + 1) % n, 2)))
        for i, s in enumerate(sched.steps))
    return dataclasses.replace(sched, steps=steps)


def test_register_collective_accepts_verified_schedule():
    try:
        plugins.register_collective("vscatter", _good_scatter)
        assert plugins.custom_generator("vscatter", "custom") is not None
    finally:
        plugins.unregister_collective("vscatter")


def test_register_collective_rejects_broken_schedule():
    before = plugins.registry_version()
    with pytest.raises(verify.VerifyError) as ei:
        plugins.register_collective("wscatter", _broken_scatter)
    msg = str(ei.value)
    assert ei.value.rule == "XM_BYTES_MISMATCH"
    assert "cannot register collective 'wscatter'" in msg
    assert "probe nranks=" in msg
    assert plugins.custom_generator("wscatter", "custom") is None
    assert plugins.registry_version() == before


def test_register_collective_verify_optout():
    try:
        plugins.register_collective("wscatter2", _broken_scatter,
                                    verify=False)
        assert plugins.custom_generator("wscatter2", "custom") is not None
    finally:
        plugins.unregister_collective("wscatter2")
