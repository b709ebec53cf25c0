"""The port's control plane against the reference, compared with `==`.

Compiled micro-op programs (as a structural dump with every selector
evaluated on the (rank, step) grid), `Program.cost`,
`cost_terms(per_link=True)` and `fabric_wire_bytes` over a reduced form
of `tests/test_verify.py::test_builtin_programs_all_verify`'s grid, and
`Selector.choose`'s (algorithm, segments) on a size grid up to 64 MiB.
"""
import dataclasses

import pytest

from repro.core import algorithms as jalgos
from repro.core import hierarchical as jhier
from repro.core.selector import Selector as JSelector
from repro.core.topology import Communicator as JComm
from repro.core.topology import ProductComm as JProduct
from repro_torch.core import algorithms as talgos
from repro_torch.core import hierarchical as thier
from repro_torch.core.selector import Selector as TSelector
from repro_torch.core.topology import Communicator as TComm
from repro_torch.core.topology import ProductComm as TProduct

SIZES = (3, 4, 8)
SEGMENTS = (1, 4)
CODECS = (None, "int8")
MSG_BYTES = (1024, 3 * 2**20, 64 * 2**20)


def _eval(fn, n, steps):
    out = []
    for r in range(n):
        for s in range(steps):
            try:
                v = fn(r, s)
            except Exception as e:  # a closure valid only on some steps
                v = type(e).__name__
            out.append(tuple(v) if isinstance(v, (list, tuple)) else v)
    return tuple(out)


def _dump(obj, n, steps):
    """Structural dump: class names, fields, selectors as value grids."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        if type(obj).__name__ == "Sel":
            return ("Sel", obj.kind,
                    None if obj.fn is None else _eval(obj.fn, n, steps))
        return (type(obj).__name__,) + tuple(
            (f.name, _dump(getattr(obj, f.name), n, steps))
            for f in dataclasses.fields(obj))
    if isinstance(obj, (tuple, list)):
        return tuple(_dump(o, n, steps) for o in obj)
    return obj


def _prices(prog, comm):
    out = []
    for b in MSG_BYTES:
        out.append(prog.cost(b, comm))
        out.append(prog.cost_terms(b, comm, per_link=True))
        out.append(prog.fabric_wire_bytes(b, comm))
    return out


def _flat_cases():
    for (coll, algo), gen in sorted(jalgos.GENERATORS.items()):
        yield pytest.param(coll, algo, id=f"{coll}-{algo}")


@pytest.mark.parametrize("coll,algo", list(_flat_cases()))
def test_flat_programs_and_prices_equal(coll, algo):
    checked = 0
    for n in SIZES:
        try:
            jsched = jalgos.GENERATORS[(coll, algo)](JComm(axis="x", size=n))
        except ValueError:
            with pytest.raises(ValueError):
                talgos.GENERATORS[(coll, algo)](TComm(axis="x", size=n))
            continue
        tsched = talgos.GENERATORS[(coll, algo)](TComm(axis="x", size=n))
        steps = len(jsched.steps)
        for segments in SEGMENTS:
            for codec in CODECS:
                jp = jsched.compile(segments=segments, codec=codec,
                                    verify="full")
                tp = tsched.compile(segments=segments, codec=codec,
                                    verify="full")
                assert _dump(tp, n, steps) == _dump(jp, n, steps)
                assert tp.describe() == jp.describe()
                assert _prices(tp, TComm(axis="x", size=n)) == \
                    _prices(jp, JComm(axis="x", size=n))
                checked += 1
    assert checked


@pytest.mark.parametrize("coll", ["allreduce", "reduce_scatter", "allgather",
                                  "bcast"])
def test_hierarchical_programs_and_prices_equal(coll):
    checked = 0
    for P, M in ((2, 4), (3, 4)):
        jcomm = JProduct(outer=JComm(axis="pod", size=P, is_dcn=True),
                         inner=JComm(axis="x", size=M))
        tcomm = TProduct(outer=TComm(axis="pod", size=P, is_dcn=True),
                         inner=TComm(axis="x", size=M))
        inters = jhier.inter_candidates(coll, P)
        assert inters == thier.inter_candidates(coll, P)
        for inter in inters:
            try:
                js = jhier.hierarchical_schedule(coll, jcomm, intra="ring",
                                                 inter=inter)
            except ValueError:
                continue
            ts = thier.hierarchical_schedule(coll, tcomm, intra="ring",
                                             inter=inter)
            for segments in SEGMENTS:
                codec = "int8" if coll in ("allreduce", "reduce_scatter") \
                    else None
                jp = js.compile(segments=segments, codec=codec,
                                verify="full")
                tp = ts.compile(segments=segments, codec=codec,
                                verify="full")
                n, steps = P * M, len(js.steps)
                assert _dump(tp, n, steps) == _dump(jp, n, steps)
                assert _prices(tp, tcomm) == _prices(jp, jcomm)
                checked += 1
    assert checked


SEL_SIZES = [2**k for k in range(3, 27, 2)] + [3 * 2**20, 64 * 2**20]


@pytest.mark.parametrize("coll,codec", [
    ("allreduce", None), ("allreduce", "int8"), ("reduce_scatter", None),
    ("allgather", None), ("bcast", None), ("alltoall", None),
    ("gather", None), ("reduce", None)])
def test_selector_choices_equal(coll, codec):
    js, ts = JSelector(), TSelector()
    jc, tc = JComm(axis="x", size=8), TComm(axis="x", size=8)
    for nbytes in SEL_SIZES:
        a = js.choose(coll, nbytes, jc, codec=codec)
        b = ts.choose(coll, nbytes, tc, codec=codec)
        assert (b.algorithm, b.segments, b.protocol) == \
            (a.algorithm, a.segments, a.protocol), nbytes
        assert b.predicted_s == a.predicted_s


def test_selector_choices_equal_on_product_comm():
    js, ts = JSelector(), TSelector()
    jc = JProduct(outer=JComm(axis="pod", size=2, is_dcn=True),
                  inner=JComm(axis="data", size=4))
    tc = TProduct(outer=TComm(axis="pod", size=2, is_dcn=True),
                  inner=TComm(axis="data", size=4))
    for coll in ("allreduce", "reduce_scatter", "allgather", "bcast"):
        for nbytes in SEL_SIZES:
            a = js.choose(coll, nbytes, jc)
            b = ts.choose(coll, nbytes, tc)
            assert (b.algorithm, b.segments) == (a.algorithm, a.segments)
