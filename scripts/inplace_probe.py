#!/usr/bin/env python3
"""Time the data plane's in-place write on an NVIDIA GPU, one exchange at a time.

At the 8 x 64 MiB fp32 allreduce (`bidi_ring` x 32: 14 combining and 14
copy exchanges, each 8 ranks x 32 segments x 32768 elements), cycling
through the program's own region indices so each launch reads its own
cold 32 MiB:

  k1             K1 into a fresh (k, ranks, seg) tensor (the deferred path)
  k1_scatter     the aten `index_put_` that wrote that tensor back
  k1_in_place    K1 writing back through the target index (this port)
  copy_gather    the aten gather of a copy exchange's payload
  copy_scatter   the aten `index_put_` that wrote it back
  copy           the indexed copy, payload to target in one launch

each beside its least time at the HBM bandwidth (K1: two reads and one
write an element; a copy: one read and one write). `fused_combine.cu` is
built as shipped and with one cut, `flipped`: each kernel's other cache
policy (the in-place K1's read of its target evict-first instead of the
default; the copy's loads and stores with the default policy instead of
evict-first / streaming). Each build is first held bitwise to the plain
versions on one exchange. One JSON line per measurement, with the card's `nvidia-smi` name
and power limit. Needs a card and `nvcc`:

    python3 scripts/inplace_probe.py
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from repro_torch.core import engine as engine_mod  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402

OUT = ROOT / "build" / "inplace_probe"
HBM = chip_smoke.HBM_BYTES_PER_S
ENTRY = ("k1_fused_combine_at", "region_copy_at")
# the cut: each kernel's other cache policy (the in-place K1's a read
# evict-first; the copy's loads and stores with the default policy)
_CUTS = {"flipped": (
    ("va[u] = INPLACE ? *reinterpret_cast<const uint4*>(pa[u])",
     "va[u] = INPLACE ? __ldcs(reinterpret_cast<const uint4*>(pa[u]))"),
    ("if (i < seg) v[u] = __ldcs(region_at<W>(src, r, jr, i));",
     "if (i < seg) v[u] = *region_at<W>(src, r, jr, i);"),
    ("if (i < seg) __stcs(const_cast<W*>(region_at<W>(dst, r, jr, i)), v[u]);",
     "if (i < seg) *const_cast<W*>(region_at<W>(dst, r, jr, i)) = v[u];"))}


def build_all() -> dict:
    """One library per build, all nvcc processes started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    shipped = (_build.CSRC / "fused_combine.cu").read_text()
    sos, cmds = {}, []
    for cut in ("",) + tuple(_CUTS):
        src = shipped
        for old, new in _CUTS.get(cut, ()):
            if old not in src:
                raise SystemExit(f"inplace_probe: the cut {cut} no longer "
                                 f"applies: {old!r}")
            src = src.replace(old, new)
        cu = OUT / f"fused_combine_{cut or 'shipped'}.cu"
        cu.write_text(src)
        sos[cut] = cu.with_suffix(".so")
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                     str(_build.CSRC), "-shared", "-o", str(sos[cut]),
                     str(cu)])
    _build._run_all(cmds)
    return {cut: _build.bind(ctypes.CDLL(str(so)), ENTRY)
            for cut, so in sos.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("inplace_probe: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    libs = build_all()

    def emit(**kw):
        print(json.dumps({**kw, "card": card}), flush=True)

    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device="cuda").manual_seed(0)
    L = 64 * 2**20 // 4
    X = torch.randint(-8, 9, (8, L), generator=g, device="cuda",
                      dtype=torch.int32).float()
    calls = chip_smoke.recorded_calls(
        ops, ("fused_combine_at", "region_copy"), X.shape,
        algorithm="bidi_ring", segments=32)
    k1_ex = [(a[1], a[3]) for n, a, _kw, _r in calls
             if n == "fused_combine_at"]
    copy_ex = [(a[1], a[3]) for n, a, _kw, _r in calls
               if n == "region_copy"]          # (payload, target)
    if (len(k1_ex), len(copy_ex)) != (14, 14):
        raise SystemExit(f"inplace_probe: {len(k1_ex)} K1 and "
                         f"{len(copy_ex)} copy exchanges, not 14 and 14")
    unit, _r, units = k1_ex[0][0]
    k, ranks, upk = units.shape
    seg = upk * unit
    elems = k * ranks * seg
    ex_out = torch.empty((k, ranks, seg), device="cuda")
    it = [0]

    def cyc(n):
        it[0] = (it[0] + 1) % n
        return it[0]

    def region(t, index, per: int = 1):
        """A region's C arguments, sizes in words of `per` elements."""
        u, ridx, uidx = index
        return t.data_ptr(), ridx.data_ptr(), uidx.data_ptr(), \
            t.shape[1] // per, u // per, uidx.shape[2]

    def k1_call(lib, out, i):
        tgt, pay = k1_ex[i]
        return lib.k1_fused_combine_at(
            *region(X, tgt), *region(X, pay),
            None if out is None else out.data_ptr(), k, ranks, seg, 0, 0,
            1, 1, stream)

    def copy_call(lib, i, t=X):          # 16-byte words: 4 fp32
        pay, tgt = copy_ex[i]
        return lib.region_copy_at(*region(t, pay, 4), *region(t, tgt, 4), k,
                                  ranks, seg // 4, 16, stream)

    n = 4 * 14
    emit(shape=[k, ranks, seg], exchanges=[len(k1_ex), len(copy_ex)],
         k1_bound_ms=3 * 4 * elems / HBM * 1e3,
         copy_bound_ms=2 * 4 * elems / HBM * 1e3,
         scatter_bound_ms=2 * 4 * elems / HBM * 1e3,
         gather_bound_ms=2 * 4 * elems / HBM * 1e3)
    for cut, lib in libs.items():
        name = cut or None
        # bitwise on one exchange each, against the plain versions
        tgt, pay = k1_ex[3]
        want = X.clone()
        ref.fused_combine_at(want, tgt, want, pay, "add", in_place=True)
        got = X.clone()
        rc = lib.k1_fused_combine_at(
            *region(got, tgt), *region(got, pay), None, k, ranks, seg, 0, 0,
            1, 1, stream)
        pay, tgt = copy_ex[3]
        want_c = X.clone()
        ref.region_copy(want_c, pay, want_c, tgt)
        got_c = X.clone()
        rc = rc or copy_call(lib, 3, got_c)
        torch.cuda.synchronize()
        if rc or not (torch.equal(got, want) and torch.equal(got_c, want_c)):
            raise SystemExit(f"inplace_probe: {cut or 'shipped'} differs "
                             f"from the plain versions ({rc})")
        del got, want, got_c, want_c
        emit(what="k1_in_place", cut=name, ms=chip_smoke.device_time_ms(
            lambda: k1_call(lib, None, cyc(14)), n))
        emit(what="copy", cut=name, ms=chip_smoke.device_time_ms(
            lambda: copy_call(lib, cyc(14)), n))
        if cut:
            continue
        emit(what="k1", cut=None, ms=chip_smoke.device_time_ms(
            lambda: k1_call(lib, ex_out, cyc(14)), n))
        emit(what="k1_scatter", cut=None, ms=chip_smoke.device_time_ms(
            lambda: engine_mod._scatter(X, k1_ex[cyc(14)][0], ex_out), n))
        emit(what="copy_gather", cut=None, ms=chip_smoke.device_time_ms(
            lambda: engine_mod._gather(X, copy_ex[cyc(14)][0]), n))
        gathered = engine_mod._gather(X, copy_ex[0][0])
        emit(what="copy_scatter", cut=None, ms=chip_smoke.device_time_ms(
            lambda: engine_mod._scatter(X, copy_ex[cyc(14)][1], gathered),
            n))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
