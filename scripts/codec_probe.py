#!/usr/bin/env python3
"""Probe what bounds K2 and K3 (the port's int8 wire codec) on an NVIDIA GPU.

Times the indexed K2 (`k2_quantize_blocks_at`) and K3 fp32 add
(`k3_dequantize_blocks_at`) one launch per compressed exchange, cycling
through the 14 exchanges of an 8 x 64 MiB int8 allreduce (each reads its
own 32 MiB region, so every launch finds HBM cold), built from
`src/repro_torch/kernels/csrc/quantize.cu` as shipped and with cuts:

  no_div         K2's IEEE division replaced by a multiply (not bitwise:
                 it times the division);
  resident_grid  the grid cut to the 132 x 8 CTAs the SMs hold at once,
                 a grid-stride loop taking the rest (shipped: one CTA per
                 8 scale blocks);
  2_blocks       resident_grid, each warp loading two scale blocks
                 before it reduces them (twice the bytes in flight; K2
                 only);
  rank_major     the codec rows taken rank by rank (segment j fastest,
                 so consecutive warps read one rank's payload in order)
                 instead of segment by segment; the same output.

Beside them: the same kernels over contiguous operands of the same size
(the identity region: no index loads), and PyTorch calls that move the
same bytes (`x.to(torch.int8)`: 4 + 1 bytes per element; `torch.add` of
an fp32 and an int8 tensor: 4 + 1 + 4). One JSON line per measurement,
with the card's `nvidia-smi` name and power limit. Needs a card and
`nvcc`:

    python3 scripts/codec_probe.py
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
from repro_torch.kernels import _build, ops, ref  # noqa: E402

OUT = ROOT / "build" / "codec_probe"
HBM = chip_smoke.HBM_BYTES_PER_S
ENTRY = ("k2_quantize_blocks", "k2_quantize_blocks_at",
         "k3_dequantize_blocks", "k3_dequantize_blocks_at")

_DIV = "__fdiv_rn(v[i], scale)"
_GRID = "return (unsigned)((nblocks + QZ_WARPS - 1) / QZ_WARPS);"
_RESIDENT = """const int need = (nblocks + QZ_WARPS - 1) / QZ_WARPS;
  return (unsigned)(need < 132 * 8 ? need : 132 * 8);"""
_ROW = "const int w = blk / nb, b = blk - w * nb;"
_RANK_MAJOR = """const int wr = blk / nb, b = blk - wr * nb;
    const int kk = nblocks / nb / {g}.ranks;
    const int w = (wr % kk) * {g}.ranks + wr / kk;"""
_K2_LOOP = """    float v[8];
    load8<T, VEC>(src, w, p0, seg, v);"""
# 2_blocks: the loop takes two blocks per trip; the second block's loads
# are issued before the first block is reduced.
_K2_TWO = """    float v[8], v2[8];
    const int blk2 = blk + gridDim.x * QZ_WARPS;
    const int w2 = blk2 / nb, p2 = (blk2 - w2 * nb) * QUANT_BLOCK + lane * 8;
    load8<T, VEC>(src, w, p0, seg, v);
    if (blk2 < nblocks) load8<T, VEC>(src, w2, p2, seg, v2);
    for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) {
      if (blk2 >= nblocks) break;
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = v2[i];
    }
    const int wq = pass ? w2 : w, pq = pass ? p2 : p0;
    const int bq = pass ? blk2 : blk;"""


def variant_source(cut: str) -> str:
    src = (ROOT / "src/repro_torch/kernels/csrc/quantize.cu").read_text()
    src = src.replace('#include "common.cuh"',
                      f'#include "{ROOT}/src/repro_torch/kernels/csrc/common.cuh"')
    assert _DIV in src and _GRID in src and _K2_LOOP in src and \
        src.count(_ROW) == 2, "quantize.cu changed"
    if cut == "no_div":
        src = src.replace(_DIV, "__fmul_rn(v[i], scale)")
    if cut in ("resident_grid", "2_blocks"):
        src = src.replace(_GRID, _RESIDENT)
    if cut == "rank_major":
        k2, k3 = src.split("dequantize_kernel(const signed char*", 1)
        k2 = k2.replace(_ROW, _RANK_MAJOR.format(g="src")).replace(
            "if (lane == 0) s[blk] = scale;",
            "if (lane == 0) s[(long long)w * nb + b] = scale;")
        k3 = k3.replace(_ROW, _RANK_MAJOR.format(g="old"), 1).replace(
            "__ldg(s + blk)", "__ldg(s + (long long)w * nb + b)")
        src = k2 + "dequantize_kernel(const signed char*" + k3
    if cut == "2_blocks":
        head, rest = src.split("quantize_kernel(Rows src", 1)
        body, tail = rest.split("template <typename T, int OP>", 1)
        body = body.replace("blk += gridDim.x * QZ_WARPS)",
                            "blk += 2 * gridDim.x * QZ_WARPS)")
        body = body.replace(_K2_LOOP, _K2_TWO)
        body = body.replace("q + (long long)w * lp + p0", "q + (long long)wq * lp + pq")
        body = body.replace("if (lane == 0) s[blk] = scale;",
                            "if (lane == 0) s[bq] = scale;\n    }")
        src = head + "quantize_kernel(Rows src" + body + \
            "template <typename T, int OP>" + tail
    return src


CUTS = ("", "no_div", "resident_grid", "2_blocks", "rank_major")


def build_all() -> dict:
    """One library per cut, all nvcc processes started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    sos, cmds = {}, []
    for cut in CUTS:
        cu = OUT / f"quantize_{cut or 'shipped'}.cu"
        cu.write_text(variant_source(cut))
        sos[cut] = cu.with_suffix(".so")
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                     str(sos[cut]), str(cu)])
    _build._run_all(cmds)
    return {cut: _build.bind(ctypes.CDLL(str(so)), ENTRY)
            for cut, so in sos.items()}


def device_ms(fn, n: int) -> float:
    return chip_smoke.device_time_ms(fn, n)


def main() -> int:
    if not torch.cuda.is_available():
        print("codec_probe: needs a CUDA device", file=sys.stderr)
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
    ex = chip_smoke.codec_exchange_indices(ops, X.shape)
    unit, _r, units = ex[0][1]
    k, ranks, upk = units.shape
    seg, rows = upk * unit, k * units.shape[1]
    elems = rows * seg
    lp = -(-seg // 256) * 256
    q = torch.empty((rows, lp), dtype=torch.int8, device="cuda")
    s = torch.empty((rows, lp // 256), device="cuda")
    out = torch.empty((rows, seg), device="cuda")
    wires = [ref.quantize_blocks_at(X, pay) for _t, pay in ex]
    it = [0]

    def cyc(n):
        it[0] = (it[0] + 1) % n
        return it[0]

    k2_bytes, k3_bytes = 5 * elems + elems // 64, 9 * elems + elems // 64
    emit(shape=[k, ranks, seg], exchanges=len(ex),
         k2_bound_ms=k2_bytes / HBM * 1e3, k3_bound_ms=k3_bytes / HBM * 1e3)
    n = 4 * len(ex)
    for cut, lib in libs.items():
        def k2(i=None):
            i = cyc(len(ex)) if i is None else i
            _t, (u, ridx, uidx) = ex[i]
            return lib.k2_quantize_blocks_at(
                X.data_ptr(), ridx.data_ptr(), uidx.data_ptr(), L, u, upk, k,
                ranks, q.data_ptr(), s.data_ptr(), seg, lp, 0, stream)

        def k3(i=None):
            i = cyc(len(ex)) if i is None else i
            (u, ridx, uidx), _p = ex[i]
            wq, ws = wires[i]
            return lib.k3_dequantize_blocks_at(
                wq.data_ptr(), ws.data_ptr(), X.data_ptr(), ridx.data_ptr(),
                uidx.data_ptr(), L, u, upk, k, ranks, out.data_ptr(), seg,
                lp, 0, 1, stream)

        rc = k2(0) or k3(0)
        torch.cuda.synchronize()
        if rc:
            raise SystemExit(f"codec_probe: {cut or 'shipped'} failed ({rc})")
        if cut != "no_div":
            bitwise = (torch.equal(q, wires[0][0]) and torch.equal(s, wires[0][1])
                       and torch.equal(out, ref.dequantize_blocks_at(
                           *wires[0], seg, X, ex[0][0], "add").reshape(rows, seg)))
            if not bitwise:
                raise SystemExit(f"codec_probe: {cut or 'shipped'} differs "
                                 f"from the plain version")
        emit(kernel="K2", what="indexed exchange", cut=cut or None,
             ms=device_ms(k2, n))
        if cut != "2_blocks":
            emit(kernel="K3 add", what="indexed exchange", cut=cut or None,
                 ms=device_ms(k3, n))
    # the identity region (contiguous operands) and PyTorch yardsticks,
    # over a pool of 14 tensors of one exchange's size
    pool = [torch.randn((rows, seg), generator=g, device="cuda")
            for _ in range(len(ex))]
    lib = libs[""]

    def k2c():
        x = pool[cyc(len(pool))]
        lib.k2_quantize_blocks(x.data_ptr(), q.data_ptr(), s.data_ptr(), rows,
                               seg, lp, 0, stream)

    def k3c():
        i = cyc(len(pool))
        lib.k3_dequantize_blocks(wires[i][0].data_ptr(), wires[i][1].data_ptr(),
                                 pool[i].data_ptr(), out.data_ptr(), rows,
                                 seg, lp, 0, 1, stream)

    emit(kernel="K2", what="contiguous, same size", ms=device_ms(k2c, n))
    emit(kernel="K3 add", what="contiguous, same size", ms=device_ms(k3c, n))
    codes = [w[0][:, :seg] for w in wires]
    emit(kernel="K2", what="x.to(torch.int8), same size",
         ms=device_ms(lambda: pool[cyc(len(pool))].to(torch.int8), n))
    emit(kernel="K3 add", what="torch.add(fp32, int8), same size",
         ms=device_ms(lambda: torch.add(pool[cyc(len(pool))], codes[it[0]],
                                        out=out), n))
    return 0


if __name__ == "__main__":
    sys.exit(main())
