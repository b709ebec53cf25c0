#!/usr/bin/env python3
"""Probe what bounds K5 (the port's embedding row gather) on an NVIDIA GPU.

Builds, from `src/repro_torch/kernels/csrc/embedding_gather.cu`, the
shipped kernel (one row per thread group, 128-thread blocks, a grid
sized to the work) and variants of it, "+"-joined cuts:

  rows_2, rows_4, rows_8  2, 4 or 8 rows in flight per thread group (all
                          their ids loaded, then all their rows);
  resident_grid           the grid capped at the blocks the card holds
                          resident, a grid-stride loop taking the rest;
  threads_256, _512       256- or 512-thread blocks;
  no_index                each row's id computed from its row number (a
                          hash), no id load: what the dependent id load
                          costs (gather only; not bitwise);
  stream_stores           the output stored with `st.global.cs`
                          (evict-first);

(`rows_4+resident_grid+threads_256` is this kernel's first design), and
the kernel as it was first ported (`first_port`: one row per 8-thread
group, the id load then the row load, 64-bit division, the grid capped
at 132 x 32 blocks), plus an empty kernel. At the DLRM shapes — the full
`CONFIG`'s 8 ranks x 100 tables x 500,000 rows x 32 fp32 (51.2 GB),
B = 32 and 2048, pools of 4 id sets — it times `gather_rows` and
`lookup_rows` of each variant; the shipped gather of the same number of
rows drawn from a 1 GB slice of the stack against all 51.2 GB (address
translation); `copy_` of the same bytes, contiguous; and the empty launch
at the shipped kernel's grid.
Every variant but `no_index` is first held bitwise against the plain
version. One JSON line per measurement with the card's `nvidia-smi` name
and power limit, then one `verdict` line per B naming the limit the
numbers point to:

  launch floor        the shipped gather within 1.5x the empty launch;
  dependent id load   no_index >= 15% faster;
  address translation the 1 GB slice >= 15% faster;
  bandwidth           within 1.25x `copy_` of the same bytes, and that
                      copy within 1.25x its own byte bound;
  copy latency        within 1.25x `copy_`, which is itself far from its
                      byte bound (a launch and a round trip);
  row-read latency    none of these.

Needs a card with 60 GB free and `nvcc`:

    python3 scripts/k5_probe.py
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402

OUT = ROOT / "build" / "k5_probe"
HBM = chip_smoke.HBM_BYTES_PER_S
ENTRY = ("k5_gather_rows", "k5_lookup_rows")
G, T, ROWS_L, D = 8, 100, 500_000, 32
POOL = 4

_ROWS = "constexpr int kRowsInFlight = 1;"
_THREADS = "constexpr int kThreads = 128;"
_GRID = "  const long long blocks = (rows + per_block - 1) / per_block;\n"
_RESIDENT = """  long long blocks = (rows + per_block - 1) / per_block;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, k5_rows_kernel<V, LOOKUP>, kThreads, 0);
  if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
"""
_ID = "const int id = __ldg(map.ids + g * map.sg + b * map.sb + t * map.st);"
_HASH = "const int id = (int)((r * 2654435761u) % (unsigned)map.rows_l);"
_STORE = "out[(long long)(base + group + k * gpb) * units + u] = v[k];"
_STORE_CS = "store_cs(out + (long long)(base + group + k * gpb) * units + u, v[k]);"
_CS_HELPERS = r'''
__device__ __forceinline__ void store_cs(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}
__device__ __forceinline__ void store_cs(uint2* p, uint2 v) {
  asm volatile("st.global.cs.v2.u32 [%0], {%1, %2};"
               :: "l"(p), "r"(v.x), "r"(v.y) : "memory");
}
__device__ __forceinline__ void store_cs(unsigned* p, unsigned v) {
  asm volatile("st.global.cs.u32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ void store_cs(unsigned short* p, unsigned short v) {
  asm volatile("st.global.cs.u16 [%0], %1;" :: "l"(p), "h"(v) : "memory");
}
__device__ __forceinline__ void store_cs(unsigned char* p, unsigned char v) {
  asm volatile("st.global.cs.u8 [%0], %1;"
               :: "l"(p), "h"((unsigned short)v) : "memory");
}
'''
_EMPTY = r'''
__global__ void k5_probe_empty_kernel() {}
extern "C" int k5_probe_empty(int blocks, int threads, void* stream) {
  k5_probe_empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
'''
# The K5 loop as first ported (16-byte units only, which the DLRM
# rows take): one row per group, the row load waiting on its id load.
_FIRST_PORT = r'''
#include <cuda_runtime.h>
__global__ void first_port_kernel(const uint4* __restrict__ table,
                            const int* __restrict__ idx,
                            uint4* __restrict__ out, long long rows,
                            long long B, long long V_rows, long long units,
                            int tpr) {
  const int lane = threadIdx.x % tpr;
  const long long per_block = blockDim.x / tpr;
  const long long stride = (long long)gridDim.x * per_block;
  for (long long row = blockIdx.x * per_block + threadIdx.x / tpr;
       row < rows; row += stride) {
    const long long g = row / B;
    const long long src = (g * V_rows + (long long)idx[row]) * units;
    const long long dst = row * units;
    for (long long u = lane; u < units; u += tpr) out[dst + u] = table[src + u];
  }
}
extern "C" int k5_gather_rows(const void* table, const void* idx, void* out,
                              long long G, long long V_rows, long long B,
                              long long row_bytes, int vec_bytes,
                              void* stream) {
  if (vec_bytes != 16) return 1;
  const long long rows = G * B, units = row_bytes / 16;
  int tpr = 1;
  while (tpr < 32 && tpr < units) tpr *= 2;
  const long long per_block = 256 / tpr;
  long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 132LL * 32) blocks = 132LL * 32;
  if (blocks < 1) blocks = 1;
  first_port_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const uint4*)table, (const int*)idx, (uint4*)out, rows, B, V_rows,
      units, tpr);
  return (int)cudaGetLastError();
}
'''
# a variant is "+"-joined cuts of the shipped source
VARIANTS = ("shipped", "rows_2", "rows_4", "rows_8", "resident_grid",
            "threads_256", "threads_512", "rows_4+resident_grid+threads_256",
            "no_index", "stream_stores", "first_port")


def variant_source(name: str) -> str:
    if name == "first_port":
        return _FIRST_PORT
    src = (ROOT / "src/repro_torch/kernels/csrc/embedding_gather.cu"
           ).read_text()
    src = src.replace('#include "common.cuh"',
                      f'#include "{ROOT}/src/repro_torch/kernels/csrc/common.cuh"')
    assert all(s in src for s in (_ROWS, _THREADS, _GRID, _ID, _STORE)), \
        "embedding_gather.cu changed"
    for cut in name.split("+"):
        if cut.startswith("rows_"):
            src = src.replace(_ROWS, _ROWS.replace("1", cut[5:]))
        if cut.startswith("threads_"):
            src = src.replace(_THREADS, _THREADS.replace("128", cut[8:]))
        if cut == "resident_grid":
            src = src.replace(_GRID, _RESIDENT)
        if cut == "no_index":
            src = src.replace(_ID, _HASH)
        if cut == "stream_stores":
            src = src.replace("namespace repro_torch {\n",
                              "namespace repro_torch {\n" + _CS_HELPERS, 1)
            src = src.replace(_STORE, _STORE_CS)
    return src + (_EMPTY if name == "shipped" else "")


def build_all() -> dict:
    """One library per variant, all nvcc processes started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    sos, cmds = {}, []
    for name in VARIANTS:
        cu = OUT / f"k5_{name.replace('+', '_')}.cu"
        cu.write_text(variant_source(name))
        sos[name] = cu.with_suffix(".so")
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                     str(sos[name]), str(cu)])
    _build._run_all(cmds)
    libs = {}
    for name, so in sos.items():
        lib = ctypes.CDLL(str(so))
        libs[name] = _build.bind(lib, ENTRY[:1] if name == "first_port"
                                 else ENTRY)
    libs["shipped"].k5_probe_empty.argtypes = [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
    return libs


def verdict(m: dict) -> str:
    if m["gather"] <= 1.5 * m["empty"]:
        return "launch floor"
    if m["no_index"] <= 0.85 * m["gather"]:
        return "dependent id load"
    if m["slice_1gb"] <= 0.85 * m["all_51gb"]:
        return "address translation"
    if m["gather"] <= 1.25 * m["copy"]:
        return ("bandwidth" if m["copy"] <= 1.25 * m["copy_bound"]
                else "copy latency")
    return "row-read latency"


def shipped_rows_per_block() -> tuple:
    """(rows, threads) of one block of the shipped kernel (128-byte
    rows)."""
    src = (ROOT / "src/repro_torch/kernels/csrc/embedding_gather.cu"
           ).read_text()
    threads = int(re.search(r"kThreads = (\d+);", src).group(1))
    rows = int(re.search(r"kRowsInFlight = (\d+);", src).group(1))
    return threads // 8 * rows, threads


def main() -> int:
    if not torch.cuda.is_available():
        print("k5_probe: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    libs = build_all()

    def emit(**kw):
        print(json.dumps({**kw, "card": card}), flush=True)

    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device="cuda").manual_seed(0)
    tables = torch.empty((G, T, ROWS_L, D), device="cuda")
    tables.normal_(generator=g)
    stack = tables.view(G * T, ROWS_L, D)
    flat = tables.view(1, -1, D)
    slice_rows = 2**30 // (D * 4)              # 1 GiB of rows
    lo = torch.arange(G, device="cuda") * ROWS_L
    it = [0]

    def cyc():
        it[0] = (it[0] + 1) % POOL
        return it[0]

    def ms(fn, n):
        return chip_smoke.device_time_ms(fn, n)

    for B in (32, 2048):
        n = 400 if B == 32 else 40
        idx = [torch.randint(0, ROWS_L, (G * T, B), generator=g,
                             device="cuda", dtype=torch.int32)
               for _ in range(POOL)]
        req = [torch.randint(0, G * ROWS_L, (B, T), generator=g,
                             device="cuda", dtype=torch.int32)
               for _ in range(POOL)]
        ids = [r[None].expand(G, B, T) for r in req]
        out_g = torch.empty((G * T, B, D), device="cuda")
        out_l = torch.empty((G, B, T * D), device="cuda")
        want_g = ref.gather_rows(stack, idx[0])
        want_l = ref.lookup_rows(tables, ids[0], lo)
        rows = G * T * B
        gather_bytes = 2 * rows * D * 4 + rows * 4
        lookup_bytes = G * B * T * D * 4 + B * T * D * 4 + B * T * 4 + G * 8
        emit(B=B, rows=rows, gather_bound_ms=gather_bytes / HBM * 1e3,
             lookup_bound_ms=lookup_bytes / HBM * 1e3)
        summary = {}
        for name, lib in libs.items():
            def gather(i=None, lib=lib):
                i = cyc() if i is None else i
                return lib.k5_gather_rows(stack.data_ptr(), idx[i].data_ptr(),
                                          out_g.data_ptr(), G * T, ROWS_L, B,
                                          D * 4, 16, stream)

            def lookup(i=None, lib=lib):
                i = cyc() if i is None else i
                return lib.k5_lookup_rows(
                    tables.data_ptr(), ids[i].data_ptr(), lo.data_ptr(),
                    out_l.data_ptr(), G, T, ROWS_L, B, *ids[i].stride(),
                    D * 4, 16, stream)

            rc = gather(0) or (name != "first_port" and lookup(0))
            torch.cuda.synchronize()
            if rc:
                raise SystemExit(f"k5_probe: {name} failed (rc {rc})")
            if name != "no_index" and not (
                    torch.equal(out_g, want_g) and
                    (name == "first_port" or torch.equal(out_l, want_l))):
                raise SystemExit(f"k5_probe: {name} differs from the plain "
                                 f"version at B = {B}")
            t = ms(gather, n)
            summary.setdefault("variants", {})[name] = t
            emit(B=B, entry="gather_rows", variant=name, ms=t)
            if name not in ("first_port", "no_index"):
                emit(B=B, entry="lookup_rows", variant=name,
                     ms=ms(lookup, n))
        lib = libs["shipped"]
        for what, hi in (("slice_1gb", slice_rows),
                         ("all_51gb", G * T * ROWS_L)):
            fidx = [torch.randint(0, hi, (1, rows), generator=g,
                                  device="cuda", dtype=torch.int32)
                    for _ in range(POOL)]
            out_f = torch.empty((1, rows, D), device="cuda")
            summary[what] = ms(lambda: lib.k5_gather_rows(
                flat.data_ptr(), fidx[cyc()].data_ptr(), out_f.data_ptr(), 1,
                flat.shape[1], rows, D * 4, 16, stream), n)
            emit(B=B, entry="gather_rows", variant="shipped", rows_from=what,
                 ms=summary[what])
            del fidx, out_f
        src = [torch.randn((rows, D), generator=g, device="cuda")
               for _ in range(POOL)]
        summary["copy"] = ms(lambda: out_g.view(rows, D).copy_(src[cyc()]), n)
        summary["copy_bound"] = 2 * rows * D * 4 / HBM * 1e3
        emit(B=B, what="copy_ of the same bytes, contiguous",
             ms=summary["copy"])
        del src
        per_block, threads = shipped_rows_per_block()
        for nb in (1, -(-rows // per_block)):      # the shipped grid
            t = ms(lambda nb=nb: lib.k5_probe_empty(nb, threads, stream), n)
            emit(B=B, what="empty launch", blocks=nb, threads=threads, ms=t)
        summary["empty"] = t
        summary["gather"] = summary["variants"]["shipped"]
        summary["no_index"] = summary["variants"]["no_index"]
        emit(B=B, verdict=verdict(summary),
             **{k: v for k, v in summary.items() if k != "variants"},
             gather_bound_ms=gather_bytes / HBM * 1e3)
    return 0


if __name__ == "__main__":
    sys.exit(main())
