#!/usr/bin/env python3
"""Probe what bounds K4 (the port's fp32 tiled matmul) on an NVIDIA GPU.

Builds, from `src/repro_torch/kernels/csrc/matmul.cu`, the shipped tile
configurations and some alternatives, each also with the FMAs cut to one
row per thread (`one_fma_row`, mostly loads) or with the
main-loop slab loads removed (`no_load`, FMAs only); and a shared-memory
load microbenchmark. Times each at the DLRM FC1 shapes (8 ranks x (B,
400) @ (400, 2048), B = 32 and 2048) against `torch.bmm` (no TF32), plus
the small-M configuration at K = 16 and K = 1600 and a plain `w.sum()`
over the 26 MB weight, and prints one JSON line per measurement with the
card's `nvidia-smi` name and power limit. Needs a card and `nvcc`:

    python3 scripts/k4_probe.py
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
from repro_torch.kernels import _build  # noqa: E402

OUT = ROOT / "build" / "k4_probe"

# name -> (MMConfig arguments, B it is timed at)
VARIANTS = {
    "small_m32 (shipped)": ("MMSmall32", 32),
    "small 32x32, 2x4/thread": ("MMConfig<32, 32, 32, 16, 8, 4, 6, false>", 32),
    "small 32x64, 8x4/thread": ("MMConfig<32, 64, 32, 4, 16, 4, 6, false>", 32),
    "small 32x128, 4x8/thread": ("MMConfig<32, 128, 32, 8, 16, 4, 2, false>", 32),
    "small 32x64, BK 16, 6 stages": ("MMConfig<32, 64, 16, 8, 16, 6, 3, false>", 32),
    "small 32x64, BK 64, 3 stages": ("MMConfig<32, 64, 64, 8, 16, 3, 3, false>", 32),
    "large_m (shipped, A k-major)": ("MMLarge", 2048),
    "large, A k-major, 2 stages": ("MMConfig<128, 128, 16, 16, 16, 2, 2, true>", 2048),
    "large, A k-major, 4 stages": ("MMConfig<128, 128, 16, 16, 16, 4, 2, true>", 2048),
    "large, A m-major": ("MMConfig<128, 128, 16, 16, 16, 3, 2, false>", 2048),
    "large, 8x16/thread, A m-major": ("MMConfig<128, 128, 16, 16, 8, 3, 2, false>", 2048),
    "large, 8x16/thread, A k-major": ("MMConfig<128, 128, 16, 16, 8, 3, 2, true>", 2048),
}
DIAGS = ("", "one_fma_row", "no_load")

SMEM_BENCH = r'''
template <int PAT, bool V4>
__global__ void smem_bench(float* out, long long* cyc, int iters) {
  __shared__ __align__(16) float s[8192];
  for (int i = threadIdx.x; i < 8192; i += blockDim.x) s[i] = i * 0.5f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int idx = PAT == 0 ? 0 : PAT == 1 ? (lane & 7) : PAT == 2 ? (lane >> 3) : lane;
  const int base = V4 ? idx * 4 : idx;
  float acc = 0.f;
  long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const unsigned addr = (unsigned)__cvta_generic_to_shared(
          &s[base + (it & 15) * 256 + u * 512 % 4096]);
      if (V4) {
        float x, y, z, w;
        asm volatile("ld.shared.v4.f32 {%0,%1,%2,%3}, [%4];"
                     : "=f"(x), "=f"(y), "=f"(z), "=f"(w) : "r"(addr));
        acc += x + y + z + w;
      } else {
        float x;
        asm volatile("ld.shared.f32 %0, [%1];" : "=f"(x) : "r"(addr));
        acc += x;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) cyc[blockIdx.x] = clock64() - t0;
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

// SM cycles per warp-wide shared load; 16 warps per SM, 132 blocks.
extern "C" double probe_smem(int pat, int v4) {
  float* out; long long* cyc; long long c = 0;
  const int iters = 4096;
  cudaMalloc(&out, 132 * 512 * 4);
  cudaMalloc(&cyc, 132 * 8);
  if (v4) {
    if (pat == 0) smem_bench<0, true><<<132, 512>>>(out, cyc, iters);
    if (pat == 1) smem_bench<1, true><<<132, 512>>>(out, cyc, iters);
    if (pat == 2) smem_bench<2, true><<<132, 512>>>(out, cyc, iters);
    if (pat == 3) smem_bench<3, true><<<132, 512>>>(out, cyc, iters);
  } else {
    if (pat == 0) smem_bench<0, false><<<132, 512>>>(out, cyc, iters);
    if (pat == 3) smem_bench<3, false><<<132, 512>>>(out, cyc, iters);
  }
  cudaDeviceSynchronize();
  cudaMemcpy(&c, cyc, 8, cudaMemcpyDeviceToHost);
  cudaFree(out);
  cudaFree(cyc);
  return (double)c / (16.0 * iters * 8);
}
'''


def probe_source(diag: str) -> str:
    """matmul.cu with the probe's cuts, the variants and the smem bench."""
    src = (ROOT / "src/repro_torch/kernels/csrc/matmul.cu").read_text()
    src = src.replace('#include "common.cuh"',
                      f'#include "{ROOT}/src/repro_torch/kernels/csrc/common.cuh"')
    fmas = ("acc[i][j] = __fmaf_rn(a[i][kk], b[j], acc[i][j]);",
            "acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);")
    load = "    const int next = t + STAGES - 1;"
    assert all(f in src for f in fmas) and load in src, "matmul.cu changed"
    if diag == "one_fma_row":
        for f in fmas:
            src = src.replace(f, "if (i == 0) " + f)
    if diag == "no_load":
        src = src.replace(load, "    const int next = nk;")
    cases = "\n".join(
        f"    case {i}: rc = launch_cfg<float, float, {cfg}, true>"
        f"(a, b, c, G, m, k, n, s); break;"
        for i, (cfg, _b) in enumerate(VARIANTS.values()))
    return src + SMEM_BENCH + f'''
extern "C" int probe_k4(const void* a, const void* b, void* c, long long G,
                        long long M, long long K, long long N, int v,
                        void* stream) {{
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = (int)M, k = (int)K, n = (int)N;
  int rc;
  switch (v) {{
{cases}
    default: return 1;
  }}
  return rc ? rc : (int)cudaGetLastError();
}}
'''


def build_all() -> dict:
    """One library per cut, all nvcc processes started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    sos, cmds = {}, []
    for diag in DIAGS:
        cu = OUT / f"probe_{diag or 'full'}.cu"
        cu.write_text(probe_source(diag))
        sos[diag] = cu.with_suffix(".so")
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                     str(sos[diag]), str(cu)])
    _build._run_all(cmds)
    libs = {}
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for diag, so in sos.items():
        lib = libs[diag] = ctypes.CDLL(str(so))
        lib.probe_k4.argtypes = [p, p, p, ll, ll, ll, ll, i, p]
        lib.probe_smem.argtypes = [i, i]
        lib.probe_smem.restype = ctypes.c_double
    return libs


def device_ms(fn, n: int) -> float:
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_probe: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    libs = build_all()

    def emit(**kw):
        print(json.dumps({**kw, "card": card}), flush=True)

    for pat, v4, name in ((0, 1, "LDS.128 uniform"),
                          (2, 1, "LDS.128, 4 distinct 16 B"),
                          (1, 1, "LDS.128, 8 distinct 16 B"),
                          (3, 1, "LDS.128, 32 distinct"),
                          (0, 0, "LDS.32 uniform"), (3, 0, "LDS.32, 32 distinct")):
        emit(smem=name, sm_cycles_per_warp_load=libs[""].probe_smem(pat, v4))
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device="cuda").manual_seed(0)
    R, N, pool = 8, 2048, 4
    it = [0]

    def cyc():
        it[0] = (it[0] + 1) % pool
        return it[0]

    for K, B in ((400, 32), (400, 2048), (16, 32), (1600, 32)):
        xs = [torch.randn((R, B, K), generator=g, device="cuda") * 0.01
              for _ in range(pool)]
        ws = [torch.randn((R, K, N), generator=g, device="cuda")
              for _ in range(pool)]
        out = torch.empty((R, B, N), device="cuda")
        n = 200 if B == 32 else 10
        emit(K=K, B=B, what="torch.bmm",
             ms=device_ms(lambda: torch.bmm(xs[cyc()], ws[it[0]]), n))
        if (K, B) == (400, 32):
            emit(K=K, B=B, what="w.sum()",
                 ms=device_ms(lambda: ws[cyc()].sum(), n))
        want = torch.bmm(xs[0].double(), ws[0].double())
        bound = 2 * K * 2.0 ** -24 * torch.bmm(xs[0].double().abs(),
                                               ws[0].double().abs())
        for v, (name, (_cfg, vb)) in enumerate(VARIANTS.items()):
            if vb != B or (K != 400 and "shipped" not in name):
                continue
            for diag in DIAGS if K == 400 else ("",):
                lib = libs[diag]

                def run(j=0):
                    return lib.probe_k4(xs[j].data_ptr(), ws[j].data_ptr(),
                                        out.data_ptr(), R, B, K, N, v, stream)

                rc = run()
                torch.cuda.synchronize()
                ok = rc == 0 and bool(((out.double() - want).abs()
                                       <= bound).all())
                if rc or (not diag and not ok):
                    raise SystemExit(f"k4_probe: {name} failed (rc {rc})")
                emit(K=K, B=B, what=name, cut=diag or None,
                     ms=device_ms(lambda: run(cyc()), n))
    return 0


if __name__ == "__main__":
    sys.exit(main())
