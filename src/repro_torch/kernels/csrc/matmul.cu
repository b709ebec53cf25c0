// K4: batched tiled matrix product, C[g] = A[g] @ B[g], fp32 accumulate.
//
// Replaces the TPU kernel repro/kernels/matmul.py::matmul_tiled (body
// `_kernel`), which walked (256, 256, 256) MXU tiles with the fp32
// accumulator held in VMEM across the sequential K grid dimension and
// cast on the last K step; its wrapper padded M, K, N to 128-multiples.
//
// Here the K dimension is a loop inside the block (blocks run in no
// order, so nothing carries across them): each block owns one 64 x 64
// output tile of one batch entry (blockIdx.z = g, the stacked ranks, so
// one launch serves every rank), walks K in 16-deep slabs staged through
// shared memory, and keeps a 4 x 4 fp32 accumulator per thread in
// registers. The cast to the output type happens once, at the store.
// Ragged M, N and K tails are masked (zeros loaded past the edge), not
// padded in memory.
//
// Arithmetic: IEEE fp32 FFMA, never TF32, and every product-add is an
// explicit __fmaf_rn — the library builds with -fmad=false, under which a
// plain `acc += a * b` would round twice. Each output is the fma chain
// over k = 0..K-1 in order; it differs from another summation order by
// at most ~2 K 2^-24 (|A| @ |B|) per element.
//
// Bound on the H100: at the DLRM FC1 shapes (8 ranks x (B, 400) @
// (400, 2048)) bytes at small batch (B = 32: 28.7 MB, ~8.6 us at
// 3.35 TB/s) and fp32 operations at large batch (B = 2048: 26.8 GFLOP,
// ~0.40 ms at 67 TFLOP/s). This first kernel is a plain SIMT tiling;
// wgmma/TMA tiles are later work.
#include "common.cuh"

namespace repro_torch {

constexpr int MM_BM = 64;
constexpr int MM_BN = 64;
constexpr int MM_BK = 16;
constexpr int MM_TM = 4;       // outputs per thread along M
constexpr int MM_TN = 4;       // outputs per thread along N
constexpr int MM_THREADS = (MM_BM / MM_TM) * (MM_BN / MM_TN);   // 256
constexpr int MM_PAD = 4;      // keeps rows 16-byte aligned for float4

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(MM_THREADS)
matmul_tiled_kernel(const Tin* __restrict__ A, const Tin* __restrict__ B,
                    Tout* __restrict__ C, int M, int K, int N) {
  __shared__ __align__(16) float As[MM_BK][MM_BM + MM_PAD];  // As[k][m]
  __shared__ __align__(16) float Bs[MM_BK][MM_BN + MM_PAD];  // Bs[k][n]
  const long long g = blockIdx.z;
  A += g * M * (long long)K;
  B += g * K * (long long)N;
  C += g * M * (long long)N;
  const int m0 = blockIdx.y * MM_BM;
  const int n0 = blockIdx.x * MM_BN;
  const int tid = threadIdx.x;
  const int tr = tid / (MM_BN / MM_TN);   // 0..15: output row group
  const int tc = tid % (MM_BN / MM_TN);   // 0..15: output column group

  float acc[MM_TM][MM_TN];
#pragma unroll
  for (int i = 0; i < MM_TM; ++i)
#pragma unroll
    for (int j = 0; j < MM_TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += MM_BK) {
    // A slab: BM x BK, consecutive threads along k of one row
#pragma unroll
    for (int e = tid; e < MM_BM * MM_BK; e += MM_THREADS) {
      const int r = e / MM_BK, c = e % MM_BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? to_f32(A[(long long)gm * K + gk]) : 0.f;
    }
    // B slab: BK x BN, consecutive threads along n (coalesced)
#pragma unroll
    for (int e = tid; e < MM_BK * MM_BN; e += MM_THREADS) {
      const int r = e / MM_BN, c = e % MM_BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? to_f32(B[(long long)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < MM_BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][tr * MM_TM]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tc * MM_TN]);
      const float av[MM_TM] = {a.x, a.y, a.z, a.w};
      const float bv[MM_TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < MM_TM; ++i)
#pragma unroll
        for (int j = 0; j < MM_TN; ++j)
          acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MM_TM; ++i) {
    const int gm = m0 + tr * MM_TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < MM_TN; ++j) {
      const int gn = n0 + tc * MM_TN + j;
      if (gn < N) C[(long long)gm * N + gn] = from_f32<Tout>(acc[i][j]);
    }
  }
}

template <typename Tin, typename Tout>
static void launch(const void* a, const void* b, void* c, long long G,
                   int M, int K, int N, cudaStream_t stream) {
  dim3 grid((N + MM_BN - 1) / MM_BN, (M + MM_BM - 1) / MM_BM, (unsigned)G);
  matmul_tiled_kernel<Tin, Tout><<<grid, MM_THREADS, 0, stream>>>(
      static_cast<const Tin*>(a), static_cast<const Tin*>(b),
      static_cast<Tout*>(c), M, K, N);
}

}  // namespace repro_torch

using namespace repro_torch;

// a: (G, M, K), b: (G, K, N), c: (G, M, N), all contiguous. The wrapper
// checks G <= 65535 and M, K, N < 2^31 (and M / 64 <= 65535). Returns the
// launch's cudaGetLastError() (0 on success).
extern "C" int k4_matmul_tiled(const void* a, const void* b, void* c,
                               long long G, long long M, long long K,
                               long long N, int in_dtype, int out_dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = (int)M, k = (int)K, n = (int)N;
  if (in_dtype == DT_F32 && out_dtype == DT_F32)
    launch<float, float>(a, b, c, G, m, k, n, s);
  else if (in_dtype == DT_F32 && out_dtype == DT_BF16)
    launch<float, __nv_bfloat16>(a, b, c, G, m, k, n, s);
  else if (in_dtype == DT_BF16 && out_dtype == DT_F32)
    launch<__nv_bfloat16, float>(a, b, c, G, m, k, n, s);
  else if (in_dtype == DT_BF16 && out_dtype == DT_BF16)
    launch<__nv_bfloat16, __nv_bfloat16>(a, b, c, G, m, k, n, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
