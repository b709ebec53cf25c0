// K4: batched tiled matrix product, C[g] = A[g] @ B[g], fp32 accumulate.
//
// Replaces the TPU kernel repro/kernels/matmul.py::matmul_tiled (body
// `_kernel`), which walked (256, 256, 256) MXU tiles with the fp32
// accumulator held in VMEM across the sequential K grid dimension and
// cast on the last K step; its wrapper padded M, K, N to 128-multiples.
//
// Here the K dimension is a loop inside the block (blocks run in no
// order, so nothing carries across them): each block owns one output
// tile of one batch entry (blockIdx.z = g, the stacked ranks, so one
// launch serves every rank), walks K in BK-deep slabs through a ring of
// STAGES shared-memory stages, and keeps its outputs in registers. The
// stages are filled with cp.async (16-byte copies, zero-filled past the
// M/N/K edges), so the loads of slab s + STAGES - 1 are in flight while
// slab s is multiplied; one __syncthreads per slab. The cast to the
// output type happens once, at the store. Nothing is padded in memory.
//
// Arithmetic: IEEE fp32 FFMA, never TF32, and every product-add is an
// explicit __fmaf_rn — the library builds with -fmad=false, under which a
// plain `acc += a * b` would round twice. Each output is the fma chain
// over k = 0..K-1 in order (K is never split across blocks); it differs
// from another summation order by at most ~2 K 2^-24 (|A| @ |B|) per
// element. bf16 inputs take the same kernels, converted to fp32 as they
// are staged (plain loads instead of cp.async).
//
// Bounds on the H100 at the DLRM FC1 shapes, 8 ranks x (B, 400) @
// (400, 2048), and what each configuration does about its bound:
//  * B = 32, bytes: the 26.2 MB weight streamed once, 28.7 MB in all,
//    ~8.6 us at 3.35 TB/s. The small-M configuration (M <= 64) covers all
//    of M in one block tile (32 or 64 rows, none wasted at M = 32), cuts
//    N into 64-wide tiles (32 x 8 = 256 blocks of 128 threads, several
//    per SM) and keeps 4 stages of 32-deep slabs in flight: ~24 KB of
//    weight per block, enough by Little's law to hold HBM near its peak.
//    Every weight byte is read once; A (51 KB a rank) comes from L2.
//  * B = 2048, fp32 operations: 26.8 GFLOP, ~0.40 ms at 67 TFLOP/s. The
//    large-M configuration runs 128 x 128 tiles (16 x 16 x 8 = 2048
//    blocks) of 256 threads with 8 x 8 outputs each, 64 FFMA per 4
//    shared-memory vector loads; 3 stages of 16-deep slabs hide the
//    global loads behind the FFMA stream.
//
// Shared-memory layout: A is staged as it lies (m-major, rows padded to
// BK + 4 floats) and read along k as float4, B k-major and read along n
// as float4. A thread's rows are interleaved (tr + TR i) and its columns
// split in float4 groups TC * 4 apart, and a warp covers 4 x 8 threads:
// its four A rows fall in distinct bank groups and its eight B vectors
// are 128 contiguous bytes, so neither read conflicts.
//
// Rows that are not 16-byte aligned (K or N not a multiple of 4, or an
// unaligned base) take 4-byte cp.async copies into the same layout.
#include "common.cuh"

#include <type_traits>

namespace repro_torch {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async with zero-fill: `valid` false copies nothing and writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A block tile BM x BN of TR x TC threads (TM x TN outputs each), BK-deep
// slabs, STAGES stages; MIN_BLOCKS per SM for __launch_bounds__.
template <int BM_, int BN_, int BK_, int TR_, int TC_, int STAGES_,
          int MIN_BLOCKS_, bool AK_>
struct MMConfig {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TR = TR_, TC = TC_;
  static constexpr int STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_;
  // A staged as it lies, m-major by cp.async (false), or k-major: read
  // into registers one slab ahead and stored transposed (true)
  static constexpr bool AK = AK_;
  static constexpr int THREADS = TR * TC;
  static constexpr int TM = BM / TR, TN = BN / TC;
  // As[m][k] (row stride BK + 4) or, AK, As[k][m] (row stride BM + 4)
  static constexpr int LDA = AK ? BM + 4 : BK + 4;
  static constexpr int LDB = BN;                // Bs[k][n] row stride
  static constexpr int A_FLOATS = AK ? BK * LDA : BM * LDA;
  static constexpr int STAGE_FLOATS = A_FLOATS + BK * LDB;
  static constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;
  static_assert(TR % 4 == 0 && TC % 8 == 0, "a warp covers 4 x 8 threads");
  static_assert(BM % TR == 0 && BN % (TC * 4) == 0 && BK % 4 == 0,
                "tile shape");
  static_assert(!AK || (BM % (TR * 4) == 0), "k-major A: float4 rows");
};

using MMSmall32 = MMConfig<32, 64, 32, 8, 16, 4, 3, false>;
using MMSmall64 = MMConfig<64, 64, 32, 8, 16, 4, 2, false>;
using MMLarge = MMConfig<128, 128, 16, 16, 16, 3, 2, true>;

// Stage a ROWS x COLS tile of a row-major matrix (row length ld, R x C
// valid) at (r0, c0) into shared memory with row stride LD; zeros past
// the edges. fp32: cp.async of 16 bytes (VEC) or 4 bytes; bf16: plain
// loads converted to fp32.
template <typename Tin, int ROWS, int COLS, int LD, int THREADS, bool VEC>
__device__ __forceinline__ void stage_tile(float* dst,
                                           const Tin* __restrict__ src,
                                           long long ld, int r0, int c0,
                                           int R, int C, int tid) {
  constexpr int W = VEC ? 4 : 1;
  constexpr int PER_ROW = COLS / W;
  constexpr int CHUNKS = ROWS * PER_ROW;
  static_assert(CHUNKS % THREADS == 0, "tile chunks per thread");
#pragma unroll
  for (int i = 0; i < CHUNKS / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int r = e / PER_ROW, c = (e % PER_ROW) * W;
    const int gr = r0 + r, gc = c0 + c;
    const bool ok = gr < R && gc < C;
    float* d = dst + r * LD + c;
    if constexpr (std::is_same<Tin, float>::value) {
      const float* s = ok ? src + gr * ld + gc : src;
      if constexpr (VEC)
        cp_async16(d, s, ok);
      else
        cp_async4(d, s, ok);
    } else {
      static_assert(!VEC, "bf16 is staged element by element");
      *d = ok ? to_f32(src[gr * ld + gc]) : 0.f;
    }
  }
}

// k-major A: a BM x BK slab of A read into registers (W consecutive k of
// one row per chunk; consecutive threads take consecutive rows) and
// stored transposed, As[k][m].
template <typename Tin, class CF, bool VEC>
struct AStage {
  static constexpr int W = VEC ? 4 : 1;
  static constexpr int CHUNKS = CF::BM * CF::BK / W / CF::THREADS;
  static_assert((CF::BM * CF::BK / W) % CF::THREADS == 0, "A chunks");
  float v[CHUNKS][W];

  __device__ __forceinline__ void load(const Tin* __restrict__ A, int K,
                                       int M, int m0, int k0, int tid) {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int e = tid + i * CF::THREADS;
      const int r = e % CF::BM, c = (e / CF::BM) * W;
      const int gm = m0 + r, gk = k0 + c;
      const bool ok = gm < M && gk < K;
      if constexpr (VEC) {
        const float4 x = ok ? __ldg(reinterpret_cast<const float4*>(
                                  A + (long long)gm * K + gk))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        v[i][0] = x.x; v[i][1] = x.y; v[i][2] = x.z; v[i][3] = x.w;
      } else {
        v[i][0] = ok ? to_f32(A[(long long)gm * K + gk]) : 0.f;
      }
    }
  }
  __device__ __forceinline__ void store(float* As, int tid) const {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int e = tid + i * CF::THREADS;
      const int r = e % CF::BM, c = (e / CF::BM) * W;
#pragma unroll
      for (int q = 0; q < W; ++q) As[(c + q) * CF::LDA + r] = v[i][q];
    }
  }
};

template <typename Tin, typename Tout, class CF, bool VEC>
__global__ void __launch_bounds__(CF::THREADS, CF::MIN_BLOCKS)
matmul_tiled_kernel(const Tin* __restrict__ A, const Tin* __restrict__ B,
                    Tout* __restrict__ C, int M, int K, int N) {
  constexpr int BM = CF::BM, BN = CF::BN, BK = CF::BK, TR = CF::TR,
                TC = CF::TC, TM = CF::TM, TN = CF::TN, STAGES = CF::STAGES,
                THREADS = CF::THREADS, LDA = CF::LDA, LDB = CF::LDB;
  extern __shared__ __align__(16) float smem[];
  const long long g = blockIdx.z;
  A += g * M * (long long)K;
  B += g * K * (long long)N;
  C += g * M * (long long)N;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tr = (warp / (TC / 8)) * 4 + (lane >> 3);   // 0..TR-1
  const int tc = (warp % (TC / 8)) * 8 + (lane & 7);    // 0..TC-1

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int nk = (K + BK - 1) / BK;
  auto stage_of = [&](int slab) {
    return smem + (slab % STAGES) * CF::STAGE_FLOATS;
  };
  auto stage_b = [&](int slab) {
    stage_tile<Tin, BK, BN, LDB, THREADS, VEC>(stage_of(slab) + CF::A_FLOATS,
                                              B, N, slab * BK, n0, K, N, tid);
  };
  AStage<Tin, CF, VEC> areg;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      if constexpr (CF::AK) {
        areg.load(A, K, M, m0, s * BK, tid);
        areg.store(stage_of(s), tid);
      } else {
        stage_tile<Tin, BM, BK, LDA, THREADS, VEC>(stage_of(s), A, K, m0,
                                                  s * BK, M, K, tid);
      }
      stage_b(s);
    }
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<STAGES - 2>();   // slab t has landed (this thread's part)
    __syncthreads();               // ... everyone's; slab t - 1 is consumed
    const int next = t + STAGES - 1;
    if (next < nk) {
      if constexpr (CF::AK)
        areg.load(A, K, M, m0, next * BK, tid);   // stored after slab t
      else
        stage_tile<Tin, BM, BK, LDA, THREADS, VEC>(stage_of(next), A, K, m0,
                                                  next * BK, M, K, tid);
      stage_b(next);
    }
    cp_async_commit();
    const float* As = stage_of(t);
    const float* Bs = As + CF::A_FLOATS;
    if constexpr (CF::AK) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int iq = 0; iq < TM / 4; ++iq) {
          const float4 v = *reinterpret_cast<const float4*>(
              As + kk * LDA + tr * 4 + TR * 4 * iq);
          a[iq * 4 + 0] = v.x; a[iq * 4 + 1] = v.y;
          a[iq * 4 + 2] = v.z; a[iq * 4 + 3] = v.w;
        }
#pragma unroll
        for (int jq = 0; jq < TN / 4; ++jq) {
          const float4 v = *reinterpret_cast<const float4*>(
              Bs + kk * LDB + tc * 4 + TC * 4 * jq);
          b[jq * 4 + 0] = v.x; b[jq * 4 + 1] = v.y;
          b[jq * 4 + 2] = v.z; b[jq * 4 + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
      }
      if (next < nk) areg.store(stage_of(next), tid);
      continue;
    }
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float a[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 v =
            *reinterpret_cast<const float4*>(As + (tr + TR * i) * LDA + kq);
        a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b[TN];
#pragma unroll
        for (int jq = 0; jq < TN / 4; ++jq) {
          const float4 v = *reinterpret_cast<const float4*>(
              Bs + (kq + kk) * LDB + tc * 4 + TC * 4 * jq);
          b[jq * 4 + 0] = v.x; b[jq * 4 + 1] = v.y;
          b[jq * 4 + 2] = v.z; b[jq * 4 + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = __fmaf_rn(a[i][kk], b[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    // rows tr + TR i, or, AK, float4 groups tr * 4 + TR * 4 * (i / 4)
    const int gm = m0 + (CF::AK ? tr * 4 + TR * 4 * (i / 4) + i % 4
                                : tr + TR * i);
    if (gm >= M) continue;
    Tout* row = C + (long long)gm * N;
#pragma unroll
    for (int jq = 0; jq < TN / 4; ++jq) {
      const int gn = n0 + tc * 4 + TC * 4 * jq;
      if constexpr (VEC && std::is_same<Tout, float>::value) {
        if (gn < N)
          *reinterpret_cast<float4*>(row + gn) =
              make_float4(acc[i][jq * 4 + 0], acc[i][jq * 4 + 1],
                          acc[i][jq * 4 + 2], acc[i][jq * 4 + 3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (gn + c < N) row[gn + c] = from_f32<Tout>(acc[i][jq * 4 + c]);
      }
    }
  }
}

template <typename Tin, typename Tout, class CF, bool VEC>
static int launch_cfg(const void* a, const void* b, void* c, long long G,
                      int M, int K, int N, cudaStream_t stream) {
  auto kernel = matmul_tiled_kernel<Tin, Tout, CF, VEC>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CF::SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((N + CF::BN - 1) / CF::BN, (M + CF::BM - 1) / CF::BM,
            (unsigned)G);
  kernel<<<grid, CF::THREADS, CF::SMEM_BYTES, stream>>>(
      static_cast<const Tin*>(a), static_cast<const Tin*>(b),
      static_cast<Tout*>(c), M, K, N);
  return 0;
}

// config: 0 small-M (M <= 32), 1 small-M (M <= 64), 2 large-M
template <typename Tin, typename Tout, bool VEC>
static int launch(const void* a, const void* b, void* c, long long G, int M,
                  int K, int N, int config, cudaStream_t stream) {
  switch (config) {
    case 0: return launch_cfg<Tin, Tout, MMSmall32, VEC>(a, b, c, G, M, K, N, stream);
    case 1: return launch_cfg<Tin, Tout, MMSmall64, VEC>(a, b, c, G, M, K, N, stream);
    case 2: return launch_cfg<Tin, Tout, MMLarge, VEC>(a, b, c, G, M, K, N, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename Tin, typename Tout>
static int dispatch_vec(const void* a, const void* b, void* c, long long G,
                        int M, int K, int N, int config, int vec,
                        cudaStream_t stream) {
  if constexpr (std::is_same<Tin, float>::value) {
    if (vec) return launch<Tin, Tout, true>(a, b, c, G, M, K, N, config, stream);
  } else {
    if (vec) return (int)cudaErrorInvalidValue;
  }
  return launch<Tin, Tout, false>(a, b, c, G, M, K, N, config, stream);
}

}  // namespace repro_torch

using namespace repro_torch;

// a: (G, M, K), b: (G, K, N), c: (G, M, N), all contiguous. `config`
// picks the tile configuration (0: M <= 32, 1: M <= 64, 2: any M) and
// `vec` the 16-byte cp.async path (fp32 inputs, K and N multiples of 4,
// 16-byte aligned bases); the wrapper chooses both and checks G <= 65535
// and M, K, N < 2^31. Returns the launch's cudaGetLastError() (0 on
// success).
extern "C" int k4_matmul_tiled(const void* a, const void* b, void* c,
                               long long G, long long M, long long K,
                               long long N, int in_dtype, int out_dtype,
                               int config, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = (int)M, k = (int)K, n = (int)N;
  int rc;
  if (in_dtype == DT_F32 && out_dtype == DT_F32)
    rc = dispatch_vec<float, float>(a, b, c, G, m, k, n, config, vec, s);
  else if (in_dtype == DT_F32 && out_dtype == DT_BF16)
    rc = dispatch_vec<float, __nv_bfloat16>(a, b, c, G, m, k, n, config, vec, s);
  else if (in_dtype == DT_BF16 && out_dtype == DT_F32)
    rc = dispatch_vec<__nv_bfloat16, float>(a, b, c, G, m, k, n, config, vec, s);
  else if (in_dtype == DT_BF16 && out_dtype == DT_BF16)
    rc = dispatch_vec<__nv_bfloat16, __nv_bfloat16>(a, b, c, G, m, k, n, config, vec, s);
  else
    return (int)cudaErrorInvalidValue;
  if (rc) return rc;
  return (int)cudaGetLastError();
}
