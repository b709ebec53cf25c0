// K1: the binary streaming plugin, `out = op(a.f32, b.f32).to(out_dtype)`.
//
// Replaces the TPU kernel repro/kernels/fused_reduce.py::fused_combine
// (body `_kernel`), which combined (256-row, 128-lane) VMEM tiles of a
// flat input padded to 256 x 128 elements.
//
// Bound on the H100: memory. Two reads and one write per element and one
// add, far below the card's ~20 operations per byte of fp32 balance, so
// the least time is (|a| + |b| + |out|) / 3.35 TB/s. The design moves
// each byte once: 16-byte vector loads where all three pointers are
// 16-byte aligned, a grid-stride loop, and a masked scalar tail instead
// of the TPU's 128-lane padding (the pad was a lane-layout constraint of
// the TPU, not of this card). The data is the rank-stacked contiguous
// region of one segment exchange, so one launch serves every rank.
#include "common.cuh"

namespace repro_torch {

template <typename Tin, typename Tout>
__device__ __forceinline__ void store_vec(Tout* dst, const Tout (&v)[16 / sizeof(Tin)]) {
  constexpr int V = 16 / sizeof(Tin);
  constexpr int BYTES = V * sizeof(Tout);
  if constexpr (BYTES == 16) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
  } else if constexpr (BYTES == 32) {
    reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(v)[0];
    reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(v)[1];
  } else {
    static_assert(BYTES == 8, "unexpected vector width");
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(v);
  }
}

template <typename Tin, typename Tout, int OP>
__global__ void fused_combine_kernel(const Tin* __restrict__ a,
                                     const Tin* __restrict__ b,
                                     Tout* __restrict__ out, long long n,
                                     int vec_ok) {
  constexpr int V = 16 / sizeof(Tin);
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long nvec = vec_ok ? n / V : 0;
  for (long long i = tid; i < nvec; i += stride) {
    uint4 va = reinterpret_cast<const uint4*>(a)[i];
    uint4 vb = reinterpret_cast<const uint4*>(b)[i];
    const Tin* pa = reinterpret_cast<const Tin*>(&va);
    const Tin* pb = reinterpret_cast<const Tin*>(&vb);
    alignas(16) Tout r[V];
#pragma unroll
    for (int j = 0; j < V; ++j)
      r[j] = from_f32<Tout>(apply_op<OP>(to_f32(pa[j]), to_f32(pb[j])));
    store_vec<Tin, Tout>(out + i * V, r);
  }
  for (long long i = nvec * V + tid; i < n; i += stride)
    out[i] = from_f32<Tout>(apply_op<OP>(to_f32(a[i]), to_f32(b[i])));
}

template <typename Tin, typename Tout, int OP>
static void launch(const void* a, const void* b, void* out, long long n,
                   int vec_ok, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(Tin);
  const int threads = 256;
  long long work = vec_ok ? (n + V - 1) / V : n;
  long long blocks = (work + threads - 1) / threads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  if (blocks < 1) blocks = 1;
  fused_combine_kernel<Tin, Tout, OP><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const Tin*>(a), static_cast<const Tin*>(b),
      static_cast<Tout*>(out), n, vec_ok);
}

template <typename Tin, typename Tout>
static int dispatch_op(const void* a, const void* b, void* out, long long n,
                       int op, int vec_ok, cudaStream_t stream) {
  switch (op) {
    case OP_ADD: launch<Tin, Tout, OP_ADD>(a, b, out, n, vec_ok, stream); break;
    case OP_MAX: launch<Tin, Tout, OP_MAX>(a, b, out, n, vec_ok, stream); break;
    case OP_MIN: launch<Tin, Tout, OP_MIN>(a, b, out, n, vec_ok, stream); break;
    case OP_MUL: launch<Tin, Tout, OP_MUL>(a, b, out, n, vec_ok, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace repro_torch

using namespace repro_torch;

// Returns the launch's cudaGetLastError() (0 on success).
extern "C" int k1_fused_combine(const void* a, const void* b, void* out,
                                long long n, int in_dtype, int out_dtype,
                                int op, int vec_ok, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (in_dtype == DT_F32 && out_dtype == DT_F32)
    rc = dispatch_op<float, float>(a, b, out, n, op, vec_ok, s);
  else if (in_dtype == DT_F32 && out_dtype == DT_BF16)
    rc = dispatch_op<float, __nv_bfloat16>(a, b, out, n, op, vec_ok, s);
  else if (in_dtype == DT_BF16 && out_dtype == DT_F32)
    rc = dispatch_op<__nv_bfloat16, float>(a, b, out, n, op, vec_ok, s);
  else if (in_dtype == DT_BF16 && out_dtype == DT_BF16)
    rc = dispatch_op<__nv_bfloat16, __nv_bfloat16>(a, b, out, n, op, vec_ok, s);
  else
    return (int)cudaErrorInvalidValue;
  if (rc) return rc;
  return (int)cudaGetLastError();
}
