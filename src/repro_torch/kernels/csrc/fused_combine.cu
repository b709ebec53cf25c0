// K1: the binary streaming plugin, `out = op(a.f32, b.f32).to(out_dtype)`.
//
// Replaces the TPU kernel repro/kernels/fused_reduce.py::fused_combine
// (body `_kernel`), which combined (256-row, 128-lane) VMEM tiles of a
// flat input padded to 256 x 128 elements, its operands cut out of the
// arrays by BlockSpec index maps.
//
// Bound on the H100: memory. Two reads and one write per element and one
// add, far below the card's ~20 operations per byte of fp32 balance, so
// the least time is (|a| + |b| + |out|) / 3.35 TB/s. The design is about
// bytes in flight: every thread issues K1_UNROLL 16-byte loads per
// operand (streaming, evict-first) before it computes, the grid is cut to
// what the SMs hold at once (a grid-stride loop takes the rest), and a
// masked scalar tail replaces the TPU's 128-lane padding.
//
// Two entry points:
//  * k1_fused_combine: contiguous operands (the plugin API and the
//    register_collective path).
//  * k1_fused_combine_at: the executor's region index — the counterpart
//    of the TPU kernel's index maps — over a WHOLE exchange in one
//    launch. Each operand is a rank-stacked buffer read in place through
//    (rows (ranks), units (k, ranks, units/k)): row r of segment j is the
//    units units[j, r, :] of stacked row rows[r], each `unit` contiguous
//    elements. The result lands in a fresh contiguous (k, ranks, seg)
//    tensor, so the executor's deferred write is unchanged, and the
//    gathered copies of both operands are gone. Grid: x cuts a row's
//    vectors, y is the rank, z the segment; at k = 1 it is the one-segment
//    launch it replaces, element for element.
//
// What bounds the indexed launch: one segment of the 64 MiB allreduce
// (8 ranks x 32768 fp32, 3.1 MB) is one short wave whose time is DRAM
// latency and launch overhead (4.6 us against a 0.94 us bound), and its
// host entry cost more than the kernel. A whole exchange of that call
// (8 ranks x 32 segments x 32768 fp32, 100.7 MB moved) has a 30 us bound
// at 3.35 TB/s; its k x ranks rows fill the residency-capped grid many
// times over, so the grid-stride loop keeps K1_UNROLL loads per thread in
// flight throughout and the launch runs at the bytes' pace.
#include "common.cuh"

namespace repro_torch {

constexpr int K1_THREADS = 256;
constexpr int K1_UNROLL = 4;         // 16-byte vectors per thread in flight
constexpr int K1_BLOCKS_PER_SM = 8;  // residency the grid is cut to

static int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 132;
  }();
  return sms;
}

template <typename Tin, typename Tout>
__device__ __forceinline__ void store_vec(Tout* dst, const Tout (&v)[16 / sizeof(Tin)]) {
  constexpr int V = 16 / sizeof(Tin);
  constexpr int BYTES = V * sizeof(Tout);
  if constexpr (BYTES == 16) {
    __stcs(reinterpret_cast<uint4*>(dst), *reinterpret_cast<const uint4*>(v));
  } else if constexpr (BYTES == 32) {
    __stcs(reinterpret_cast<uint4*>(dst), reinterpret_cast<const uint4*>(v)[0]);
    __stcs(reinterpret_cast<uint4*>(dst) + 1, reinterpret_cast<const uint4*>(v)[1]);
  } else {
    static_assert(BYTES == 8, "unexpected vector width");
    __stcs(reinterpret_cast<uint2*>(dst), *reinterpret_cast<const uint2*>(v));
  }
}

template <typename Tin, typename Tout, int OP>
__device__ __forceinline__ void combine_vec(const uint4& va, const uint4& vb,
                                            Tout* dst) {
  constexpr int V = 16 / sizeof(Tin);
  const Tin* pa = reinterpret_cast<const Tin*>(&va);
  const Tin* pb = reinterpret_cast<const Tin*>(&vb);
  alignas(16) Tout r[V];
#pragma unroll
  for (int j = 0; j < V; ++j)
    r[j] = from_f32<Tout>(apply_op<OP>(to_f32(pa[j]), to_f32(pb[j])));
  store_vec<Tin, Tout>(dst, r);
}

template <typename Tin, typename Tout, int OP>
__global__ void __launch_bounds__(K1_THREADS)
fused_combine_kernel(const Tin* __restrict__ a, const Tin* __restrict__ b,
                     Tout* __restrict__ out, long long n, int vec_ok) {
  constexpr int V = 16 / sizeof(Tin);
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long nvec = vec_ok ? n / V : 0;
  const uint4* a4 = reinterpret_cast<const uint4*>(a);
  const uint4* b4 = reinterpret_cast<const uint4*>(b);
  for (long long base = tid; base < nvec; base += stride * K1_UNROLL) {
    uint4 va[K1_UNROLL], vb[K1_UNROLL];
#pragma unroll
    for (int u = 0; u < K1_UNROLL; ++u) {
      const long long i = base + u * stride;
      if (i < nvec) {
        va[u] = __ldcs(a4 + i);
        vb[u] = __ldcs(b4 + i);
      }
    }
#pragma unroll
    for (int u = 0; u < K1_UNROLL; ++u) {
      const long long i = base + u * stride;
      if (i < nvec) combine_vec<Tin, Tout, OP>(va[u], vb[u], out + i * V);
    }
  }
  for (long long i = nvec * V + tid; i < n; i += stride)
    out[i] = from_f32<Tout>(apply_op<OP>(to_f32(a[i]), to_f32(b[i])));
}

// One operand of the indexed combine: a rank-stacked buffer and its
// region index for a whole exchange.
struct Region {
  const void* base;
  const long long* rows;    // (ranks,) stacked row of each rank
  const long long* units;   // (k, ranks, upk) unit numbers within the row
  long long row_elems;      // elements per stacked row
  int unit_elems;           // elements per unit
  int upk;                  // units per rank in one segment
};

// Element p of rank r's row of segment j, where jr = j * ranks + r.
template <typename T>
__device__ __forceinline__ const T* region_at(const Region& g, int r,
                                              long long jr, int p) {
  const T* row = static_cast<const T*>(g.base) + g.rows[r] * g.row_elems;
  // one unit per rank and segment (the common layout): no division
  if (g.upk == 1) return row + g.units[jr] * g.unit_elems + p;
  const unsigned u = (unsigned)p / (unsigned)g.unit_elems;
  const unsigned off = (unsigned)p - u * (unsigned)g.unit_elems;
  return row + g.units[jr * g.upk + u] * g.unit_elems + off;
}

// blockIdx.y = rank r, blockIdx.z = segment j; x and the grid-stride loop
// cover that row's `seg` elements in V-element vectors (V = 1 on the
// unaligned path).
template <typename Tin, typename Tout, int OP, bool VEC>
__global__ void __launch_bounds__(K1_THREADS)
fused_combine_kernel_at(Region a, Region b, Tout* __restrict__ out, int seg) {
  constexpr int V = VEC ? 16 / sizeof(Tin) : 1;
  const int r = blockIdx.y;
  const long long jr = (long long)blockIdx.z * gridDim.y + r;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const int nvec = seg / V;
  Tout* orow = out + jr * seg;
  for (int base = tid; base < nvec; base += stride * K1_UNROLL) {
    if constexpr (VEC) {
      uint4 va[K1_UNROLL], vb[K1_UNROLL];
#pragma unroll
      for (int u = 0; u < K1_UNROLL; ++u) {
        const int i = base + u * stride;
        if (i < nvec) {
          va[u] = __ldcs(reinterpret_cast<const uint4*>(
              region_at<Tin>(a, r, jr, i * V)));
          vb[u] = __ldcs(reinterpret_cast<const uint4*>(
              region_at<Tin>(b, r, jr, i * V)));
        }
      }
#pragma unroll
      for (int u = 0; u < K1_UNROLL; ++u) {
        const int i = base + u * stride;
        if (i < nvec) combine_vec<Tin, Tout, OP>(va[u], vb[u], orow + i * V);
      }
    } else {
      Tin va[K1_UNROLL], vb[K1_UNROLL];
#pragma unroll
      for (int u = 0; u < K1_UNROLL; ++u) {
        const int i = base + u * stride;
        if (i < nvec) {
          va[u] = *region_at<Tin>(a, r, jr, i);
          vb[u] = *region_at<Tin>(b, r, jr, i);
        }
      }
#pragma unroll
      for (int u = 0; u < K1_UNROLL; ++u) {
        const int i = base + u * stride;
        if (i < nvec)
          orow[i] = from_f32<Tout>(apply_op<OP>(to_f32(va[u]), to_f32(vb[u])));
      }
    }
  }
}

// Blocks for `work` vectors: K1_UNROLL per thread, cut to the SMs' residency
// (the grid-stride loop takes the rest).
static long long k1_blocks(long long work) {
  constexpr long long PER_BLOCK = (long long)K1_THREADS * K1_UNROLL;
  long long blocks = (work + PER_BLOCK - 1) / PER_BLOCK;
  const long long cap = (long long)sm_count() * K1_BLOCKS_PER_SM;
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : blocks;
}

template <typename Tin, typename Tout, int OP>
static void launch(const void* a, const void* b, void* out, long long n,
                   int vec_ok, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(Tin);
  const long long work = vec_ok ? (n + V - 1) / V : n;
  fused_combine_kernel<Tin, Tout, OP>
      <<<(unsigned)k1_blocks(work), K1_THREADS, 0, stream>>>(
          static_cast<const Tin*>(a), static_cast<const Tin*>(b),
          static_cast<Tout*>(out), n, vec_ok);
}

template <typename Tin, typename Tout, int OP>
static void launch_at(const Region& a, const Region& b, void* out, int k,
                      int ranks, int seg, int vec_ok, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(Tin);
  const long long per_row = vec_ok ? seg / V : seg;
  // the residency cap is shared by the k x ranks rows (blockIdx.z, .y)
  const long long rows = (long long)k * ranks;
  long long bx = k1_blocks(per_row * rows);
  bx = (bx + rows - 1) / rows;
  const long long need = k1_blocks(per_row);
  if (bx > need) bx = need;
  dim3 grid((unsigned)bx, (unsigned)ranks, (unsigned)k);
  if (vec_ok)
    fused_combine_kernel_at<Tin, Tout, OP, true>
        <<<grid, K1_THREADS, 0, stream>>>(a, b, static_cast<Tout*>(out), seg);
  else
    fused_combine_kernel_at<Tin, Tout, OP, false>
        <<<grid, K1_THREADS, 0, stream>>>(a, b, static_cast<Tout*>(out), seg);
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

template <typename Tin, typename Tout>
static int dispatch_op_at(const Region& a, const Region& b, void* out, int k,
                          int ranks, int seg, int op, int vec_ok,
                          cudaStream_t stream) {
  switch (op) {
    case OP_ADD: launch_at<Tin, Tout, OP_ADD>(a, b, out, k, ranks, seg, vec_ok, stream); break;
    case OP_MAX: launch_at<Tin, Tout, OP_MAX>(a, b, out, k, ranks, seg, vec_ok, stream); break;
    case OP_MIN: launch_at<Tin, Tout, OP_MIN>(a, b, out, k, ranks, seg, vec_ok, stream); break;
    case OP_MUL: launch_at<Tin, Tout, OP_MUL>(a, b, out, k, ranks, seg, vec_ok, stream); break;
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

// out (k, ranks, seg) = op(a's region, b's region) for every segment of
// one exchange, in one launch. For each operand: the buffer, its rows
// (ranks,) and units (k, ranks, upk) index tensors (int64, contiguous),
// elements per stacked row and per unit. The wrapper checks the shapes,
// that seg, unit_elems < 2^31 and k, ranks <= 65535, and sets vec_ok when
// every base and unit is 16-byte aligned. Returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int k1_fused_combine_at(
    const void* a, const void* a_rows, const void* a_units,
    long long a_row_elems, long long a_unit_elems, long long a_upk,
    const void* b, const void* b_rows, const void* b_units,
    long long b_row_elems, long long b_unit_elems, long long b_upk,
    void* out, long long k, long long ranks, long long seg, int in_dtype,
    int out_dtype, int op, int vec_ok, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Region ra{a, static_cast<const long long*>(a_rows),
                  static_cast<const long long*>(a_units), a_row_elems,
                  (int)a_unit_elems, (int)a_upk};
  const Region rb{b, static_cast<const long long*>(b_rows),
                  static_cast<const long long*>(b_units), b_row_elems,
                  (int)b_unit_elems, (int)b_upk};
  const int K = (int)k, R = (int)ranks, n = (int)seg;
  int rc;
  if (in_dtype == DT_F32 && out_dtype == DT_F32)
    rc = dispatch_op_at<float, float>(ra, rb, out, K, R, n, op, vec_ok, s);
  else if (in_dtype == DT_F32 && out_dtype == DT_BF16)
    rc = dispatch_op_at<float, __nv_bfloat16>(ra, rb, out, K, R, n, op, vec_ok, s);
  else if (in_dtype == DT_BF16 && out_dtype == DT_F32)
    rc = dispatch_op_at<__nv_bfloat16, float>(ra, rb, out, K, R, n, op, vec_ok, s);
  else if (in_dtype == DT_BF16 && out_dtype == DT_BF16)
    rc = dispatch_op_at<__nv_bfloat16, __nv_bfloat16>(ra, rb, out, K, R, n, op, vec_ok, s);
  else
    return (int)cudaErrorInvalidValue;
  if (rc) return rc;
  return (int)cudaGetLastError();
}
