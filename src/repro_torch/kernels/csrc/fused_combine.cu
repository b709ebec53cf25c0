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
//    elements. The result lands either in a contiguous (k, ranks, seg)
//    tensor (`out`), or, with `out` null, back in a's region: each thread
//    writes op(a, b) to the element of a it read, so the exchange is one
//    pass, two reads and one write an element, with no temporary and no
//    scatter after it. Within the launch a thread alone reads and writes
//    its element of a; that no rank's write lands where another rank's
//    payload is read is the executor's compile-time proof (each batch
//    verdict of core/program.py::batches). Grid: x cuts a row's vectors, y is
//    the rank, z the segment; at k = 1 it is the one-segment launch it
//    replaces, element for element.
//
// Beside K1, the data plane's indexed copy (region_copy_at, kernel
// region_index_copy_kernel): a copy exchange (an allgather step, an
// allreduce's second half, an alltoall step) read through its payload
// index and written through its target index in one launch over every
// segment and rank, one read and one write an element, in the widest
// word (1-16 bytes) that every unit and base allows. It is no K1 instance:
// the profiler counts its time with the data plane's indexing copies.
//
// Cache hints: loads are evict-first (__ldcs) and stores streaming
// (__stcs): a whole exchange (100 MB at 64 MiB a rank) is twice the L2, so
// nothing is read again from it. One exception: in place, a's line is read
// with the default policy, since the same thread writes it right after
// (scripts/inplace_probe.py: 0.0374 against 0.0382 ms an exchange with
// evict-first, and as fast as the out-of-place K1).
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
// unaligned path). INPLACE (Tin == Tout) writes each result back where its
// a element was read; else into `out`.
template <typename Tin, typename Tout, int OP, bool VEC, bool INPLACE>
__global__ void __launch_bounds__(K1_THREADS)
fused_combine_kernel_at(Region a, Region b, Tout* __restrict__ out, int seg) {
  constexpr int V = VEC ? 16 / sizeof(Tin) : 1;
  static_assert(!INPLACE || sizeof(Tin) == sizeof(Tout), "in place: one dtype");
  const int r = blockIdx.y;
  const long long jr = (long long)blockIdx.z * gridDim.y + r;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const int nvec = seg / V;
  Tout* orow = INPLACE ? nullptr : out + jr * seg;
  for (int base = tid; base < nvec; base += stride * K1_UNROLL) {
    const Tin* pa[K1_UNROLL];
    if constexpr (VEC) {
      uint4 va[K1_UNROLL], vb[K1_UNROLL];
#pragma unroll
      for (int u = 0; u < K1_UNROLL; ++u) {
        const int i = base + u * stride;
        if (i < nvec) {
          pa[u] = region_at<Tin>(a, r, jr, i * V);
          // in place, a's line is written back right after: the default
          // policy, not evict-first (2% faster an exchange on the card)
          va[u] = INPLACE ? *reinterpret_cast<const uint4*>(pa[u])
                          : __ldcs(reinterpret_cast<const uint4*>(pa[u]));
          vb[u] = __ldcs(reinterpret_cast<const uint4*>(
              region_at<Tin>(b, r, jr, i * V)));
        }
      }
#pragma unroll
      for (int u = 0; u < K1_UNROLL; ++u) {
        const int i = base + u * stride;
        if (i < nvec)
          combine_vec<Tin, Tout, OP>(
              va[u], vb[u],
              INPLACE ? reinterpret_cast<Tout*>(const_cast<Tin*>(pa[u]))
                      : orow + i * V);
      }
    } else {
      Tin va[K1_UNROLL], vb[K1_UNROLL];
#pragma unroll
      for (int u = 0; u < K1_UNROLL; ++u) {
        const int i = base + u * stride;
        if (i < nvec) {
          pa[u] = region_at<Tin>(a, r, jr, i);
          va[u] = *pa[u];
          vb[u] = *region_at<Tin>(b, r, jr, i);
        }
      }
#pragma unroll
      for (int u = 0; u < K1_UNROLL; ++u) {
        const int i = base + u * stride;
        if (i < nvec) {
          Tout* dst = INPLACE ? reinterpret_cast<Tout*>(const_cast<Tin*>(pa[u]))
                              : orow + i;
          *dst = from_f32<Tout>(apply_op<OP>(to_f32(va[u]), to_f32(vb[u])));
        }
      }
    }
  }
}

// The indexed copy: dst's region = src's region, both through their region
// indices, in words W (1, 2, 4, 8 or 16 bytes; every unit and base a whole
// number of them). blockIdx.y = rank r, blockIdx.z = segment j; x and the
// grid-stride loop cover the row's `seg` words, K1_UNROLL loads in flight
// per thread before their stores.
template <typename W>
__global__ void __launch_bounds__(K1_THREADS)
region_index_copy_kernel(Region src, Region dst, int seg) {
  const int r = blockIdx.y;
  const long long jr = (long long)blockIdx.z * gridDim.y + r;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  for (int base = tid; base < seg; base += stride * K1_UNROLL) {
    W v[K1_UNROLL];
#pragma unroll
    for (int u = 0; u < K1_UNROLL; ++u) {
      const int i = base + u * stride;
      if (i < seg) v[u] = __ldcs(region_at<W>(src, r, jr, i));
    }
#pragma unroll
    for (int u = 0; u < K1_UNROLL; ++u) {
      const int i = base + u * stride;
      if (i < seg) __stcs(const_cast<W*>(region_at<W>(dst, r, jr, i)), v[u]);
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

// The indexed launches' grid for k x ranks rows of `per_row` work items:
// the residency cap is shared by the rows (blockIdx.z, .y).
static dim3 grid_at(long long per_row, int k, int ranks) {
  const long long rows = (long long)k * ranks;
  long long bx = k1_blocks(per_row * rows);
  bx = (bx + rows - 1) / rows;
  const long long need = k1_blocks(per_row);
  if (bx > need) bx = need;
  return dim3((unsigned)bx, (unsigned)ranks, (unsigned)k);
}

template <typename Tin, typename Tout, int OP, bool INPLACE>
static void launch_at(const Region& a, const Region& b, void* out, int k,
                      int ranks, int seg, int vec_ok, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(Tin);
  const dim3 grid = grid_at(vec_ok ? seg / V : seg, k, ranks);
  if (vec_ok)
    fused_combine_kernel_at<Tin, Tout, OP, true, INPLACE>
        <<<grid, K1_THREADS, 0, stream>>>(a, b, static_cast<Tout*>(out), seg);
  else
    fused_combine_kernel_at<Tin, Tout, OP, false, INPLACE>
        <<<grid, K1_THREADS, 0, stream>>>(a, b, static_cast<Tout*>(out), seg);
}

template <typename W>
static void launch_copy(const Region& src, const Region& dst, int k,
                        int ranks, int seg, cudaStream_t stream) {
  region_index_copy_kernel<W>
      <<<grid_at(seg, k, ranks), K1_THREADS, 0, stream>>>(src, dst, seg);
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

template <typename Tin, typename Tout, bool INPLACE>
static int dispatch_op_at(const Region& a, const Region& b, void* out, int k,
                          int ranks, int seg, int op, int vec_ok,
                          cudaStream_t stream) {
  switch (op) {
    case OP_ADD: launch_at<Tin, Tout, OP_ADD, INPLACE>(a, b, out, k, ranks, seg, vec_ok, stream); break;
    case OP_MAX: launch_at<Tin, Tout, OP_MAX, INPLACE>(a, b, out, k, ranks, seg, vec_ok, stream); break;
    case OP_MIN: launch_at<Tin, Tout, OP_MIN, INPLACE>(a, b, out, k, ranks, seg, vec_ok, stream); break;
    case OP_MUL: launch_at<Tin, Tout, OP_MUL, INPLACE>(a, b, out, k, ranks, seg, vec_ok, stream); break;
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
// one exchange, in one launch; with `out` null the result is written back
// into a's region instead (in_dtype == out_dtype). For each operand: the
// buffer, its rows (ranks,) and units (k, ranks, upk) index tensors (int64,
// contiguous), elements per stacked row and per unit. The wrapper checks
// the shapes, that seg, unit_elems < 2^31 and k, ranks <= 65535, and sets
// vec_ok when every base and unit is 16-byte aligned. Returns the launch's
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
  if (out == nullptr) {
    if (in_dtype != out_dtype) return (int)cudaErrorInvalidValue;
    if (in_dtype == DT_F32)
      rc = dispatch_op_at<float, float, true>(ra, rb, out, K, R, n, op, vec_ok, s);
    else if (in_dtype == DT_BF16)
      rc = dispatch_op_at<__nv_bfloat16, __nv_bfloat16, true>(ra, rb, out, K, R, n, op, vec_ok, s);
    else
      return (int)cudaErrorInvalidValue;
  } else if (in_dtype == DT_F32 && out_dtype == DT_F32)
    rc = dispatch_op_at<float, float, false>(ra, rb, out, K, R, n, op, vec_ok, s);
  else if (in_dtype == DT_F32 && out_dtype == DT_BF16)
    rc = dispatch_op_at<float, __nv_bfloat16, false>(ra, rb, out, K, R, n, op, vec_ok, s);
  else if (in_dtype == DT_BF16 && out_dtype == DT_F32)
    rc = dispatch_op_at<__nv_bfloat16, float, false>(ra, rb, out, K, R, n, op, vec_ok, s);
  else if (in_dtype == DT_BF16 && out_dtype == DT_BF16)
    rc = dispatch_op_at<__nv_bfloat16, __nv_bfloat16, false>(ra, rb, out, K, R, n, op, vec_ok, s);
  else
    return (int)cudaErrorInvalidValue;
  if (rc) return rc;
  return (int)cudaGetLastError();
}

// dst's region = src's region for every segment of one copy exchange, in
// one launch. Sizes are in words of `word` bytes (1, 2, 4, 8 or 16): per
// stacked row, per unit, and `seg` per rank and segment; the wrapper picks
// the widest word that divides every unit and base, checks the shapes and
// that the regions' words fit the grid (seg, unit < 2^31; k, ranks <=
// 65535). The regions must not overlap. Returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int region_copy_at(
    const void* src, const void* src_rows, const void* src_units,
    long long src_row_words, long long src_unit_words, long long src_upk,
    void* dst, const void* dst_rows, const void* dst_units,
    long long dst_row_words, long long dst_unit_words, long long dst_upk,
    long long k, long long ranks, long long seg, int word, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Region rs{src, static_cast<const long long*>(src_rows),
                  static_cast<const long long*>(src_units), src_row_words,
                  (int)src_unit_words, (int)src_upk};
  const Region rd{dst, static_cast<const long long*>(dst_rows),
                  static_cast<const long long*>(dst_units), dst_row_words,
                  (int)dst_unit_words, (int)dst_upk};
  const int K = (int)k, R = (int)ranks, n = (int)seg;
  switch (word) {
    case 16: launch_copy<uint4>(rs, rd, K, R, n, s); break;
    case 8: launch_copy<unsigned long long>(rs, rd, K, R, n, s); break;
    case 4: launch_copy<unsigned int>(rs, rd, K, R, n, s); break;
    case 2: launch_copy<unsigned short>(rs, rd, K, R, n, s); break;
    case 1: launch_copy<unsigned char>(rs, rd, K, R, n, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
