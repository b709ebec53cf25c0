// K2 and K3: the int8 wire codec (the unary streaming plugin).
//
// K2 `quantize_blocks` replaces the TPU kernel
// repro/kernels/quantize.py::quantize_blocks (body `_quant_kernel`); K3
// `dequantize_blocks` replaces repro/kernels/quantize.py::dequantize_blocks
// (body `_dequant_kernel`). The TPU kernels took a flat payload padded to
// 128 blocks of 256 (32768 elements); these take a stack of codec rows and
// pad each row to whole 256-element blocks on its own, so a block never
// straddles two rows. That is the reference's jnp wire format
// (repro/core/plugins.py), which is what its engine sends.
//
// Two entry points each:
//  * k2_quantize_blocks / k3_dequantize_blocks: contiguous (rows, n_valid)
//    operands (the relay register's raw decompress, the plugin API);
//  * k2_quantize_blocks_at / k3_dequantize_blocks_at: a whole compressed
//    exchange in one launch. The payload (K2) and the combine target (K3)
//    are rank-stacked buffers read in place through the executor's region
//    index (rows (ranks), units (k, ranks, units/k); see
//    core/engine.py::_region_index): codec row w = j * ranks + r is segment
//    j of rank r. The wire is every segment's wire stacked in j order,
//    byte for byte what k per-segment launches wrote, because every
//    segment's rank row is a whole number of scale blocks
//    (core/program.py::fit_segments) or, for k = 1, one padded row. K3
//    writes op(old, q * s) into a fresh contiguous (k, ranks, seg) tensor,
//    so the executor's deferred write is unchanged.
// Both pairs run the same kernel bodies; the contiguous one addresses its
// rows as the identity region.
//
// Bound on the H100: memory. K2 reads 4 bytes and writes 1 + 4/256 per
// fp32 element; K3's fp32 add reads 1 + 4/256 + 4 and writes 4; a handful
// of operations each. Least time = bytes moved / 3.35 TB/s: 12.6 us (K2)
// and 22.6 us (K3) for one exchange of the 8 x 64 MiB allreduce (8 ranks x
// 32 segments x 32768 elements), where 32 per-segment launches each paid a
// launch and a DRAM round trip (~3.6-4.2 us against a 0.4-0.7 us bound).
//
// Design:
//  * One warp per 256-element scale block in both kernels, with one
//    address helper (`load8`) shared by K2 and K3. Lane l owns the block's
//    elements 8l..8l+7: two 16-byte loads for fp32, one for bf16, where
//    every unit (`unit` rows of the buffer) is a multiple of 8 elements and
//    the base is 16-byte aligned. Elsewhere (units of 15 elements, a ragged
//    k = 1 row) each element is looked up on its own.
//  * A lane's 8 elements lie in one unit, so it reads one unit entry; the
//    lanes of a warp inside one unit read the same entry (one broadcast
//    transaction), so a unit of >= 256 elements costs one index load per
//    block.
//  * K2: amax by 5 xor-shuffles; each lane packs its 8 codes into one
//    8-byte store (the warp writes 256 contiguous bytes); lane 0 writes
//    the scale. K3: one 8-byte code load per lane, the block's scale once,
//    the old values through the index as 16-byte vectors, 16-byte stores.
//  * Bytes in flight: one CTA of 8 warps per 8 blocks, 31-32 registers a
//    thread, so 64 warps are resident per SM, each lane with 32-40 bytes
//    of loads outstanding: ~64-80 KB per SM against the ~25 KB that
//    3.35 TB/s x ~1 us of DRAM latency asks for. The hardware starts a
//    CTA as soon as one retires; a grid cut to the resident CTAs with a
//    grid-stride loop, or two blocks per warp, measured slower
//    (scripts/codec_probe.py). The grid is 1-D over blocks, so k * ranks
//    may exceed 65535.
//  * No TMA or shared-memory staging: one pass, no reuse.
//
// Numerics, matched bit for bit to the reference:
//  * K2: scale = max(amax * float32(1/127), 1e-12) — the reference's
//    compiler turns `amax / 127` into a multiply by the rounded
//    reciprocal; codes are rint(x / scale) by IEEE division
//    (round-half-even), clamped to +-127. A reciprocal multiply would move
//    codes at .5 ties, so the division stays. For a bf16 payload the
//    scale, the floor and the quotient round to bf16, as the reference's
//    bf16 arithmetic does.
//  * K3: fp32 `add` at the consume site is one rounding, fmaf(q, s, old),
//    because the reference contracts the dequantize multiply into the
//    combine add. bf16, or max/min/mul, round q*s to the buffer dtype
//    first and then combine, as the reference does.
#include "common.cuh"

namespace repro_torch {

constexpr int QUANT_BLOCK = 256;
constexpr int QZ_THREADS = 256;           // 8 warps, one scale block each
constexpr int QZ_WARPS = QZ_THREADS / 32;

// The codec rows of one launch: row w = j * ranks + r. With `units` null
// the rows are the identity region (row w is row_elems contiguous elements
// at w * row_elems); else row w is the `upk` units units[w * upk + u] of
// stacked row rows[w % ranks], each unit_elems contiguous elements.
struct Rows {
  const void* base;
  const long long* rows;
  const long long* units;
  long long row_elems;
  int unit_elems;
  int upk;
  int ranks;
};

// Offset from base of element p (< seg) of codec row w.
__device__ __forceinline__ long long elem_offset(const Rows& g, int w, int p) {
  if (g.units == nullptr) return (long long)w * g.row_elems + p;
  int u = 0, off = p;
  if (g.upk > 1) {
    u = p / g.unit_elems;
    off = p - u * g.unit_elems;
  }
  return g.rows[w % g.ranks] * g.row_elems +
         g.units[(long long)w * g.upk + u] * g.unit_elems + off;
}

// Lane's elements p0..p0+7 of row w as fp32, 0 past seg. VEC: seg and
// unit_elems are multiples of 8 and the base is 16-byte aligned, so the 8
// elements are one unit's and either all valid or all padding.
template <typename T, bool VEC>
__device__ __forceinline__ void load8(const Rows& g, int w, int p0, int seg,
                                      float (&v)[8]) {
  const T* base = static_cast<const T*>(g.base);
  if constexpr (VEC) {
    if (p0 >= seg) {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.0f;
      return;
    }
    const uint4* ptr = reinterpret_cast<const uint4*>(base + elem_offset(g, w, p0));
    alignas(16) T t[8];
#pragma unroll
    for (int i = 0; i < 8 * (int)sizeof(T) / 16; ++i)
      reinterpret_cast<uint4*>(t)[i] = ptr[i];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = to_f32(t[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = p0 + i;
      v[i] = p < seg ? to_f32(base[elem_offset(g, w, p)]) : 0.0f;
    }
  }
}

// Codec rows of `seg` valid elements, each padded to lp (a multiple of
// 256): codes (rows, lp), scales (rows, lp / 256).
template <typename T, bool VEC>
__global__ void __launch_bounds__(QZ_THREADS)
quantize_kernel(Rows src, signed char* __restrict__ q, float* __restrict__ s,
                int seg, int lp, int nblocks) {
  const int nb = lp / QUANT_BLOCK;
  const int lane = threadIdx.x & 31;
  // blk is warp-uniform, so whole warps run (and shuffle) together
  for (int blk = blockIdx.x * QZ_WARPS + (threadIdx.x >> 5); blk < nblocks;
       blk += gridDim.x * QZ_WARPS) {
    const int w = blk / nb, b = blk - w * nb;
    const int p0 = b * QUANT_BLOCK + lane * 8;
    float v[8];
    load8<T, VEC>(src, w, p0, seg, v);
    float amax = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[i]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    // A bf16 payload's codec runs in bf16 in the reference: the scale,
    // its floor and each quotient round to bf16 (to_f32(from_f32<T>(.))
    // is the identity for fp32).
    float scale = to_f32(from_f32<T>(__fmul_rn(amax, 1.0f / 127.0f)));
    scale = fmaxf(scale, to_f32(from_f32<T>(1e-12f)));
    unsigned packed[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float c = rintf(to_f32(from_f32<T>(__fdiv_rn(v[i], scale))));
      c = fminf(fmaxf(c, -127.0f), 127.0f);
      packed[i / 4] |= ((unsigned)(int)c & 0xffu) << (8 * (i % 4));
    }
    *reinterpret_cast<uint2*>(q + (long long)w * lp + p0) =
        make_uint2(packed[0], packed[1]);
    if (lane == 0) s[blk] = scale;
  }
}

template <typename T, int OP>
__device__ __forceinline__ T dequant_one(float code, float scale, float old) {
  if constexpr (OP == OP_COPY) {
    return from_f32<T>(__fmul_rn(code, scale));
  } else if constexpr (OP == OP_ADD && sizeof(T) == 4) {
    return from_f32<T>(__fmaf_rn(code, scale, old));
  } else {
    const T w = from_f32<T>(__fmul_rn(code, scale));
    return from_f32<T>(apply_op<OP>(old, to_f32(w)));
  }
}

// out (rows, seg) = op(old row, q * s) per codec row; `old` unread for
// OP_COPY. For the identity region `out` may alias old: each element is
// read before it is written by the same thread.
template <typename T, int OP, bool VEC>
__global__ void __launch_bounds__(QZ_THREADS)
dequantize_kernel(const signed char* __restrict__ q,
                  const float* __restrict__ s, Rows old, T* out, int seg,
                  int lp, int nblocks) {
  const int nb = lp / QUANT_BLOCK;
  const int lane = threadIdx.x & 31;
  for (int blk = blockIdx.x * QZ_WARPS + (threadIdx.x >> 5); blk < nblocks;
       blk += gridDim.x * QZ_WARPS) {
    const int w = blk / nb, b = blk - w * nb;
    const int p0 = b * QUANT_BLOCK + lane * 8;
    if (p0 >= seg) continue;  // padding: no shuffles below
    const uint2 c2 = __ldg(reinterpret_cast<const uint2*>(q + (long long)w * lp + p0));
    const float scale = __ldg(s + blk);
    float o[8];
    if constexpr (OP != OP_COPY) load8<T, VEC>(old, w, p0, seg, o);
    alignas(16) T r[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const unsigned word = i < 4 ? c2.x : c2.y;
      const float code = (float)(signed char)(word >> (8 * (i % 4)));
      r[i] = dequant_one<T, OP>(code, scale, OP == OP_COPY ? 0.0f : o[i]);
    }
    T* dst = out + (long long)w * seg + p0;
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < 8 * (int)sizeof(T) / 16; ++i)
        reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(r)[i];
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (p0 + i < seg) dst[i] = r[i];
    }
  }
}

// One CTA per QZ_WARPS blocks. At 31-32 registers a thread, 8 CTAs (64
// warps) fit an SM, and the hardware starts a CTA as soon as one retires;
// the kernels' grid-stride loop runs once.
static unsigned grid(int nblocks) {
  return (unsigned)((nblocks + QZ_WARPS - 1) / QZ_WARPS);
}

static bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

// 16-byte vectors where every unit (and so every row) is whole 8-element
// groups and the bases are aligned.
static bool vec_ok(const Rows& g, const void* other) {
  const long long unit = g.units == nullptr ? g.row_elems : g.unit_elems;
  return unit % 8 == 0 && aligned16(g.base) &&
         (other == nullptr || aligned16(other));
}

template <typename T>
static int launch_quant(const Rows& src, signed char* q, float* s, int seg,
                        int lp, int nblocks, cudaStream_t st) {
  if (vec_ok(src, nullptr))
    quantize_kernel<T, true><<<grid(nblocks), QZ_THREADS, 0, st>>>(
        src, q, s, seg, lp, nblocks);
  else
    quantize_kernel<T, false><<<grid(nblocks), QZ_THREADS, 0, st>>>(
        src, q, s, seg, lp, nblocks);
  return (int)cudaGetLastError();
}

template <typename T, int OP>
static void launch_dequant(const signed char* q, const float* s,
                           const Rows& old, void* out, int seg, int lp,
                           int nblocks, cudaStream_t st) {
  // for OP_COPY `old` carries no data: only `out` must be aligned
  const Rows probe = OP == OP_COPY ? Rows{out, nullptr, nullptr, seg, seg, 1, 1}
                                   : old;
  T* o = static_cast<T*>(out);
  if (vec_ok(probe, out) && seg % 8 == 0)
    dequantize_kernel<T, OP, true><<<grid(nblocks), QZ_THREADS, 0, st>>>(
        q, s, old, o, seg, lp, nblocks);
  else
    dequantize_kernel<T, OP, false><<<grid(nblocks), QZ_THREADS, 0, st>>>(
        q, s, old, o, seg, lp, nblocks);
}

template <typename T>
static int dispatch_dequant(const signed char* q, const float* s,
                            const Rows& old, void* out, int seg, int lp,
                            int nblocks, int op, cudaStream_t st) {
  switch (op) {
    case OP_COPY: launch_dequant<T, OP_COPY>(q, s, old, out, seg, lp, nblocks, st); break;
    case OP_ADD: launch_dequant<T, OP_ADD>(q, s, old, out, seg, lp, nblocks, st); break;
    case OP_MAX: launch_dequant<T, OP_MAX>(q, s, old, out, seg, lp, nblocks, st); break;
    case OP_MIN: launch_dequant<T, OP_MIN>(q, s, old, out, seg, lp, nblocks, st); break;
    case OP_MUL: launch_dequant<T, OP_MUL>(q, s, old, out, seg, lp, nblocks, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The checks both entry pairs share: lp is seg padded to 256, and a
// row's length and the block count (with the grid stride added) stay in
// int.
static bool shape_ok(long long rows, long long seg, long long lp) {
  return rows >= 1 && seg >= 1 && lp % QUANT_BLOCK == 0 && lp >= seg &&
         lp - seg < QUANT_BLOCK && lp < (1LL << 31) &&
         rows * (lp / QUANT_BLOCK) < (1LL << 30);
}

static int quantize(const Rows& src, signed char* q, float* s, long long rows,
                    long long seg, long long lp, int in_dtype, cudaStream_t st) {
  if (!shape_ok(rows, seg, lp)) return (int)cudaErrorInvalidValue;
  const int nblocks = (int)(rows * (lp / QUANT_BLOCK));
  if (in_dtype == DT_F32)
    return launch_quant<float>(src, q, s, (int)seg, (int)lp, nblocks, st);
  if (in_dtype == DT_BF16)
    return launch_quant<__nv_bfloat16>(src, q, s, (int)seg, (int)lp, nblocks, st);
  return (int)cudaErrorInvalidValue;
}

static int dequantize(const signed char* q, const float* s, const Rows& old,
                      void* out, long long rows, long long seg, long long lp,
                      int out_dtype, int op, cudaStream_t st) {
  if (!shape_ok(rows, seg, lp)) return (int)cudaErrorInvalidValue;
  const int nblocks = (int)(rows * (lp / QUANT_BLOCK));
  if (out_dtype == DT_F32)
    return dispatch_dequant<float>(q, s, old, out, (int)seg, (int)lp, nblocks, op, st);
  if (out_dtype == DT_BF16)
    return dispatch_dequant<__nv_bfloat16>(q, s, old, out, (int)seg, (int)lp,
                                           nblocks, op, st);
  return (int)cudaErrorInvalidValue;
}

static Rows region(const void* base, const void* rows, const void* units,
                   long long row_elems, long long unit_elems, long long upk,
                   long long ranks) {
  return Rows{base, static_cast<const long long*>(rows),
              static_cast<const long long*>(units), row_elems,
              (int)unit_elems, (int)upk, (int)ranks};
}

}  // namespace repro_torch

using namespace repro_torch;

// Contiguous (rows, n_valid) payload -> codes (rows, n_pad), scales
// (rows, n_pad / 256). Returns the launch's cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for shapes it does not take.
extern "C" int k2_quantize_blocks(const void* x, signed char* q, float* s,
                                  long long rows, long long n_valid,
                                  long long n_pad, int in_dtype,
                                  void* stream) {
  return quantize(region(x, nullptr, nullptr, n_valid, n_valid, 1, 1), q, s,
                  rows, n_valid, n_pad, in_dtype,
                  static_cast<cudaStream_t>(stream));
}

// out (rows, n_valid) = op(old, q * s); `old` is a contiguous (rows,
// n_valid) tensor, null for op == OP_COPY, and may alias `out`.
extern "C" int k3_dequantize_blocks(const signed char* q, const float* s,
                                    const void* old, void* out,
                                    long long rows, long long n_valid,
                                    long long n_pad, int out_dtype, int op,
                                    void* stream) {
  return dequantize(q, s, region(old, nullptr, nullptr, n_valid, n_valid, 1, 1),
                    out, rows, n_valid, n_pad, out_dtype, op,
                    static_cast<cudaStream_t>(stream));
}

// A whole exchange's payload, read in place: segment j of rank r is the
// upk units units[j, r, :] (int64, (k, ranks, upk)) of stacked row
// rows[r] (int64, (ranks,)) of x, each unit_elems elements; row_elems
// elements per stacked row. Codes (k * ranks, n_pad) and scales
// (k * ranks, n_pad / 256), row j * ranks + r; seg = upk * unit_elems.
extern "C" int k2_quantize_blocks_at(const void* x, const void* rows,
                                     const void* units, long long row_elems,
                                     long long unit_elems, long long upk,
                                     long long k, long long ranks,
                                     signed char* q, float* s, long long seg,
                                     long long n_pad, int in_dtype,
                                     void* stream) {
  if (ranks < 1 || upk < 1 || unit_elems < 1 || unit_elems * upk != seg)
    return (int)cudaErrorInvalidValue;
  return quantize(region(x, rows, units, row_elems, unit_elems, upk, ranks),
                  q, s, k * ranks, seg, n_pad, in_dtype,
                  static_cast<cudaStream_t>(stream));
}

// out (k * ranks, seg) = op(old's region, q * s): the target read in place
// through its index (as for k2_quantize_blocks_at; old is unread for
// OP_COPY). `out` must not overlap `old`.
extern "C" int k3_dequantize_blocks_at(const signed char* q, const float* s,
                                       const void* old, const void* rows,
                                       const void* units, long long row_elems,
                                       long long unit_elems, long long upk,
                                       long long k, long long ranks,
                                       void* out, long long seg,
                                       long long n_pad, int out_dtype, int op,
                                       void* stream) {
  if (ranks < 1 || upk < 1 || unit_elems < 1 || unit_elems * upk != seg)
    return (int)cudaErrorInvalidValue;
  return dequantize(q, s, region(old, rows, units, row_elems, unit_elems, upk, ranks),
                    out, k * ranks, seg, n_pad, out_dtype, op,
                    static_cast<cudaStream_t>(stream));
}
