// K5: row gather from stacked embedding tables, two entry points.
//
// Replaces the TPU kernel repro/kernels/embedding_gather.py::gather_rows
// (body `_kernel`), whose grid ran one (1, D) row copy per step with the
// indices scalar-prefetched to steer the table BlockSpec; its wrapper
// padded D to 128 lanes.
//
//   k5_gather_rows  out[g, i, :] = table[g, idx[g, i], :]        (G, B, D)
//                   the indices trusted to lie in [0, V);
//   k5_lookup_rows  out[g, b, t*D:(t+1)*D] = tables[g, t, id - lo[g], :]
//                   if 0 <= id - lo[g] < rows_l, else +0.0, where
//                   id = ids[g, b, t] is read through its strides (G, B, T*D)
//                   — the DLRM serving path's whole per-rank lookup (shift,
//                   hit mask, gather, zeroed misses, the concat layout) in
//                   one launch. A miss reads no table row.
//
// Bound on the H100: memory. There is no arithmetic; the least time is
// (ids read once + rows read + output written once) / 3.35 TB/s. A row's
// address depends on its id, itself a load, so each row costs two
// dependent memory round trips; what hides them is many rows in flight
// across the card. The design (each choice timed by scripts/k5_probe.py
// at the DLRM shapes, B = 32 and 2048):
//  * a group of `tpr` threads (a power of two up to a warp) copies a row
//    in the widest unit that the row length and both base pointers allow
//    (16 bytes for the paper's 32 x fp32 = 128-byte rows: 8 threads a
//    row, 4 rows a warp); D is not padded;
//  * each group has kRowsInFlight rows in flight (all their ids loaded,
//    then all their rows, then all the stores). One is best: the warps
//    the SMs hold resident already overlap enough rows; 2 rows per group
//    were no faster, 4 and 8 slower (up to 1.4x at B = 32, where the
//    launch is one wave and each thread's longer chain of address
//    arithmetic adds to it);
//  * 128-thread blocks on a grid sized to the work, a block's groups on
//    consecutive rows so each store wave is contiguous; a grid of the
//    resident blocks striding over the rows was 8% slower at B = 2048
//    (the last stride leaves SMs idle), 512-thread blocks 6%;
//  * a row's coordinates come from its flat output row number by
//    division by invariant integers (multiply-high and shift) in 32
//    bits; table offsets are 64-bit (the DLRM table stack holds 1.28e10
//    elements);
//  * lookup: `id - lo` in unsigned 32-bit arithmetic, which wraps as the
//    reference's int32 subtraction does, and the hit test is one
//    unsigned compare (a negative difference is >= 2^31 > rows_l).
// A copy is exact: the output is bitwise its plain version's
// (kernels/ref.py gather_rows, lookup_rows).
#include "common.cuh"

namespace repro_torch {

constexpr int kThreads = 128;
// Rows a thread group has in flight per step.
constexpr int kRowsInFlight = 1;

// n / d for a divisor fixed at launch, exact for every 32-bit n
// (Granlund & Montgomery 1994, fig. 4.1).
struct FastDiv {
  unsigned d, m, s1, s2;
  explicit FastDiv(unsigned divisor) : d(divisor) {
    unsigned l = 0;
    while (l < 32 && (1ull << l) < d) ++l;
    m = (unsigned)(((1ull << 32) * ((1ull << l) - d)) / d + 1);
    s1 = l < 1 ? l : 1;
    s2 = l > 0 ? l - 1 : 0;
  }
  __device__ __forceinline__ unsigned div(unsigned n) const {
    const unsigned t = __umulhi(m, n);
    return (t + ((n - t) >> s1)) >> s2;
  }
};

// Where a launch's rows come from: output row r = (g * B + b) * T + t
// (T = 1 for gather_rows) reads table row (g * T + t) * rows_l + local,
// local = ids[g * sg + b * sb + t * st] (- lo[g] for a lookup).
struct RowMap {
  const int* ids;
  const long long* lo;   // lookup only
  long long sg, sb, st, rows_l;
  FastDiv by_t, by_b;    // T and B
};

template <typename V, bool LOOKUP>
__global__ void __launch_bounds__(kThreads)
k5_rows_kernel(const V* __restrict__ table, V* __restrict__ out,
               unsigned rows, RowMap map, int units, int tpr_log2) {
  const int lane = threadIdx.x & ((1 << tpr_log2) - 1);
  const unsigned gpb = kThreads >> tpr_log2;     // groups per block
  const unsigned group = threadIdx.x >> tpr_log2;
  const unsigned step = gridDim.x * gpb * kRowsInFlight;
  for (unsigned base = blockIdx.x * gpb * kRowsInFlight; base < rows;
       base += step) {
    // table offset of each row in units; -1 a miss, -2 past the end
    long long src[kRowsInFlight];
#pragma unroll
    for (int k = 0; k < kRowsInFlight; ++k) {
      const unsigned r = base + group + k * gpb;
      src[k] = -2;
      if (r < rows) {
        const unsigned gb = map.by_t.div(r), t = r - gb * map.by_t.d;
        const unsigned g = map.by_b.div(gb), b = gb - g * map.by_b.d;
        const int id = __ldg(map.ids + g * map.sg + b * map.sb + t * map.st);
        const long long tab = (long long)g * map.by_t.d + t;
        if (LOOKUP) {
          const unsigned local = (unsigned)id - (unsigned)__ldg(map.lo + g);
          src[k] = local < (unsigned)map.rows_l
                       ? (tab * map.rows_l + local) * units : -1;
        } else {
          src[k] = (tab * map.rows_l + id) * units;
        }
      }
    }
    for (int u = lane; u < units; u += 1 << tpr_log2) {
      V v[kRowsInFlight];
#pragma unroll
      for (int k = 0; k < kRowsInFlight; ++k)
        v[k] = src[k] >= 0 ? __ldg(table + src[k] + u) : V{};
#pragma unroll
      for (int k = 0; k < kRowsInFlight; ++k)
        if (src[k] != -2)
          out[(long long)(base + group + k * gpb) * units + u] = v[k];
    }
  }
}

template <typename V, bool LOOKUP>
static void launch(const void* table, void* out, long long rows,
                   const RowMap& map, long long units, cudaStream_t s) {
  int tpr_log2 = 0;
  while (tpr_log2 < 5 && (1LL << tpr_log2) < units) ++tpr_log2;
  const long long per_block = (long long)(kThreads >> tpr_log2) *
                              kRowsInFlight;
  const long long blocks = (rows + per_block - 1) / per_block;
  k5_rows_kernel<V, LOOKUP><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const V*>(table), static_cast<V*>(out), (unsigned)rows,
      map, (int)units, tpr_log2);
}

template <bool LOOKUP>
static int dispatch(const void* table, void* out, long long rows,
                    const RowMap& map, long long row_bytes, int vec_bytes,
                    void* stream) {
  if (vec_bytes <= 0 || row_bytes <= 0 || row_bytes % vec_bytes ||
      rows <= 0 || rows >= (1LL << 31) || row_bytes / vec_bytes > (1 << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long units = row_bytes / vec_bytes;
  switch (vec_bytes) {
    case 16: launch<uint4, LOOKUP>(table, out, rows, map, units, s); break;
    case 8: launch<uint2, LOOKUP>(table, out, rows, map, units, s); break;
    case 4: launch<unsigned int, LOOKUP>(table, out, rows, map, units, s); break;
    case 2: launch<unsigned short, LOOKUP>(table, out, rows, map, units, s); break;
    case 1: launch<unsigned char, LOOKUP>(table, out, rows, map, units, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

using namespace repro_torch;

// table: (G, V, row_bytes) contiguous; idx: (G, B) int32 in [0, V),
// contiguous; out: (G, B, row_bytes). `vec_bytes` (16, 8, 4, 2 or 1)
// divides row_bytes and both base pointers' alignment; G * B < 2^31.
// Returns the launch's cudaGetLastError() (0 on success).
extern "C" int k5_gather_rows(const void* table, const void* idx, void* out,
                              long long G, long long V_rows, long long B,
                              long long row_bytes, int vec_bytes,
                              void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  const RowMap map{static_cast<const int*>(idx), nullptr, B, 1, 0, V_rows,
                   FastDiv(1), FastDiv((unsigned)B)};
  return dispatch<false>(table, out, G * B, map, row_bytes, vec_bytes,
                         stream);
}

// tables: (G, T, rows_l, row_bytes) contiguous; ids: int32 elements
// (g, b, t) at ids + g*sg + b*sb + t*st (strides in elements, 0 allowed);
// lo: (G,) int64, each rank's first global row, taken mod 2^32 as the
// reference's int32 arithmetic does; out: (G, B, T * row_bytes).
// rows_l <= 2^31 - 1, G * B * T < 2^31, T and B < 2^32; `vec_bytes` as
// for k5_gather_rows. Returns the launch's cudaGetLastError().
extern "C" int k5_lookup_rows(const void* tables, const void* ids,
                              const void* lo, void* out, long long G,
                              long long T, long long rows_l, long long B,
                              long long sg, long long sb, long long st,
                              long long row_bytes, int vec_bytes,
                              void* stream) {
  if (T <= 0 || B <= 0 || T >= (1LL << 32) || B >= (1LL << 32) ||
      rows_l <= 0 || rows_l > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const RowMap map{static_cast<const int*>(ids),
                   static_cast<const long long*>(lo), sg, sb, st, rows_l,
                   FastDiv((unsigned)T), FastDiv((unsigned)B)};
  return dispatch<true>(tables, out, G * B * T, map, row_bytes, vec_bytes,
                        stream);
}
