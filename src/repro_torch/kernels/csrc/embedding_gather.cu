// K5: row gather from stacked embedding tables,
// out[g, i, :] = table[g, idx[g, i], :].
//
// Replaces the TPU kernel repro/kernels/embedding_gather.py::gather_rows
// (body `_kernel`), whose grid ran one (1, D) row copy per step with the
// indices scalar-prefetched to steer the table BlockSpec; its wrapper
// padded D to 128 lanes.
//
// Bound on the H100: memory. Each output row is one read of a random
// table row and one write, no arithmetic, so the least time is
// (rows read + rows written + indices) / 3.35 TB/s. The design moves each
// byte once and keeps many independent rows in flight: a group of `tpr`
// threads (a power of two up to a warp) copies one row in the widest
// unit that the row length and both base pointers allow (16 bytes for
// the paper's 32 x fp32 = 128-byte rows, so 8 threads per row and 4 rows
// per warp), and the groups stride over all G x B rows of the launch —
// every table of every stacked rank in one launch. D is not padded. A
// block loads its own indices (no scalar prefetch on this card). All
// offsets are 64-bit: a full stacked table set holds more than 2^31
// elements. Like the TPU kernel it trusts the caller's clipping of the
// indices. A copy is exact: the output is bitwise the plain version's.
#include "common.cuh"

namespace repro_torch {

template <typename V>
__global__ void gather_rows_kernel(const V* __restrict__ table,
                                   const int* __restrict__ idx,
                                   V* __restrict__ out, long long rows,
                                   long long B, long long V_rows,
                                   long long units, int tpr) {
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

template <typename V>
static void launch(const void* table, const int* idx, void* out,
                   long long rows, long long B, long long V_rows,
                   long long units, cudaStream_t stream) {
  int tpr = 1;
  while (tpr < 32 && tpr < units) tpr *= 2;
  const int threads = 256;
  const long long per_block = threads / tpr;
  long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 132LL * 32) blocks = 132LL * 32;
  if (blocks < 1) blocks = 1;
  gather_rows_kernel<V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const V*>(table), idx, static_cast<V*>(out), rows, B,
      V_rows, units, tpr);
}

}  // namespace repro_torch

using namespace repro_torch;

// table: (G, V, row_bytes) contiguous; idx: (G, B) int32 in [0, V);
// out: (G, B, row_bytes). `vec_bytes` (16, 8, 4, 2 or 1) divides
// row_bytes and both base pointers' alignment. Returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int k5_gather_rows(const void* table, const void* idx, void* out,
                              long long G, long long V_rows, long long B,
                              long long row_bytes, int vec_bytes,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  if (vec_bytes <= 0 || row_bytes % vec_bytes) return (int)cudaErrorInvalidValue;
  const long long rows = G * B, units = row_bytes / vec_bytes;
  switch (vec_bytes) {
    case 16: launch<uint4>(table, ix, out, rows, B, V_rows, units, s); break;
    case 8: launch<uint2>(table, ix, out, rows, B, V_rows, units, s); break;
    case 4: launch<unsigned int>(table, ix, out, rows, B, V_rows, units, s); break;
    case 2: launch<unsigned short>(table, ix, out, rows, B, V_rows, units, s); break;
    case 1: launch<unsigned char>(table, ix, out, rows, B, V_rows, units, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
