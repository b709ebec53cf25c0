// The SSD prefill scan: Mamba2's chunked state-space dual (arXiv
// 2405.21060, Alg. 1) in fp32, as five kernels behind one entry point.
//
// Replaces no TPU kernel: the reference computes the scan in jnp
// (repro/models/ssm.py::_ssd_chunked) and leaves it to XLA. Its plain
// PyTorch version (kernels/ref.py::ssd_chunked) writes the masked decay
// exp(ll_i - ll_j) of every chunk as an (l, l, heads) fp32 tensor, and
// four more of that size around it: at Granite-4.0-H's per-card shape
// (8 sequences x 16384 positions, 16 heads, P 64, n 128, chunk 256) some
// 35 GB of device traffic a layer for ~1.1e11 operations. Here no
// (l, l, heads) tensor exists: the decay is applied as the operands are
// staged, and what reaches device memory is the inputs, y, the final
// state and fp32 work buffers the wrapper allocates (0.75 GB at that
// shape, all of them written and read once or twice):
//   ll      (N, nc, H, l)     the within-chunk cumulative sum of dt a
//   bt, ct  (N, nc, n, l)     B and C of each chunk, transposed
//   cbt     (N, nc, l, l)     (C B^T)^T of each chunk, shared by every head
//   states  (N, nc, H, n, P)  each chunk's end state, then (in place) the
//                             state entering each chunk
// The work is bound by fp32 operations (1.1e11 a Granite layer, 1.6 ms at
// 67 TFLOP/s) more than by bytes (0.6 GB of inputs and outputs, 0.18 ms
// at 3.35 TB/s), so the three products run as register-tiled fp32 FFMA
// GEMMs: a 128 x 64 block tile of 256 threads (8 x 4 outputs each),
// 32-deep slabs through two shared-memory buffers, the next slab's global
// loads held in registers while the current one is multiplied. Every
// operand is staged k-major (As[k][m], Bs[k][n]), the layout each has in
// memory once B and C are transposed, so global loads are coalesced,
// shared stores contiguous, and a thread reads its 8 rows and 4 columns
// of a k step as three conflict-free float4 loads.
//
//   ssd_prep_kernel   B, C -> bt, ct (32 x 32 tiles through shared memory);
//                     ll, one thread a head walking the chunk in order
//   ssd_cb_kernel     cbt[j][i] = B_j . C_i, tiles with some j <= i
//   ssd_state_kernel  the chunk's end state
//                     s[n][p] = sum_j B_j[n] (x_j[p] exp(ll_last - ll_j) dt_j)
//   ssd_pass_kernel   h = exp(ll_last) h + s over the chunks in order, one
//                     thread a state element, writing the entering state
//   ssd_scan_kernel   y_i = exp(ll_i) (C_i . h_prev)
//                         + sum_{j <= i} (cbt_ji exp(ll_i - ll_j)) (x_j dt_j)
//                     slabs past the diagonal skipped, y written once in
//                     x's dtype
//
// Arithmetic: IEEE fp32 only, never TF32 or bf16 operands; every
// product-add is an explicit __fmaf_rn and every other product or sum
// __fmul_rn / __fadd_rn / __fsub_rn (the library builds with
// -fmad=false). The elementwise steps round as the plain version's do,
// ll included (dt a rounded, then summed in position order, so
// ll_last - ll_j carries the rounding of the positions after j alone);
// the products' sums run in another order.
#include "common.cuh"

namespace repro_torch {
namespace ssd {

constexpr int THREADS = 256;
constexpr int BM = 128, BN = 64, BK = 16;   // block tile and slab depth
constexpr int TR = 16, TC = 16;             // the block's threads, rows x cols
constexpr int TM = BM / TR, TN = BN / TC;   // 8 x 4 outputs a thread
constexpr int L_MAX = 1024;                 // the longest chunk
constexpr int MIN_BLOCKS = 2;
constexpr int EA = BM * BK / THREADS, EB = BN * BK / THREADS;
constexpr int SMEM = 2 * (BM + BN) * BK * 4;   // two stages of As, Bs
// with the chunk scan's static arrays (ll, dts), within the 48 KB of
// shared memory a block gets without cudaFuncSetAttribute
static_assert(SMEM + 2 * L_MAX * 4 <= 48 * 1024,
              "shared memory past 48 KB needs the attribute raised");
static_assert(TR * TC == THREADS && TM % 4 == 0 && TN % 4 == 0, "tile");

// A thread's block-tile row of output i (column of output j), as
// `mma_slab` reads them: TM consecutive rows, so a warp's rows are 4 TM
// consecutive ones; float4 groups 4 TC apart.
__device__ __forceinline__ int out_row(int tr, int i) { return tr * TM + i; }
__device__ __forceinline__ int out_col(int tc, int j) {
  return tc * 4 + TC * 4 * (j / 4) + j % 4;
}

// acc += As @ Bs over one slab: As[k][m] (BK x BM), Bs[k][n] (BK x BN).
// A warp covers 4 x 8 threads (`thread_grid`): its A reads are 4 float4
// 32 bytes apart and its B reads 8 consecutive ones, so neither
// conflicts.
__device__ __forceinline__ void mma_slab(float (&acc)[TM][TN],
                                         const float* As, const float* Bs,
                                         int tr, int tc) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    float a[TM], b[TN];
#pragma unroll
    for (int q = 0; q < TM / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(
          As + k * BM + tr * TM + 4 * q);
      a[q * 4 + 0] = v.x; a[q * 4 + 1] = v.y;
      a[q * 4 + 2] = v.z; a[q * 4 + 3] = v.w;
    }
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(
          Bs + k * BN + tc * 4 + TC * 4 * q);
      b[q * 4 + 0] = v.x; b[q * 4 + 1] = v.y;
      b[q * 4 + 2] = v.z; b[q * 4 + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
  }
}

// acc += A @ B over `slabs` slabs. `la.load(k, m)` / `lb.load(k, n)`
// read one element of the block's operand (zero outside it) as it lies in
// memory, row k; `finish` turns it into the fp32 operand once it has
// arrived. Two shared-memory buffers: slab s + 1 is loaded into registers
// while slab s is multiplied, then stored into the other buffer; one
// __syncthreads a slab. Ends synchronised, so the buffers may be reused.
// `causal`: A is zero wherever k > m + m0 (a causal mask, rows from m0),
// so a warp whose rows all lie before a slab's first k skips its
// products.
template <class LdA, class LdB>
__device__ __forceinline__ void gemm(float (&acc)[TM][TN], float* smem,
                                     const LdA& la, const LdB& lb,
                                     int slabs, int tid, int tr, int tc,
                                     bool causal = false, int m0 = 0) {
  typename LdA::Raw ra[EA];
  typename LdB::Raw rb[EB];
  auto fetch = [&](int s) {
#pragma unroll
    for (int i = 0; i < EA; ++i) {
      const int e = tid + i * THREADS;
      ra[i] = la.load(s * BK + e / BM, e % BM);
    }
#pragma unroll
    for (int i = 0; i < EB; ++i) {
      const int e = tid + i * THREADS;
      rb[i] = lb.load(s * BK + e / BN, e % BN);
    }
  };
  auto put = [&](int s) {
    float* As = smem + (s & 1) * (BM + BN) * BK;
    float* Bs = As + BM * BK;
#pragma unroll
    for (int i = 0; i < EA; ++i) {
      const int e = tid + i * THREADS;
      As[e] = la.finish(ra[i], s * BK + e / BM, e % BM);
    }
#pragma unroll
    for (int i = 0; i < EB; ++i) {
      const int e = tid + i * THREADS;
      Bs[e] = lb.finish(rb[i], s * BK + e / BN, e % BN);
    }
  };
  if (slabs <= 0) return;
  // the warp's last row: its threads' tr run over 4 consecutive values
  const int warp_last = m0 + ((tid >> 5) / (TC / 8)) * 4 * TM + 4 * TM - 1;
  fetch(0);
  put(0);
  __syncthreads();
  for (int s = 0; s < slabs; ++s) {
    if (s + 1 < slabs) fetch(s + 1);
    const float* As = smem + (s & 1) * (BM + BN) * BK;
    if (!causal || warp_last >= s * BK)
      mma_slab(acc, As, As + BM * BK, tr, tc);
    if (s + 1 < slabs) put(s + 1);
    __syncthreads();
  }
}

__device__ __forceinline__ void thread_grid(int tid, int& tr, int& tc) {
  const int lane = tid & 31, warp = tid >> 5;
  tr = (warp / (TC / 8)) * 4 + (lane >> 3);   // a warp covers 4 x 8 threads
  tc = (warp % (TC / 8)) * 8 + (lane & 7);
}

__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// Strides of the inputs in elements (the last dim of each is contiguous):
// x (N, S, H, P) by sequence, position, head; B and C (N, S, n) and dt
// (N, S, H) by sequence and position; a (N, H) by sequence.
struct Strides {
  long long x_n, x_s, x_h, b_n, b_s, c_n, c_s, dt_n, dt_s, a_n;
};

// A matrix in memory read element by element, zero outside rows x cols.
template <typename T>
struct Rows {
  using Raw = T;
  const T* base;
  long long ld;
  int rows, cols;
  __device__ __forceinline__ T load(int r, int c) const {
    return (r < rows && c < cols) ? base[r * ld + c] : from_f32<T>(0.f);
  }
  __device__ __forceinline__ float finish(T v, int, int) const {
    return to_f32(v);
  }
};

// ---------------------------------------------------------------------------
// B and C transposed per chunk; ll.
// grid (tiles_l * tiles_n of 32 x 32, nc, N)
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void transpose_tile(float (*tile)[33],
                                               const T* src, long long ld,
                                               float* dst, int l, int n,
                                               int p0, int s0, int tid) {
  const int tx = tid & 31, ty = tid >> 5;
#pragma unroll
  for (int r = ty; r < 32; r += THREADS / 32)
    tile[r][tx] = (p0 + r < l && s0 + tx < n)
                      ? to_f32(src[(p0 + r) * ld + s0 + tx]) : 0.f;
  __syncthreads();
#pragma unroll
  for (int r = ty; r < 32; r += THREADS / 32)
    if (s0 + r < n && p0 + tx < l)
      dst[(long long)(s0 + r) * l + p0 + tx] = tile[tx][r];
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_prep_kernel(const T* __restrict__ B, const T* __restrict__ C,
                const float* __restrict__ dt, const float* __restrict__ A,
                float* __restrict__ bt, float* __restrict__ ct,
                float* __restrict__ ll, Strides st, int l, int H, int n,
                int nc) {
  __shared__ float tile[32][33];
  const int tiles_n = (n + 31) / 32;
  const int p0 = (blockIdx.x / tiles_n) * 32, s0 = (blockIdx.x % tiles_n) * 32;
  const int c = blockIdx.y, b = blockIdx.z;
  const long long pos = (long long)c * l;
  const long long chunk = (long long)b * nc + c;
  const int tid = threadIdx.x;
  transpose_tile(tile, B + b * st.b_n + pos * st.b_s, st.b_s,
                 bt + chunk * n * l, l, n, p0, s0, tid);
  transpose_tile(tile, C + b * st.c_n + pos * st.c_s, st.c_s,
                 ct + chunk * n * l, l, n, p0, s0, tid);
  if (blockIdx.x != 0) return;
  // ll: dt a rounded, then summed in position order (torch.cumsum's
  // order over a dim that is not the last)
  const float* dtc = dt + b * st.dt_n + pos * st.dt_s;
  for (int h = tid; h < H; h += THREADS) {
    const float a = A[b * st.a_n + h];
    float* out = ll + (chunk * H + h) * l;
    float run = 0.f;
    for (int j0 = 0; j0 < l; j0 += 16) {   // 16 loads in flight
      float v[16];
#pragma unroll
      for (int q = 0; q < 16; ++q)
        v[q] = j0 + q < l ? __fmul_rn(dtc[(j0 + q) * st.dt_s + h], a) : 0.f;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        if (j0 + q < l) {
          run = __fadd_rn(run, v[q]);
          out[j0 + q] = run;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// cbt[j][i] = B_j . C_i over n: A = bt (rows j), B = ct (columns i).
// grid (tiles_j * tiles_i, nc, N)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ssd_cb_kernel(const float* __restrict__ bt, const float* __restrict__ ct,
              float* __restrict__ cbt, int l, int n, int nc) {
  extern __shared__ __align__(16) float smem[];
  const int tiles_i = (l + BN - 1) / BN;
  const int j0 = (blockIdx.x / tiles_i) * BM, i0 = (blockIdx.x % tiles_i) * BN;
  if (min(i0 + BN, l) - 1 < j0) return;   // every j of the tile past every i
  const long long chunk = (long long)blockIdx.z * nc + blockIdx.y;
  const int tid = threadIdx.x;
  int tr, tc;
  thread_grid(tid, tr, tc);
  const Rows<float> la{bt + chunk * n * l + j0, l, n, l - j0};
  const Rows<float> lb{ct + chunk * n * l + i0, l, n, l - i0};
  float acc[TM][TN];
  zero(acc);
  gemm(acc, smem, la, lb, (n + BK - 1) / BK, tid, tr, tc);
  float* out = cbt + chunk * l * l;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = j0 + out_row(tr, i);
    if (r >= l) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int q = i0 + out_col(tc, j);
      if (q < l) out[(long long)r * l + q] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// The chunk's end state s[n][p] = sum_j B_j[n] (x_j[p] w_j),
// w_j = exp(ll_last - ll_j) dt_j: A = B as it lies (rows j), B = x w.
// grid (tiles_n * tiles_p * H, nc, N)
// ---------------------------------------------------------------------------

template <typename T>
struct Weighted {   // x[j][p] w_j, zero past the chunk
  using Raw = T;
  Rows<T> x;
  const float* w;
  __device__ __forceinline__ T load(int k, int n) const { return x.load(k, n); }
  __device__ __forceinline__ float finish(T v, int k, int) const {
    return k < x.rows ? __fmul_rn(to_f32(v), w[k]) : 0.f;
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ssd_state_kernel(const T* __restrict__ X, const float* __restrict__ dt,
                 const T* __restrict__ B, const float* __restrict__ ll_in,
                 float* __restrict__ states, Strides st, int l, int H, int P,
                 int n, int nc) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float w[L_MAX];
  const int tiles_p = (P + BN - 1) / BN;
  const int tiles = ((n + BM - 1) / BM) * tiles_p;
  const int h = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int n0 = (tile / tiles_p) * BM, p0 = (tile % tiles_p) * BN;
  const int c = blockIdx.y, b = blockIdx.z;
  const long long pos = (long long)c * l;
  const long long bch = ((long long)b * nc + c) * H + h;
  const int tid = threadIdx.x;
  int tr, tc;
  thread_grid(tid, tr, tc);

  const float* ll = ll_in + bch * l;
  const float* dtc = dt + b * st.dt_n + pos * st.dt_s + h;
  const float last = ll[l - 1];
  for (int j = tid; j < l; j += THREADS)
    w[j] = __fmul_rn(expf(__fsub_rn(last, ll[j])), dtc[j * st.dt_s]);
  __syncthreads();

  const Rows<T> la{B + b * st.b_n + pos * st.b_s + n0, st.b_s, l, n - n0};
  const Weighted<T> lb{{X + b * st.x_n + pos * st.x_s + h * st.x_h + p0,
                        st.x_s, l, P - p0}, w};
  float acc[TM][TN];
  zero(acc);
  gemm(acc, smem, la, lb, (l + BK - 1) / BK, tid, tr, tc);
  float* out = states + bch * n * P;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = n0 + out_row(tr, i);
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int q = p0 + out_col(tc, j);
      if (q < P) out[(long long)r * P + q] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// State passing: h_0 = 0, h_{c+1} = exp(ll_last(c)) h_c + s_c, each h_c
// written over s_c, the last into `final`. One thread a state element
// (b, h, n, p); the next chunk's s is loaded before this one's is used.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
ssd_pass_kernel(float* __restrict__ states, const float* __restrict__ ll,
                float* __restrict__ final_state, long long total, int H,
                long long np, int l, int nc) {
  const long long e = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (e >= total) return;
  const long long bh = e / np, q = e % np;   // (b, h), (n, p)
  const long long b = bh / H, h = bh % H;
  const long long step = (long long)H * np;  // one chunk further
  float* s = states + (b * nc * H + h) * np + q;
  const float* llc = ll + (b * nc * H + h) * l + (l - 1);
  float hcur = 0.f;
  float next = s[0];
  for (int c = 0; c < nc; ++c) {
    const float sc = next;
    if (c + 1 < nc) next = s[(c + 1) * step];
    const float a = expf(llc[(long long)c * H * l]);
    s[c * step] = hcur;
    hcur = __fadd_rn(__fmul_rn(a, hcur), sc);
  }
  final_state[e] = hcur;
}

// ---------------------------------------------------------------------------
// The chunk's outputs, rows i0.. of the chunk, columns p0..:
// y = exp(ll_i) (C_i . h_prev) + sum_{j <= i} (cbt_ji exp(ll_i - ll_j)) (x_j dt_j)
// both products accumulating into the same outputs.
// grid (tiles_i * tiles_p * H, nc, N)
// ---------------------------------------------------------------------------

struct Decayed {   // A(m = i, k = j) = cbt[j][i0 + m] exp(ll_i - ll_j), j <= i
  using Raw = float;
  const float* cbt;   // column i0
  const float* ll;
  int i0, l;
  __device__ __forceinline__ bool live(int k, int m) const {
    return i0 + m < l && k <= i0 + m;
  }
  __device__ __forceinline__ float load(int k, int m) const {
    return live(k, m) ? cbt[(long long)k * l + m] : 0.f;
  }
  __device__ __forceinline__ float finish(float v, int k, int m) const {
    return live(k, m) ? __fmul_rn(expf(__fsub_rn(ll[i0 + m], ll[k])), v)
                      : 0.f;
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ssd_scan_kernel(const T* __restrict__ X, const float* __restrict__ dt,
                const float* __restrict__ ct, const float* __restrict__ ll_in,
                const float* __restrict__ cbt,
                const float* __restrict__ states, T* __restrict__ Y,
                Strides st, int l, int H, int P, int n, int nc) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float ll[L_MAX], dts[L_MAX];
  const int tiles_p = (P + BN - 1) / BN;
  const int tiles = ((l + BM - 1) / BM) * tiles_p;
  const int h = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int i0 = (tile / tiles_p) * BM, p0 = (tile % tiles_p) * BN;
  const int c = blockIdx.y, b = blockIdx.z;
  const long long pos = (long long)c * l;
  const long long chunk = (long long)b * nc + c;
  const long long bch = chunk * H + h;
  const int tid = threadIdx.x;
  int tr, tc;
  thread_grid(tid, tr, tc);

  const float* dtc = dt + b * st.dt_n + pos * st.dt_s + h;
  for (int j = tid; j < l; j += THREADS) {
    ll[j] = ll_in[bch * l + j];
    dts[j] = dtc[j * st.dt_s];
  }
  __syncthreads();

  float acc[TM][TN];
  zero(acc);
  if (c > 0) {   // the state entering chunk 0 is zero
    const Rows<float> la{ct + chunk * n * l + i0, l, n, l - i0};
    const Rows<float> lb{states + bch * n * P + p0, P, n, P - p0};
    gemm(acc, smem, la, lb, (n + BK - 1) / BK, tid, tr, tc);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = i0 + out_row(tr, i);
      const float d = r < l ? expf(ll[r]) : 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = __fmul_rn(acc[i][j], d);
    }
  }
  const Decayed la{cbt + chunk * l * l + i0, ll, i0, l};
  const Weighted<T> lb{{X + b * st.x_n + pos * st.x_s + h * st.x_h + p0,
                        st.x_s, l, P - p0}, dts};
  const int jend = min(l, i0 + BM);   // slabs past the diagonal skipped
  gemm(acc, smem, la, lb, (jend + BK - 1) / BK, tid, tr, tc, true, i0);

  T* out = Y + chunk * l * H * (long long)P;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = i0 + out_row(tr, i);
    if (r >= l) continue;
    T* row = out + ((long long)r * H + h) * P;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int q = p0 + out_col(tc, j);
      if (q < P) row[q] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
static int launch(const void* x, const void* dt, const void* a,
                  const void* bm, const void* cm, void* y, void* ll, void* bt,
                  void* ct, void* cbt, void* states, void* final_state,
                  const Strides& st, int N, int l, int nc, int H, int P,
                  int n, cudaStream_t stream) {
  const T* X = static_cast<const T*>(x);
  const T* B = static_cast<const T*>(bm);
  const float* DT = static_cast<const float*>(dt);
  float* LL = static_cast<float*>(ll);
  float* BT = static_cast<float*>(bt);
  float* CT = static_cast<float*>(ct);
  float* CBT = static_cast<float*>(cbt);
  float* S = static_cast<float*>(states);
  const int tiles_p = (P + BN - 1) / BN;
  ssd_prep_kernel<T><<<dim3(((l + 31) / 32) * ((n + 31) / 32), nc, N),
                       THREADS, 0, stream>>>(
      B, static_cast<const T*>(cm), DT, static_cast<const float*>(a), BT, CT,
      LL, st, l, H, n, nc);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  ssd_cb_kernel<<<dim3(((l + BM - 1) / BM) * ((l + BN - 1) / BN), nc, N),
                  THREADS, SMEM, stream>>>(BT, CT, CBT, l, n, nc);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  ssd_state_kernel<T><<<dim3(((n + BM - 1) / BM) * tiles_p * H, nc, N),
                        THREADS, SMEM, stream>>>(X, DT, B, LL, S, st, l, H, P,
                                                 n, nc);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const long long total = (long long)N * H * n * P;
  ssd_pass_kernel<<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0,
                    stream>>>(S, LL, static_cast<float*>(final_state), total,
                              H, (long long)n * P, l, nc);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  ssd_scan_kernel<T><<<dim3(((l + BM - 1) / BM) * tiles_p * H, nc, N),
                       THREADS, SMEM, stream>>>(X, DT, CT, LL, CBT, S,
                                                static_cast<T*>(y), st, l, H,
                                                P, n, nc);
  return (int)cudaGetLastError();
}

}  // namespace ssd
}  // namespace repro_torch

using namespace repro_torch;

// The SSD prefill scan of N sequences of S = nc * l positions: x (N, S, H,
// P) and B, C (N, S, n) of `dtype` (all three one type), dt (N, S, H) and
// a (N, H) fp32, each with the strides given (the last dim of each
// contiguous); y (N, S, H, P) of `dtype` and final_state (N, H, n, P)
// fp32 contiguous; ll (N, nc, H, l), bt and ct (N, nc, n, l), cbt (N, nc,
// l, l) and states (N, nc, H, n, P) fp32 work buffers. The wrapper checks
// l <= 1024, nc and N <= 65535. Five launches on `stream`; returns the
// first launch error (0 on success).
extern "C" int ssd_chunked(const void* x, const void* dt, const void* a,
                           const void* b, const void* c, void* y, void* ll,
                           void* bt, void* ct, void* cbt, void* states,
                           void* final_state, long long x_n, long long x_s,
                           long long x_h, long long b_n, long long b_s,
                           long long c_n, long long c_s, long long dt_n,
                           long long dt_s, long long a_n, long long N,
                           long long l, long long nc, long long H,
                           long long P, long long n, int dtype,
                           void* stream) {
  const ssd::Strides st{x_n, x_s, x_h, b_n, b_s, c_n, c_s, dt_n, dt_s, a_n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return ssd::launch<float>(x, dt, a, b, c, y, ll, bt, ct, cbt, states,
                              final_state, st, (int)N, (int)l, (int)nc,
                              (int)H, (int)P, (int)n, s);
  if (dtype == DT_BF16)
    return ssd::launch<__nv_bfloat16>(x, dt, a, b, c, y, ll, bt, ct, cbt,
                                      states, final_state, st, (int)N, (int)l,
                                      (int)nc, (int)H, (int)P, (int)n, s);
  return (int)cudaErrorInvalidValue;
}
