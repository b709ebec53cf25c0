// K2 and K3: the int8 wire codec (the unary streaming plugin).
//
// K2 `quantize_blocks` replaces the TPU kernel
// repro/kernels/quantize.py::quantize_blocks (body `_quant_kernel`); K3
// `dequantize_blocks` replaces repro/kernels/quantize.py::dequantize_blocks
// (body `_dequant_kernel`). The TPU kernels took a flat payload padded to
// 128 blocks of 256 (32768 elements); these take the rank-stacked payload
// of one segment exchange, (rows, n_valid), and pad each rank's row to
// whole 256-element blocks on its own, so a block never straddles two
// ranks. That is the reference's jnp wire format (repro/core/plugins.py),
// which is what its engine sends.
//
// Bound on the H100: memory. K2 reads 4 bytes and writes ~1 byte per
// element; K3 reads ~1 (+4 for the fused combine) and writes 4; a handful
// of operations each. Least time = bytes moved / 3.35 TB/s.
//
// Numerics, matched bit for bit to the reference:
//  * K2: scale = max(amax * float32(1/127), 1e-12) — the reference's
//    compiler turns `amax / 127` into a multiply by the rounded
//    reciprocal; codes are rint(x / scale) by IEEE division
//    (round-half-even), clamped to +-127. For a bf16 payload the scale,
//    the floor and the quotient round to bf16, as the reference's bf16
//    arithmetic does.
//  * K3: fp32 `add` at the consume site is one rounding, fmaf(q, s, old),
//    because the reference contracts the dequantize multiply into the
//    combine add. bf16, or max/min/mul, round q*s to the buffer dtype
//    first and then combine, as the reference does.
#include "common.cuh"

namespace repro_torch {

constexpr int QUANT_BLOCK = 256;

// One warp per 256-element block: eight coalesced 32-wide loads, a
// shuffle max-reduce, then each lane writes its eight codes.
template <typename T>
__global__ void quantize_kernel(const T* __restrict__ x,
                                signed char* __restrict__ q,
                                float* __restrict__ s, long long rows,
                                long long n_valid, long long n_pad) {
  const long long nb = n_pad / QUANT_BLOCK;
  const long long warp =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows * nb) return;  // whole warps exit together
  const long long r = warp / nb, blk = warp % nb;
  const T* xr = x + r * n_valid;
  float v[8];
  float amax = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const long long i = blk * QUANT_BLOCK + k * 32 + lane;
    v[k] = i < n_valid ? to_f32(xr[i]) : 0.0f;
    amax = fmaxf(amax, fabsf(v[k]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  // A bf16 payload's codec runs in bf16 in the reference: the scale,
  // its floor and each quotient round to bf16 (to_f32(from_f32<T>(.))
  // is the identity for fp32).
  float scale = to_f32(from_f32<T>(__fmul_rn(amax, 1.0f / 127.0f)));
  scale = fmaxf(scale, to_f32(from_f32<T>(1e-12f)));
  signed char* qr = q + r * n_pad + blk * QUANT_BLOCK;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float c = rintf(to_f32(from_f32<T>(__fdiv_rn(v[k], scale))));
    c = fminf(fmaxf(c, -127.0f), 127.0f);
    qr[k * 32 + lane] = (signed char)(int)c;
  }
  if (lane == 0) s[r * nb + blk] = scale;
}

template <typename T, int OP>
__global__ void dequantize_kernel(const signed char* __restrict__ q,
                                  const float* __restrict__ s,
                                  const T* __restrict__ old,
                                  T* __restrict__ out, long long n_valid,
                                  long long n_pad) {
  const long long row = blockIdx.y;
  const long long nb = n_pad / QUANT_BLOCK;
  const signed char* qr = q + row * n_pad;
  const float* sr = s + row * nb;
  const long long base = row * n_valid;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n_valid; i += (long long)gridDim.x * blockDim.x) {
    const float qv = (float)qr[i];
    const float sv = sr[i / QUANT_BLOCK];
    T res;
    if constexpr (OP == OP_COPY) {
      res = from_f32<T>(__fmul_rn(qv, sv));
    } else if constexpr (OP == OP_ADD && sizeof(T) == 4) {
      res = from_f32<T>(__fmaf_rn(qv, sv, to_f32(old[base + i])));
    } else {
      const T w = from_f32<T>(__fmul_rn(qv, sv));
      res = from_f32<T>(apply_op<OP>(to_f32(old[base + i]), to_f32(w)));
    }
    out[base + i] = res;
  }
}

template <typename T, int OP>
static void launch_dequant(const signed char* q, const float* s,
                           const void* old, void* out, long long rows,
                           long long n_valid, long long n_pad,
                           cudaStream_t stream) {
  const int threads = 256;
  long long bx = (n_valid + threads - 1) / threads;
  const long long cap = (132LL * 16 + rows - 1) / rows;
  if (bx > cap) bx = cap;
  if (bx < 1) bx = 1;
  dim3 grid((unsigned)bx, (unsigned)rows);
  dequantize_kernel<T, OP><<<grid, threads, 0, stream>>>(
      q, s, static_cast<const T*>(old), static_cast<T*>(out), n_valid, n_pad);
}

template <typename T>
static int dispatch_dequant(const signed char* q, const float* s,
                            const void* old, void* out, long long rows,
                            long long n_valid, long long n_pad, int op,
                            cudaStream_t st) {
  switch (op) {
    case OP_COPY: launch_dequant<T, OP_COPY>(q, s, old, out, rows, n_valid, n_pad, st); break;
    case OP_ADD: launch_dequant<T, OP_ADD>(q, s, old, out, rows, n_valid, n_pad, st); break;
    case OP_MAX: launch_dequant<T, OP_MAX>(q, s, old, out, rows, n_valid, n_pad, st); break;
    case OP_MIN: launch_dequant<T, OP_MIN>(q, s, old, out, rows, n_valid, n_pad, st); break;
    case OP_MUL: launch_dequant<T, OP_MUL>(q, s, old, out, rows, n_valid, n_pad, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace repro_torch

using namespace repro_torch;

// Returns the launch's cudaGetLastError() (0 on success).
extern "C" int k2_quantize_blocks(const void* x, signed char* q, float* s,
                                  long long rows, long long n_valid,
                                  long long n_pad, int in_dtype,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;  // 8 warps = 8 scale blocks per CTA
  const long long warps = rows * (n_pad / QUANT_BLOCK);
  const long long blocks = (warps * 32 + threads - 1) / threads;
  if (blocks < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (in_dtype == DT_F32)
    quantize_kernel<float><<<(unsigned)blocks, threads, 0, st>>>(
        static_cast<const float*>(x), q, s, rows, n_valid, n_pad);
  else if (in_dtype == DT_BF16)
    quantize_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), q, s, rows, n_valid, n_pad);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// `old` may be null for op == OP_COPY. Returns cudaGetLastError().
extern "C" int k3_dequantize_blocks(const signed char* q, const float* s,
                                    const void* old, void* out,
                                    long long rows, long long n_valid,
                                    long long n_pad, int out_dtype, int op,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 1 || rows > 65535) return (int)cudaErrorInvalidValue;
  int rc;
  if (out_dtype == DT_F32)
    rc = dispatch_dequant<float>(q, s, old, out, rows, n_valid, n_pad, op, st);
  else if (out_dtype == DT_BF16)
    rc = dispatch_dequant<__nv_bfloat16>(q, s, old, out, rows, n_valid, n_pad,
                                         op, st);
  else
    return (int)cudaErrorInvalidValue;
  if (rc) return rc;
  return (int)cudaGetLastError();
}
