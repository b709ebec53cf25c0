// Shared helpers for the port's hand-written Hopper kernels.
//
// Built by kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// and never with --use_fast_math: the kernels must reproduce the
// reference's IEEE division, round-half-even and rounding points bit for
// bit, so every multiply, add and divide below names its rounding
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fmaf_rn) and no contraction is left
// to the compiler.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

// dtype codes shared with the Python wrappers (kernels/_build.py)
enum DType { DT_F32 = 0, DT_BF16 = 1 };
// combine op codes shared with the Python wrappers
enum Op { OP_COPY = 0, OP_ADD = 1, OP_MAX = 2, OP_MIN = 3, OP_MUL = 4 };

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// The binary streaming plugin in fp32. max/min propagate NaN and keep
// the first operand on ties, as torch.maximum/minimum do.
template <int OP> __device__ __forceinline__ float apply_op(float a, float b) {
  if (OP == OP_ADD) return __fadd_rn(a, b);
  if (OP == OP_MUL) return __fmul_rn(a, b);
  if (OP == OP_MAX) return (a != a) ? a : ((b != b) ? b : (a < b ? b : a));
  if (OP == OP_MIN) return (a != a) ? a : ((b != b) ? b : (b < a ? b : a));
  return b;  // OP_COPY
}

}  // namespace repro_torch
