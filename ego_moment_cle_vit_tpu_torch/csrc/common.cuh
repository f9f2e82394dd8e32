// Shared helpers for the port's CUDA kernels (plain C interface, sm_90a).
#pragma once

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes passed from Python (kernels/_build.py DTYPE_CODES)
#define EMCT_DTYPE_F32 0
#define EMCT_DTYPE_BF16 1

template <typename T>
__device__ __forceinline__ float to_f32(T x);

template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);

template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Above 48 KB a block's dynamic shared memory must be allowed explicitly.
template <typename Kernel>
__host__ inline cudaError_t emct_allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

extern "C" const char* emct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
