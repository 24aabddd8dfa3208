// Helpers shared by the package's CUDA kernels: dtype tags, conversions
// to and from fp32, and the error-string entry point every library exports.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype tags passed from Python (must match ops/_build.py callers)
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// elements of T in one 16-byte vector load
template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);
};

#define EXPORT_ERROR_STRING                                  \
  extern "C" const char* cuda_error_string(int code) {       \
    return cudaGetErrorString(static_cast<cudaError_t>(code)); \
  }
