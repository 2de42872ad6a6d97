// Shared pieces of the port's CUDA kernels: element-type conversion, the
// dynamic shared-memory opt-in, and the error-string export every library
// carries for its Python wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace codo {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
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

// Element-type codes of the C entry points (kernels/common.py dtype_code).
enum DType { kF32 = 0, kBF16 = 1 };

// Opt Kernel in to `bytes` of dynamic shared memory on the current device,
// once per device and size: a call that repeats the attribute spends host
// time on every launch.
template <auto Kernel>
cudaError_t set_smem(size_t bytes) {
  static size_t done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = bytes;
  return err;
}

}  // namespace codo

extern "C" const char* codo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
