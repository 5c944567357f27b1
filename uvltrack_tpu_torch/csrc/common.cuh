// Shared helpers of the port's hand-written Hopper kernels. Each kernel
// source is compiled on its own by nvcc into a shared library with a plain C
// interface (uvltrack_tpu_torch/ops/build.py) and called through ctypes; the
// wrapper passes device pointers and PyTorch's current stream, and every
// entry point returns cudaGetLastError() so a refused launch raises in Python.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace uvl {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace uvl

extern "C" const char* uvl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
