// Shared helpers of the port's hand-written Hopper kernels. Each kernel
// source is compiled on its own by nvcc into a shared library with a plain C
// interface (uvltrack_tpu_torch/ops/build.py; the library's hash covers every
// header under csrc/) and called through ctypes; the wrapper passes device
// pointers and PyTorch's current stream, and every entry point returns
// cudaGetLastError() so a refused launch raises in Python.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace uvl {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// fp32 y = hi + lo + r with hi, lo bf16 and |r| <= 2^-17 |y|: an fp32 A
// operand as two bf16 tensor-core passes against a B operand that bf16
// holds exactly (bf16 or int8 weights), fp32-accurate where one bf16 pass
// would round y to 8 significant bits and TF32 to 11.
__device__ __forceinline__ void split_bf16(float y, bf16& hi, bf16& lo) {
  hi = __float2bfloat16(y);
  lo = __float2bfloat16(y - __bfloat162float(hi));
}

}  // namespace uvl

extern "C" const char* uvl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
