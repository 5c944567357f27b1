// Shared helpers of the port's hand-written Hopper kernels. Each kernel
// source is compiled on its own by nvcc into a shared library with a plain C
// interface (uvltrack_tpu_torch/ops/build.py; the library's hash covers every
// header under csrc/) and called through ctypes; the wrapper passes device
// pointers and PyTorch's current stream, and every entry point returns
// cudaGetLastError() so a refused launch raises in Python.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace uvl {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// one rounding of an fp32 value to the output's type
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

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

// Depth of a weight tile: rows n0..n0+ROWS-1, columns k0..k0+31 of a
// row-major (out, K) weight (PyTorch's Linear layout) go to a bf16 shared
// tile with row stride ld.
constexpr int W_TILE_K = 32;

// bf16 weight: 16-byte vector copies.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_w_tile(bf16* dst, int ld, const bf16* w, int n0,
                                            int k0, int K, int tid) {
  for (int c = tid; c < ROWS * (W_TILE_K / 8); c += THREADS) {
    const int r = c / (W_TILE_K / 8);
    const int q = (c % (W_TILE_K / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * ld + q) =
        *reinterpret_cast<const uint4*>(w + static_cast<size_t>(n0 + r) * K + k0 + q);
  }
}

// bf16 activation tile: rows m0..m0+ROWS-1 (zero past M), columns
// k0..k0+31 of a row-major (M, K) matrix, 16-byte vector copies.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_a_tile(bf16* dst, int ld, const bf16* a, int m0, int M,
                                            int k0, int K, int tid) {
  for (int c = tid; c < ROWS * (W_TILE_K / 8); c += THREADS) {
    const int r = c / (W_TILE_K / 8);
    const int q = (c % (W_TILE_K / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < M)
      v = *reinterpret_cast<const uint4*>(a + static_cast<size_t>(m0 + r) * K + k0 + q);
    *reinterpret_cast<uint4*>(dst + r * ld + q) = v;
  }
}

// int8 payload: 16 values per 16-byte load, converted to bf16 in shared
// memory (exact: |q| <= 127 needs 7 significant bits). The per-row scale is
// applied to the fp32 accumulator in the epilogue, never to the tile.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_w_tile(bf16* dst, int ld, const int8_t* w, int n0,
                                            int k0, int K, int tid) {
  for (int c = tid; c < ROWS * (W_TILE_K / 16); c += THREADS) {
    const int r = c / (W_TILE_K / 16);
    const int q = (c % (W_TILE_K / 16)) * 16;
    const uint4 v =
        *reinterpret_cast<const uint4*>(w + static_cast<size_t>(n0 + r) * K + k0 + q);
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
    uint32_t u[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t wd = words[j >> 1] >> ((j & 1) * 16);
      const __nv_bfloat162 p =
          __floats2bfloat162_rn(static_cast<float>(static_cast<int8_t>(wd & 0xffu)),
                                static_cast<float>(static_cast<int8_t>((wd >> 8) & 0xffu)));
      u[j] = *reinterpret_cast<const uint32_t*>(&p);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + q) = make_uint4(u[0], u[1], u[2], u[3]);
    *reinterpret_cast<uint4*>(dst + r * ld + q + 8) = make_uint4(u[4], u[5], u[6], u[7]);
  }
}

// fp32 epilogue of a product column: acc (* per-row weight scale) + bias,
// in the Pallas kernels' order (the scale product rounded before the add).
template <typename TW>
__device__ __forceinline__ float scale_bias(float acc, const float* scale, const float* bias,
                                            int n) {
  if constexpr (std::is_same<TW, int8_t>::value) acc = __fmul_rn(acc, scale[n]);
  return __fadd_rn(acc, bias[n]);
}

// The LayerNorm prologue of ln_qkv.cu's int8-weight products (gemm_sm90.cuh
// keeps the same contract for the bf16-weight ones):
// flax's fp32 LayerNorm with the fast variance clamped at 0,
//   LN(x) = (x - mean) * rsqrt(max(mean(x^2) - mean^2, 0) + eps) * g + beta,
// applied to the A tile as it loads, so the normalized rows never reach
// device memory.
//
// Statistics of rows m0..m0+ROWS-1 of x (M, C), one warp per row; rows past
// M get rstd 0.
template <int ROWS, int THREADS, typename TX>
__device__ __forceinline__ void ln_stats(const TX* x, int m0, int M, int C, float eps,
                                         float* s_mean, float* s_rstd, int tid) {
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int r = warp; r < ROWS; r += THREADS / 32) {
    const int row = m0 + r;
    float s = 0.f, ss = 0.f;
    if (row < M) {
      const TX* xr = x + static_cast<size_t>(row) * C;
      for (int k = lane; k < C; k += 32) {
        const float v = to_f32(xr[k]);
        s += v;
        ss += v * v;
      }
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    if (lane == 0) {
      const float mean = s / C;
      const float var = fmaxf(ss / C - mean * mean, 0.f);
      s_mean[r] = mean;
      s_rstd[r] = row < M ? 1.f / sqrtf(var + eps) : 0.f;
    }
  }
}

// The normalized (ROWS x W_TILE_K) A tile at depth k0, one thread per 16
// consecutive values of a row, rounded to bf16 (SPLIT: as hi + lo halves,
// split_bf16); rows past M are zero. Row stride ld.
template <int ROWS, int THREADS, bool SPLIT, typename TX>
__device__ __forceinline__ void ln_a_tile(bf16* hi, bf16* lo, int ld, const TX* x,
                                          const float* gamma, const float* beta,
                                          const float* s_mean, const float* s_rstd, int m0,
                                          int M, int C, int k0, int tid) {
  static_assert(ROWS * (W_TILE_K / 16) == THREADS, "one thread per 16 values of the tile");
  const int r = tid / (W_TILE_K / 16);
  const int c = (tid % (W_TILE_K / 16)) * 16;
  const int row = m0 + r;
  const TX* xr = x + static_cast<size_t>(row < M ? row : 0) * C;
  const float mean = s_mean[r];
  const float rstd = s_rstd[r];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int k = k0 + c + i;
    float y = 0.f;
    if (row < M) {
      y = (to_f32(xr[k]) - mean) * rstd;
      y = y * gamma[k] + beta[k];
    }
    if constexpr (SPLIT)
      split_bf16(y, hi[r * ld + c + i], lo[r * ld + c + i]);
    else
      hi[r * ld + c + i] = __float2bfloat16(y);
  }
}

}  // namespace uvl

extern "C" const char* uvl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
