// LayerNorm + fused qkv projection: the prologue half of
// uvltrack_tpu/ops/pallas_attention.py::_ln_qkv_attn_kernel (:167).
//
//   out[m, n] = bf16( sum_k bf16(LN(x)[m, k]) * W[n, k]  + b[n] )
//   LN(x) = (x - mean) * rsqrt(max(mean(x^2) - mean^2, 0) + eps) * g + beta
//
// fp32 statistics with flax's fast variance clamped at 0, the normalized row
// rounded to bf16 before the product, fp32 accumulation, fp32 bias, one bf16
// rounding at the end: the rounding points of the Pallas kernel.
//
// Layouts: x (M, C) bf16 or fp32, rows = B*N tokens; W (3C, C) bf16 in
// PyTorch's Linear layout (out, in); b, g, beta fp32; out (M, 3C) bf16.
//
// Bound on the H100 (UVLTrack-B, M=361, C=768): 1.28 GFLOP of bf16 tensor-core
// work (~1.3 us at 989 TFLOP/s) against 3.54 MB of weight + 0.55 MB of bf16
// x + 1.66 MB of output (~1.7 us at 3.35 TB/s): the bytes bound it, narrowly,
// and more so in the joint blocks, whose x is fp32. The TPU kernel keeps the whole weight resident in
// VMEM and runs grid=(B,): one program, which on Hopper would occupy one of
// 132 SMs. Here the product is tiled 64x64 over (rows, output columns), 216
// blocks at M=361, so the card fills at batch 1; each block computes the LN
// statistics of its 64 rows and normalizes the A tile as it loads it, so the
// normalized activations never reach device memory. bf16 WMMA (mma.sync)
// with fp32 accumulators; no TMA/wgmma pipeline yet (a later PR's work).
#include "common.cuh"

using namespace nvcuda;
using uvl::bf16;

namespace {

constexpr int BM = 64;   // token rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 32;   // depth per shared-memory stage
constexpr int THREADS = 128;  // 4 warps, each a 32x32 sub-tile
constexpr int LDA = BK + 8;   // padded row strides (bf16 elements)
constexpr int LDB = BK + 8;
constexpr int LDC = BN + 4;   // fp32 epilogue tile

template <typename TX>
__global__ void __launch_bounds__(THREADS)
ln_qkv_kernel(const TX* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, const bf16* __restrict__ w,
              const float* __restrict__ wb, bf16* __restrict__ out, int M,
              int C, int F, float eps) {
  __shared__ __align__(128) bf16 As[BM * LDA];
  __shared__ __align__(128) bf16 Bs[BN * LDB];
  __shared__ __align__(128) float Cs[BM * LDC];
  __shared__ float s_mean[BM];
  __shared__ float s_rstd[BM];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // LayerNorm statistics of this block's rows, one warp per row.
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int row = m0 + r;
    float s = 0.f, ss = 0.f;
    if (row < M) {
      const TX* xr = x + static_cast<size_t>(row) * C;
      for (int k = lane; k < C; k += 32) {
        const float v = uvl::to_f32(xr[k]);
        s += v;
        ss += v * v;
      }
    }
    s = uvl::warp_sum(s);
    ss = uvl::warp_sum(ss);
    if (lane == 0) {
      const float mean = s / C;
      const float var = fmaxf(ss / C - mean * mean, 0.f);
      s_mean[r] = mean;
      s_rstd[r] = row < M ? 1.f / sqrtf(var + eps) : 0.f;
    }
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;

  // each thread normalizes 16 consecutive values of one A-tile row
  const int a_r = tid >> 1;
  const int a_c = (tid & 1) * 16;
  const int a_row = m0 + a_r;
  const float a_mean = s_mean[a_r];
  const float a_rstd = s_rstd[a_r];
  const TX* xa = x + static_cast<size_t>(a_row < M ? a_row : 0) * C;

  for (int k0 = 0; k0 < C; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int k = k0 + a_c + i;
      float y = 0.f;
      if (a_row < M) {
        y = (uvl::to_f32(xa[k]) - a_mean) * a_rstd;
        y = y * gamma[k] + beta[k];
      }
      As[a_r * LDA + a_c + i] = __float2bfloat16(y);
    }
    // W rows n0..n0+63, columns k0..k0+31, as 16-byte vectors
    for (int c = tid; c < BN * (BK / 8); c += THREADS) {
      const int r = c / (BK / 8);
      const int q = (c % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(&Bs[r * LDB + q]) =
          *reinterpret_cast<const uint4*>(w + static_cast<size_t>(n0 + r) * C + k0 + q);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], As + (wm + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], Bs + (wn + j * 16) * LDB + kk, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * LDC + wn + j * 16, acc[i][j],
                              LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN;
    const int c = e % BN;
    const int row = m0 + r;
    if (row < M)
      out[static_cast<size_t>(row) * F + n0 + c] =
          __float2bfloat16(Cs[r * LDC + c] + wb[n0 + c]);
  }
}

}  // namespace

// x_is_f32: 1 when x is fp32 (the joint blocks' stream), 0 when bf16.
// Requires C % 32 == 0, F % 64 == 0, 16-byte aligned W (checked by the
// Python wrapper).
extern "C" int uvl_ln_qkv(const void* x, int x_is_f32, const float* gamma,
                          const float* beta, const void* w, const float* wb,
                          void* out, int M, int C, int F, float eps,
                          void* stream) {
  const dim3 grid(F / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* wp = static_cast<const bf16*>(w);
  bf16* op = static_cast<bf16*>(out);
  if (x_is_f32)
    ln_qkv_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), gamma, beta, wp, wb, op, M, C, F, eps);
  else
    ln_qkv_kernel<bf16><<<grid, THREADS, 0, s>>>(
        static_cast<const bf16*>(x), gamma, beta, wp, wb, op, M, C, F, eps);
  return static_cast<int>(cudaGetLastError());
}
