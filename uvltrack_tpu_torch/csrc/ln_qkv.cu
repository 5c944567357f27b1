// LayerNorm + fused qkv projection: the prologue half of
// uvltrack_tpu/ops/pallas_attention.py::_ln_qkv_attn_kernel (:167, bf16
// weight) and of its int8-weight variant _ln_qkv_attn_kernel_q8 (:433).
//
//   out[m, n] = TO( sum_k TC(LN(x)[m, k]) * W[n, k] (* s[n]) + b[n] )
//   LN(x) = (x - mean) * rsqrt(max(mean(x^2) - mean^2, 0) + eps) * g + beta
//
// fp32 statistics with flax's fast variance clamped at 0, fp32 accumulation,
// fp32 epilogue (the int8 scale multiplies the accumulator, then the bias is
// added), one rounding to the output's type at the end: the rounding points
// of the Pallas kernels. The compute type TC is the output's type TO:
//   - bf16 weight (#1): TC = bf16 whatever x is; the normalized row is
//     rounded to bf16 before the product;
//   - int8 weight (#5): TC = x's type. bf16 x rounds like #1; fp32 x (the
//     joint blocks' stream) keeps the normalized row and qkv in fp32. That
//     product runs as two bf16 tensor-core passes, y = hi + lo (split_bf16 in
//     common.cuh): the int8 payload is exact in bf16, so the sum loses at
//     most 2^-17 |y| per term -- fp32-accurate, where one bf16 pass (a TPU's
//     default precision) or TF32 would round y.
//
// Layouts: x (M, C) bf16 or fp32, rows = B*N tokens; W (3C, C) bf16 or int8
// in PyTorch's Linear layout (out, in), s (3C,) fp32 per-row scale of the
// int8 payload; b, g, beta fp32; out (M, 3C) bf16 or fp32.
//
// Two designs, one per weight type:
//   - bf16 W (#1): the TMA + wgmma core of gemm_sm90.cuh (kind LN_BIAS): the
//     normalized 64-row block sits in shared memory once, W streams through
//     a 4-stage TMA ring, 64 x 128 output tiles (two m64n64k16 warpgroups),
//     18 x 6 = 108 blocks at M=321/361, C=768 (F=2304): one wave on the 132
//     SMs (at 160 KB of shared memory, one block an SM).
//   - int8 W (#5): the WMMA (mma.sync) kernel below, 64x64 tiles, 216 blocks
//     at M=361; each block computes the LN statistics of its 64 rows and
//     normalizes the A tile as it loads it; an int8 W tile converts to bf16
//     in shared memory, so the weight streams from device memory at one byte
//     a value. One shared-memory stage; its redesign is later work.
//
// Bound on the H100 (UVLTrack-B, C=768), each input read once and each
// output written once: M=361, fp32 x, bf16 W: 1.28 GFLOP of bf16 tensor-core
// work (~1.3 us at 989 TFLOP/s) against 3.5 MB of W + 1.1 MB of x + 1.7 MB
// of bf16 out (~1.9 us at 3.35 TB/s): the bytes bound it. M=321, bf16 x,
// int8 W: 1.14 GFLOP (~1.15 us) against 1.77 MB of int8 W + 0.49 MB of x +
// 1.48 MB of bf16 out (~1.1 us): about even. M=361, fp32 x, int8 W: 2 x
// 1.28 GFLOP for the two passes (~2.6 us) against 6.2 MB (~1.9 us). The TPU
// kernels keep the whole weight resident in VMEM and run grid=(B,): one
// program, which on Hopper would occupy one of 132 SMs.
#include "gemm_sm90.cuh"

using namespace nvcuda;
using uvl::bf16;

namespace {

constexpr int BM = 64;   // token rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = uvl::W_TILE_K;  // depth per shared-memory stage
constexpr int THREADS = 128;  // 4 warps, each a 32x32 sub-tile
constexpr int LDA = BK + 8;   // padded row strides (bf16 elements)
constexpr int LDB = BK + 8;
constexpr int LDC = BN + 4;   // fp32 epilogue tile

// the int8-weight instantiations (#5); TO is x's type
template <typename TX, typename TW, typename TO>
__global__ void __launch_bounds__(THREADS)
ln_qkv_kernel(const TX* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, const TW* __restrict__ w,
              const float* __restrict__ wscale, const float* __restrict__ wb,
              TO* __restrict__ out, int M, int C, int F, float eps) {
  constexpr bool SPLIT = std::is_same<TO, float>::value;  // fp32 compute
  __shared__ __align__(128) bf16 As[BM * LDA];
  __shared__ __align__(128) bf16 Al[SPLIT ? BM * LDA : 8];  // low halves
  __shared__ __align__(128) bf16 Bs[BN * LDB];
  __shared__ __align__(128) float Cs[BM * LDC];
  __shared__ float s_mean[BM];
  __shared__ float s_rstd[BM];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  uvl::ln_stats<BM, THREADS>(x, m0, M, C, eps, s_mean, s_rstd, tid);
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;

  for (int k0 = 0; k0 < C; k0 += BK) {
    uvl::ln_a_tile<BM, THREADS, SPLIT>(As, Al, LDA, x, gamma, beta, s_mean, s_rstd, m0, M, C,
                                       k0, tid);
    uvl::load_w_tile<BN, THREADS>(Bs, LDB, w, n0, k0, C, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], Bs + (wn + j * 16) * LDB + kk, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], As + (wm + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
      if constexpr (SPLIT) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(af[i], Al + (wm + i * 16) * LDA + kk, LDA);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
      }
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
      uvl::store(out + static_cast<size_t>(row) * F + n0 + c,
                 uvl::scale_bias<TW>(Cs[r * LDC + c], wscale, wb, n0 + c));
  }
}

template <typename TX, typename TW, typename TO>
int launch(const void* x, const float* gamma, const float* beta, const void* w,
           const float* wscale, const float* wb, void* out, int M, int C, int F,
           float eps, cudaStream_t s) {
  const dim3 grid(F / BN, (M + BM - 1) / BM);
  ln_qkv_kernel<TX, TW, TO><<<grid, THREADS, 0, s>>>(
      static_cast<const TX*>(x), gamma, beta, static_cast<const TW*>(w), wscale, wb,
      static_cast<TO*>(out), M, C, F, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_is_f32: 1 when x is fp32 (the joint blocks' stream), 0 when bf16.
// w_is_i8: 1 for an int8 payload with its fp32 per-row scale w_scale (out
// in x's type), 0 for a bf16 weight (out bf16). Requires C % 64 == 0
// (C <= 1024 for a bf16 W: the LN block in shared memory), F % 64 == 0
// and 16-byte aligned x and W (checked by the Python wrapper).
extern "C" int uvl_ln_qkv(const void* x, int x_is_f32, const float* gamma,
                          const float* beta, const void* w, int w_is_i8,
                          const float* w_scale, const float* wb, void* out, int M,
                          int C, int F, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!w_is_i8) {
    using uvl::sm90::launch_ln_gemm;
    const bf16* wb16 = static_cast<const bf16*>(w);
    bf16* o = static_cast<bf16*>(out);
    if (x_is_f32)
      return launch_ln_gemm<uvl::sm90::LN_BIAS, float, 128, 4>(
          static_cast<const float*>(x), gamma, beta, wb16, wb, o, M, C, F, eps, s);
    return launch_ln_gemm<uvl::sm90::LN_BIAS, bf16, 128, 4>(
        static_cast<const bf16*>(x), gamma, beta, wb16, wb, o, M, C, F, eps, s);
  }
  if (w_scale == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (x_is_f32)
    return launch<float, int8_t, float>(x, gamma, beta, w, w_scale, wb, out, M, C, F, eps, s);
  return launch<bf16, int8_t, bf16>(x, gamma, beta, w, w_scale, wb, out, M, C, F, eps, s);
}
