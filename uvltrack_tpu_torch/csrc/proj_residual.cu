// Output projection + bias + residual add: the epilogue of
// uvltrack_tpu/ops/pallas_attention.py::_ln_qkv_attn_proj_kernel (:291,
// kernel #4, :320-325) and of _ln_qkv_attn_proj_kernel_q8 (:489, kernel #6,
// :511-517). The port composes those kernels as the attention prefix
// (csrc/ln_qkv.cu + csrc/qkv_attention.cu) followed by this kernel.
//
//   out[m, n] = x[m, n] + TX( sum_k A[m, k] * Wp[n, k] (* s[n]) + b[n] )
//
// fp32 accumulation, fp32 epilogue (the int8 scale multiplies the
// accumulator, then the bias is added), ONE rounding of the projection to
// x's type, then the residual add in x's type (a bf16 x rounds twice, as
// the Pallas kernels do; an fp32 x not at all). Instantiations (x, A, Wp):
//   - #4: (bf16, bf16, bf16) and (fp32, bf16, bf16): A is the attention
//     output cast to w_proj's dtype;
//   - #6: (bf16, bf16, int8) and (fp32, fp32, int8): everything in x's
//     type. The fp32 A runs as two bf16 tensor-core passes, A = hi + lo
//     (split_bf16 in common.cuh; the int8 payload is exact in bf16), which
//     is fp32-accurate; no TF32.
//
// Layouts: x, out (M, C) bf16 or fp32, rows = B*N tokens; A (M, K) bf16 or
// fp32; Wp (C, K) bf16 or int8 in PyTorch's Linear layout, s (C,) fp32 per
// row; b (C,) fp32.
//
// Bound on the H100 (UVLTrack-B, M=361, K=C=768), each input read once and
// each output written once: the fp32 #6 instantiation moves 1.11 MB of x,
// 1.11 MB of A, 0.59 MB of int8 Wp and 1.11 MB of out (~1.2 us at
// 3.35 TB/s) against 2 x 0.43 GFLOP of bf16 tensor-core passes (~0.9 us):
// the bytes bound it, and more so for the others. The TPU kernels run this
// product inside the one program per batch element with Wp resident in
// VMEM; here it is a grid of 32x64 output tiles, 144 blocks at M=361 (132
// at M=321), so batch 1 fills the 132 SMs (64x64 tiles would give 72). bf16
// WMMA (mma.sync) with fp32 accumulators; no TMA/wgmma pipeline yet.
#include "common.cuh"

using namespace nvcuda;
using uvl::bf16;

namespace {

constexpr int BM = 32;   // token rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = uvl::W_TILE_K;
constexpr int THREADS = 128;  // 4 warps, each a 16x32 sub-tile
constexpr int LDA = BK + 8;   // padded row strides (bf16 elements)
constexpr int LDB = BK + 8;
constexpr int LDC = BN + 4;   // fp32 epilogue tile

__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const bf16*) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename TX, typename TA, typename TW>
__global__ void __launch_bounds__(THREADS)
proj_residual_kernel(const TX* __restrict__ x, const TA* __restrict__ a,
                     const TW* __restrict__ w, const float* __restrict__ wscale,
                     const float* __restrict__ bias, TX* __restrict__ out, int M,
                     int K, int C) {
  constexpr bool SPLIT = std::is_same<TA, float>::value;
  __shared__ __align__(128) bf16 As[BM * LDA];
  __shared__ __align__(128) bf16 Al[SPLIT ? BM * LDA : 8];  // low halves
  __shared__ __align__(128) bf16 Bs[BN * LDB];
  __shared__ __align__(128) float Cs[BM * LDC];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 16;
  const int wn = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    if constexpr (SPLIT) {
      for (int c = tid; c < BM * (BK / 4); c += THREADS) {
        const int r = c / (BK / 4);
        const int q = (c % (BK / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (m0 + r < M)
          v = *reinterpret_cast<const float4*>(a + static_cast<size_t>(m0 + r) * K + k0 + q);
        uvl::split_bf16(v.x, As[r * LDA + q], Al[r * LDA + q]);
        uvl::split_bf16(v.y, As[r * LDA + q + 1], Al[r * LDA + q + 1]);
        uvl::split_bf16(v.z, As[r * LDA + q + 2], Al[r * LDA + q + 2]);
        uvl::split_bf16(v.w, As[r * LDA + q + 3], Al[r * LDA + q + 3]);
      }
    } else {
      uvl::load_a_tile<BM, THREADS>(As, LDA, a, m0, M, k0, K, tid);
    }
    uvl::load_w_tile<BN, THREADS>(Bs, LDB, w, n0, k0, K, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], Bs + (wn + j * 16) * LDB + kk, LDB);
      wmma::load_matrix_sync(af, As + wm * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[j], af, bfr[j], acc[j]);
      if constexpr (SPLIT) {
        wmma::load_matrix_sync(af, Al + wm * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[j], af, bfr[j], acc[j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(Cs + wm * LDC + wn + j * 16, acc[j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN;
    const int c = e % BN;
    const int row = m0 + r;
    if (row < M) {
      const size_t i = static_cast<size_t>(row) * C + n0 + c;
      const float proj = round_as(uvl::scale_bias<TW>(Cs[r * LDC + c], wscale, bias, n0 + c), x);
      uvl::store(out + i, uvl::to_f32(x[i]) + proj);
    }
  }
}

template <typename TX, typename TA, typename TW>
int launch(const void* x, const void* a, const void* w, const float* wscale,
           const float* bias, void* out, int M, int K, int C, cudaStream_t s) {
  const dim3 grid(C / BN, (M + BM - 1) / BM);
  proj_residual_kernel<TX, TA, TW><<<grid, THREADS, 0, s>>>(
      static_cast<const TX*>(x), static_cast<const TA*>(a), static_cast<const TW*>(w),
      wscale, bias, static_cast<TX*>(out), M, K, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_is_f32 / a_is_f32: 1 for fp32, 0 for bf16; w_is_i8: 1 for an int8
// payload with its fp32 per-row scale w_scale, 0 for a bf16 weight. Only the
// four instantiations above exist; any other combination is refused.
// Requires K % 32 == 0, C % 64 == 0 and 16-byte aligned A and Wp (checked
// by the Python wrapper).
extern "C" int uvl_proj_residual(const void* x, int x_is_f32, const void* a, int a_is_f32,
                                 const void* w, int w_is_i8, const float* w_scale,
                                 const float* bias, void* out, int M, int K, int C,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!w_is_i8 && !a_is_f32) {
    if (x_is_f32) return launch<float, bf16, bf16>(x, a, w, w_scale, bias, out, M, K, C, s);
    return launch<bf16, bf16, bf16>(x, a, w, w_scale, bias, out, M, K, C, s);
  }
  if (w_is_i8 && w_scale != nullptr) {
    if (x_is_f32 && a_is_f32)
      return launch<float, float, int8_t>(x, a, w, w_scale, bias, out, M, K, C, s);
    if (!x_is_f32 && !a_is_f32)
      return launch<bf16, bf16, int8_t>(x, a, w, w_scale, bias, out, M, K, C, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
