// LayerNorm + fc1 + exact GELU + fc2: the port of
// uvltrack_tpu/ops/pallas_attention.py::_ln_mlp_kernel (:551, entry
// `fused_ln_mlp` :577), kernel #7, the MLP half of a ViT block before the
// residual add (VitBlock's norm2 -> Mlp; opt-in UVLTRACK_FUSED_MLP=1).
//
//   y   = bf16( LN(x) )                         (fp32 LN, fast variance)
//   h   = bf16( gelu( y . W1^T + b1 ) )         (fp32 acc, erf GELU in fp32)
//   out = bf16( h . W2^T + b2 )                 (fp32 acc; w2's dtype)
//
// Layouts: x (M, C) bf16 or fp32 (rows = B*N tokens; bf16 in the visual
// blocks 0-5, fp32 in the joint blocks 6-11); W1 (F, C) and W2 (C, F) bf16
// in PyTorch's Linear layout; b1 (F,), b2 (C,), gamma, beta (C,) fp32;
// hidden (M, F) bf16 scratch; out (M, C) bf16.
//
// Bound on the H100 (UVLTrack-B, C=768, F=3072), each input read once and
// each output written once: M=361 with fp32 x, 3.41 GFLOP of bf16
// tensor-core work (~3.4 us at 989 TFLOP/s) against 9.4 MB of bf16 weights
// + 1.1 MB of x + 0.55 MB out (~3.3 us at 3.35 TB/s): about even, the
// operations ahead; M=321 with bf16 x, 3.03 GFLOP (~3.1 us) against 10.4 MB.
//
// The Pallas program keeps the whole (N, 4C) hidden tensor in VMEM. On
// Hopper one 64-row tile of it in bf16 is 393 KB, beyond the 227 KB of
// shared memory a block may use, so this port is two kernels and the hidden
// tensor makes one round trip through L2 (2.2 MB at M=361, far inside the
// 50 MB L2):
//   - ln_fc1_gelu: 64x64 tiles over (rows, F columns), 288 blocks at M=361,
//     normalizing the A tile as it loads (ln_stats / ln_a_tile in
//     common.cuh, shared with ln_qkv.cu), epilogue + b1, GELU, bf16;
//   - fc2_bias: K = F = 3072, 32x64 tiles over (rows, C columns) as in
//     proj_residual.cu (144 blocks at M=361; 64x64 would give 72), epilogue
//     + b2, bf16.
// A single kernel would have to split K=3072 of fc2 over blocks and reduce
// across them (atomics or a second pass), or recompute fc1 per output tile;
// that design is later work, as are TMA/wgmma pipelines. bf16 WMMA
// (mma.sync) with fp32 accumulators.
#include "common.cuh"

using namespace nvcuda;
using uvl::bf16;

namespace {

constexpr int BK = uvl::W_TILE_K;  // depth per shared-memory stage
constexpr int THREADS = 128;       // 4 warps
constexpr int LDA = BK + 8;        // padded row strides (bf16 elements)
constexpr int LDB = BK + 8;

// ---------------------------------------------------------- ln_fc1_gelu
constexpr int F1_BM = 64;   // token rows per block
constexpr int F1_BN = 64;   // hidden columns per block (4 warps of 32x32)
constexpr int F1_LDC = F1_BN + 4;

// exact GELU as jax.nn.gelu(approximate=False): 0.5 x erfc(-x / sqrt(2))
__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * erfcf(-v * 0.70710678118654752f);
}

template <typename TX>
__global__ void __launch_bounds__(THREADS)
ln_fc1_gelu_kernel(const TX* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, const bf16* __restrict__ w1,
                   const float* __restrict__ b1, bf16* __restrict__ hidden, int M, int C,
                   int F, float eps) {
  __shared__ __align__(128) bf16 As[F1_BM * LDA];
  __shared__ __align__(128) bf16 Bs[F1_BN * LDB];
  __shared__ __align__(128) float Cs[F1_BM * F1_LDC];
  __shared__ float s_mean[F1_BM];
  __shared__ float s_rstd[F1_BM];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int m0 = blockIdx.y * F1_BM;
  const int n0 = blockIdx.x * F1_BN;

  uvl::ln_stats<F1_BM, THREADS>(x, m0, M, C, eps, s_mean, s_rstd, tid);
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;

  for (int k0 = 0; k0 < C; k0 += BK) {
    uvl::ln_a_tile<F1_BM, THREADS, false>(As, nullptr, LDA, x, gamma, beta, s_mean, s_rstd,
                                          m0, M, C, k0, tid);
    uvl::load_w_tile<F1_BN, THREADS>(Bs, LDB, w1, n0, k0, C, tid);
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
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * F1_LDC + wn + j * 16, acc[i][j], F1_LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < F1_BM * F1_BN; e += THREADS) {
    const int r = e / F1_BN;
    const int c = e % F1_BN;
    const int row = m0 + r;
    if (row < M)
      hidden[static_cast<size_t>(row) * F + n0 + c] =
          __float2bfloat16(gelu_erf(__fadd_rn(Cs[r * F1_LDC + c], b1[n0 + c])));
  }
}

// -------------------------------------------------------------- fc2_bias
constexpr int F2_BM = 32;   // token rows per block
constexpr int F2_BN = 64;   // output columns per block (4 warps of 16x32)
constexpr int F2_LDC = F2_BN + 4;

__global__ void __launch_bounds__(THREADS)
fc2_bias_kernel(const bf16* __restrict__ hidden, const bf16* __restrict__ w2,
                const float* __restrict__ b2, bf16* __restrict__ out, int M, int K, int C) {
  __shared__ __align__(128) bf16 As[F2_BM * LDA];
  __shared__ __align__(128) bf16 Bs[F2_BN * LDB];
  __shared__ __align__(128) float Cs[F2_BM * F2_LDC];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int m0 = blockIdx.y * F2_BM;
  const int n0 = blockIdx.x * F2_BN;
  const int wm = (warp >> 1) * 16;
  const int wn = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    uvl::load_a_tile<F2_BM, THREADS>(As, LDA, hidden, m0, M, k0, K, tid);
    uvl::load_w_tile<F2_BN, THREADS>(Bs, LDB, w2, n0, k0, K, tid);
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
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(Cs + wm * F2_LDC + wn + j * 16, acc[j], F2_LDC,
                            wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < F2_BM * F2_BN; e += THREADS) {
    const int r = e / F2_BN;
    const int c = e % F2_BN;
    const int row = m0 + r;
    if (row < M)
      out[static_cast<size_t>(row) * C + n0 + c] =
          __float2bfloat16(__fadd_rn(Cs[r * F2_LDC + c], b2[n0 + c]));
  }
}

}  // namespace

// x_is_f32: 1 when x is fp32 (the joint blocks' stream), 0 when bf16.
// stages: a bitmask of the launches to make -- 1 ln_fc1_gelu (x -> hidden),
// 2 fc2_bias (hidden -> out), 3 both (the kernel's function; the wrapper's
// call). Requires C % 64 == 0, F % 64 == 0 and 16-byte aligned W1, W2 and
// hidden (checked by the Python wrapper).
extern "C" int uvl_ln_mlp(const void* x, int x_is_f32, const float* gamma, const float* beta,
                          const void* w1, const float* b1, const void* w2, const float* b2,
                          void* hidden, void* out, int M, int C, int F, float eps, int stages,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* h = static_cast<bf16*>(hidden);
  if (stages & 1) {
    const dim3 grid(F / F1_BN, (M + F1_BM - 1) / F1_BM);
    if (x_is_f32)
      ln_fc1_gelu_kernel<float><<<grid, THREADS, 0, s>>>(
          static_cast<const float*>(x), gamma, beta, static_cast<const bf16*>(w1), b1, h, M,
          C, F, eps);
    else
      ln_fc1_gelu_kernel<bf16><<<grid, THREADS, 0, s>>>(
          static_cast<const bf16*>(x), gamma, beta, static_cast<const bf16*>(w1), b1, h, M,
          C, F, eps);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (stages & 2) {
    const dim3 grid(C / F2_BN, (M + F2_BM - 1) / F2_BM);
    fc2_bias_kernel<<<grid, THREADS, 0, s>>>(h, static_cast<const bf16*>(w2), b2,
                                             static_cast<bf16*>(out), M, F, C);
  }
  return static_cast<int>(cudaGetLastError());
}
