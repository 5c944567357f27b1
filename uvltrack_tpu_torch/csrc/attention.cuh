// The bf16 masked-attention kernel shared by csrc/qkv_attention.cu (kernel #2,
// and the attention half of #1/#4-#6 in bf16) and csrc/attention.cu (kernel
// #3): the math of uvltrack_tpu/ops/pallas_attention.py::_attn_kernel (:78)
// and _attn_kernel_qkv (:119), which differ only in where q, k and v live.
//
//   e   = exp(clip(q . k * D^-1/2 + key_bias, -80, 80))   (fp32, no max
//         subtraction: the clamp keeps exp finite and turns the -1e10 ViT /
//         -10000 BERT mask bias into e^-80)
//   out = bf16( (bf16(e) . v) * (1 / sum_k e) )           (late division)
//
// q, k, v: bf16, element (b, n, h, d) at base + b*sb + n*sn + h*sh + d, the
// same strides for all three (a fused qkv row, or three (B, N, H*D) or
// (B, H, N, D) tensors); key_bias (B, N) fp32; out (B, N, H, D) bf16,
// contiguous. D = 64.
//
// The TPU kernels run all heads of a batch element in one program
// (grid=(B,)); here the grid is (32-row query tile, head, batch), so batch 1
// fills the 132 SMs at the ViT's N (144 blocks at N=361) and BERT's 40
// tokens still spread over 2 x 12 blocks. Keys and values stream through
// shared memory in 64-row tiles; because the clamp replaces the running max,
// the tiles need no online rescaling and the fp32 row sum and the fp32 P.V
// accumulators simply add up across tiles. Rows and keys past N (a ragged
// last tile: N=40 is one partial query tile and one partial key tile) load
// as zeros and weigh exactly 0. The (N, N) scores never leave the SM. bf16
// WMMA (mma.sync), fp32 accumulators.
#pragma once

#include "common.cuh"

namespace {

namespace attn {
constexpr int D = 64;             // head dim
constexpr int WARPS = 2;          // each warp owns 16 query rows
constexpr int BQ = 16 * WARPS;    // query rows per block
constexpr int BKV = 64;           // keys per shared-memory tile
constexpr int THREADS = 32 * WARPS;
constexpr int LDH = D + 8;        // padded bf16 row stride of Q/K/V tiles
constexpr int LDS = BKV + 4;      // fp32 score tile stride
constexpr int LDP = BKV + 8;      // bf16 probability tile stride
constexpr float CLAMP = 80.f;
static_assert(D == BKV, "the score tile doubles as the output staging tile");
}  // namespace attn

__global__ void __launch_bounds__(attn::THREADS)
attention_bf16_kernel(const uvl::bf16* __restrict__ q, const uvl::bf16* __restrict__ k,
                      const uvl::bf16* __restrict__ v, long long sb, int sn, int sh,
                      const float* __restrict__ key_bias, uvl::bf16* __restrict__ out,
                      int N, int H, float scale) {
  using namespace nvcuda;
  using uvl::bf16;
  constexpr int D = attn::D, WARPS = attn::WARPS, BQ = attn::BQ, BKV = attn::BKV;
  constexpr int THREADS = attn::THREADS, LDH = attn::LDH, LDS = attn::LDS, LDP = attn::LDP;
  constexpr float CLAMP = attn::CLAMP;
  __shared__ __align__(128) bf16 Qs[BQ * LDH];
  __shared__ __align__(128) bf16 Ks[BKV * LDH];
  __shared__ __align__(128) bf16 Vs[BKV * LDH];
  __shared__ __align__(128) float Ss[WARPS][16 * LDS];
  __shared__ __align__(128) bf16 Ps[WARPS][16 * LDP];
  __shared__ float s_bias[BKV];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head = static_cast<size_t>(b) * sb + static_cast<size_t>(h) * sh;
  const bf16* qh = q + head;
  const bf16* kh = k + head;
  const bf16* vh = v + head;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int c = tid; c < BQ * (D / 8); c += THREADS) {
    const int r = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    uint4 val = zero;
    if (q0 + r < N)
      val = *reinterpret_cast<const uint4*>(qh + static_cast<size_t>(q0 + r) * sn + col);
    *reinterpret_cast<uint4*>(&Qs[r * LDH + col]) = val;
  }
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], Qs + warp * 16 * LDH + kk * 16, LDH);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[D / 16];
#pragma unroll
  for (int nf = 0; nf < D / 16; ++nf) wmma::fill_fragment(of[nf], 0.f);

  float* S = Ss[warp];
  bf16* P = Ps[warp];
  const int pr = lane >> 1;         // this lane's row of the warp's 16
  const int pc = (lane & 1) * 32;   // and its half of the 64 columns
  float rowsum = 0.f;

  for (int j0 = 0; j0 < N; j0 += BKV) {
    __syncthreads();  // the previous tile's K/V reads are done
    for (int c = tid; c < BKV * (D / 8); c += THREADS) {
      const int r = c / (D / 8);
      const int col = (c % (D / 8)) * 8;
      uint4 kv = zero, vv = zero;
      if (j0 + r < N) {
        const size_t row = static_cast<size_t>(j0 + r) * sn + col;
        kv = *reinterpret_cast<const uint4*>(kh + row);
        vv = *reinterpret_cast<const uint4*>(vh + row);
      }
      *reinterpret_cast<uint4*>(&Ks[r * LDH + col]) = kv;
      *reinterpret_cast<uint4*>(&Vs[r * LDH + col]) = vv;
    }
    for (int c = tid; c < BKV; c += THREADS)
      s_bias[c] = j0 + c < N ? key_bias[static_cast<size_t>(b) * N + j0 + c] : 0.f;
    __syncthreads();

    // S = Q K^T for this warp's 16 rows against 64 keys
#pragma unroll
    for (int nf = 0; nf < BKV / 16; ++nf) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + nf * 16 * LDH + kk * 16, LDH);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(S + nf * 16, sf, LDS, wmma::mem_row_major);
    }
    __syncwarp();
    // clamped exp; keys past N weigh exactly 0
#pragma unroll 8
    for (int i = 0; i < 32; ++i) {
      const int c = pc + i;
      float e = 0.f;
      if (j0 + c < N) {
        const float s = fminf(fmaxf(S[pr * LDS + c] * scale + s_bias[c], -CLAMP), CLAMP);
        e = expf(s);
      }
      rowsum += e;
      P[pr * LDP + c] = __float2bfloat16(e);
    }
    __syncwarp();
    // O += bf16(e) V
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
      wmma::load_matrix_sync(pf, P + kk * 16, LDP);
#pragma unroll
      for (int nf = 0; nf < D / 16; ++nf) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, Vs + kk * 16 * LDH + nf * 16, LDH);
        wmma::mma_sync(of[nf], pf, vf, of[nf]);
      }
    }
  }

  rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 1);
  __syncwarp();
#pragma unroll
  for (int nf = 0; nf < D / 16; ++nf)
    wmma::store_matrix_sync(S + nf * 16, of[nf], LDS, wmma::mem_row_major);
  __syncwarp();
  const int qi = q0 + warp * 16 + pr;
  if (qi < N) {
    const float inv = 1.f / rowsum;
    bf16* orow = out + ((static_cast<size_t>(b) * N + qi) * H + h) * D + pc;
#pragma unroll 8
    for (int i = 0; i < 32; ++i) orow[i] = __float2bfloat16(S[pr * LDS + pc + i] * inv);
  }
}

// Launch on a (query tile, H, B) grid with the strides above; the caller
// returns cudaGetLastError().
inline void launch_attention_bf16(const uvl::bf16* q, const uvl::bf16* k, const uvl::bf16* v,
                                  long long sb, int sn, int sh, const float* key_bias,
                                  uvl::bf16* out, int B, int N, int H, float scale,
                                  cudaStream_t s) {
  const dim3 grid((N + attn::BQ - 1) / attn::BQ, H, B);
  attention_bf16_kernel<<<grid, attn::THREADS, 0, s>>>(q, k, v, sb, sn, sh, key_bias, out, N,
                                                       H, scale);
}

}  // namespace
