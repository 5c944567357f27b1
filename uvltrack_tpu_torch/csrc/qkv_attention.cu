// Masked multi-head attention from the raw fused-qkv layout: the port of
// uvltrack_tpu/ops/pallas_attention.py::_attn_kernel_qkv (:119), which is
// also the attention half of _ln_qkv_attn_kernel (:167) and, in x's dtype,
// of the int8 kernels (_attn_heads_concat :409 in _ln_qkv_attn_kernel_q8
// :433 and _ln_qkv_attn_proj_kernel_q8 :489). Two instantiations: bf16
// (tensor cores; below) and fp32 (FFMA; after it).
//
//   e   = exp(clip(q . k * D^-1/2 + key_bias, -80, 80))   (fp32, no max
//         subtraction: the clamp keeps exp finite and turns the -1e10 mask
//         bias into e^-80)
//   out = bf16( (bf16(e) . v) * (1 / sum_k e) )           (late division)
//
// Layouts: qkv (B, N, 3*H*D) bf16 with features [q|k|v] x head x dim;
// key_bias (B, N) fp32; out (B, N, H*D) bf16. D = 64.
//
// Bound on the H100 (UVLTrack-B, N=361, H=12): 0.40 GFLOP of tensor-core work
// against 1.66 MB of qkv in and 0.55 MB out, ~0.66 us of bytes at 3.35 TB/s
// vs ~0.40 us of operations: the bytes bound it. The TPU kernel runs all
// heads of a batch element in one program (grid=(B,)); here the grid is
// (32-row query tile, head, batch) -- 144 blocks at N=361, 132 at N=321 --
// so batch 1 fills the 132 SMs. Keys and values stream through shared
// memory in 64-row tiles; because the clamp replaces the running max, the
// tiles need no online rescaling and the fp32 row sum and the fp32 P.V
// accumulators simply add up across tiles. The (N, N) scores never leave
// the SM. bf16 WMMA (mma.sync), fp32 accumulators.
#include "common.cuh"

using namespace nvcuda;
using uvl::bf16;

namespace {

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

__global__ void __launch_bounds__(THREADS)
qkv_attention_kernel(const bf16* __restrict__ qkv,
                     const float* __restrict__ key_bias,
                     bf16* __restrict__ out, int N, int H, float scale) {
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
  const int C = H * D;
  const int F = 3 * C;
  const bf16* base = qkv + static_cast<size_t>(b) * N * F;
  const int qoff = h * D;
  const int koff = C + h * D;
  const int voff = 2 * C + h * D;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int c = tid; c < BQ * (D / 8); c += THREADS) {
    const int r = c / (D / 8);
    const int q = (c % (D / 8)) * 8;
    uint4 v = zero;
    if (q0 + r < N)
      v = *reinterpret_cast<const uint4*>(base + static_cast<size_t>(q0 + r) * F + qoff + q);
    *reinterpret_cast<uint4*>(&Qs[r * LDH + q]) = v;
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
      const int q = (c % (D / 8)) * 8;
      uint4 kv = zero, vv = zero;
      if (j0 + r < N) {
        const bf16* row = base + static_cast<size_t>(j0 + r) * F;
        kv = *reinterpret_cast<const uint4*>(row + koff + q);
        vv = *reinterpret_cast<const uint4*>(row + voff + q);
      }
      *reinterpret_cast<uint4*>(&Ks[r * LDH + q]) = kv;
      *reinterpret_cast<uint4*>(&Vs[r * LDH + q]) = vv;
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
  const int q = q0 + warp * 16 + pr;
  if (q < N) {
    const float inv = 1.f / rowsum;
    bf16* orow = out + (static_cast<size_t>(b) * N + q) * C + h * D + pc;
#pragma unroll 8
    for (int i = 0; i < 32; ++i) orow[i] = __float2bfloat16(S[pr * LDS + pc + i] * inv);
  }
}

// fp32 instantiation: the int8 kernels' attention in the fp32 joint blocks,
// where q, k, v, the scores, e, P.V and the output all stay fp32 (e is not
// rounded: e.astype(v.dtype) is fp32). The oracle is fp32, so the products
// run in FFMA -- no tensor cores, no TF32, whose 11-bit operands would
// round q, k, e and v.
//
//   e   = exp(clip(q . k * D^-1/2 + key_bias, -80, 80))
//   out = (e . v) * (1 / sum_k e)
//
// Bound on the H100 (N=361, H=12): 0.40 GFLOP, which the card could do
// fp32-accurately as three bf16 tensor-core passes of hi/lo halves (1.20
// GFLOP, ~1.2 us), against 3.33 MB of fp32 qkv in and 1.11 MB out (~1.3 us
// at 3.35 TB/s): the bytes bound it. This first version runs the products
// in FFMA, whose 67 TFLOP/s put its own floor at 6 us. The grid
// is the bf16 kernel's: (32-row query tile, head, batch), 144 blocks at
// N=361. Each thread owns one query row and a quarter of the key and head
// columns (interleaved, so a warp's shared-memory reads fall in distinct
// banks); keys and values stream through shared memory in 32-row tiles, and
// with the clamp in place of a running max the fp32 row sums and P.V
// accumulators simply add up across tiles.
constexpr int FQ = 32;            // query rows per block
constexpr int FKV = 32;           // keys per shared-memory tile
constexpr int FTHREADS = 128;     // 4 threads per query row
constexpr int LDQ32 = D + 1;      // padded fp32 row strides
constexpr int LDK32 = D + 1;
constexpr int LDP32 = FKV + 1;

__global__ void __launch_bounds__(FTHREADS)
qkv_attention_f32_kernel(const float* __restrict__ qkv,
                         const float* __restrict__ key_bias,
                         float* __restrict__ out, int N, int H, float scale) {
  __shared__ float Qs[FQ * LDQ32];
  __shared__ float Ks[FKV * LDK32];
  __shared__ __align__(16) float Vs[FKV * D];
  __shared__ float Ps[FQ * LDP32];
  __shared__ float s_bias[FKV];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * FQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C = H * D;
  const int F = 3 * C;
  const float* base = qkv + static_cast<size_t>(b) * N * F;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int c = tid; c < FQ * (D / 4); c += FTHREADS) {
    const int r = c / (D / 4);
    const int q = (c % (D / 4)) * 4;
    float4 v = zero;
    if (q0 + r < N)
      v = *reinterpret_cast<const float4*>(base + static_cast<size_t>(q0 + r) * F + h * D + q);
    float* dst = Qs + r * LDQ32 + q;
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  }

  const int r = tid >> 2;  // this thread's query row
  const int j = tid & 3;   // its phase: key columns j + 4i, head columns j + 4i
  float o[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) o[i] = 0.f;
  float rowsum = 0.f;

  for (int j0 = 0; j0 < N; j0 += FKV) {
    __syncthreads();  // Q is in; the previous tile's K/V reads are done
    for (int c = tid; c < FKV * (D / 4); c += FTHREADS) {
      const int kr = c / (D / 4);
      const int q = (c % (D / 4)) * 4;
      float4 kv = zero, vv = zero;
      if (j0 + kr < N) {
        const float* row = base + static_cast<size_t>(j0 + kr) * F;
        kv = *reinterpret_cast<const float4*>(row + C + h * D + q);
        vv = *reinterpret_cast<const float4*>(row + 2 * C + h * D + q);
      }
      float* kd = Ks + kr * LDK32 + q;
      kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
      *reinterpret_cast<float4*>(Vs + kr * D + q) = vv;
    }
    for (int c = tid; c < FKV; c += FTHREADS)
      s_bias[c] = j0 + c < N ? key_bias[static_cast<size_t>(b) * N + j0 + c] : 0.f;
    __syncthreads();

    float s[FKV / 4];
#pragma unroll
    for (int i = 0; i < FKV / 4; ++i) s[i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qd = Qs[r * LDQ32 + d];
#pragma unroll
      for (int i = 0; i < FKV / 4; ++i) s[i] = fmaf(qd, Ks[(j + 4 * i) * LDK32 + d], s[i]);
    }
#pragma unroll
    for (int i = 0; i < FKV / 4; ++i) {
      const int c = j + 4 * i;
      float e = 0.f;
      if (j0 + c < N) {
        const float t = __fadd_rn(__fmul_rn(s[i], scale), s_bias[c]);
        e = expf(fminf(fmaxf(t, -CLAMP), CLAMP));
      }
      rowsum += e;
      Ps[r * LDP32 + c] = e;
    }
    __syncwarp();  // a row's 4 threads share a warp
#pragma unroll 4
    for (int c = 0; c < FKV; ++c) {
      const float p = Ps[r * LDP32 + c];
#pragma unroll
      for (int i = 0; i < D / 4; ++i) o[i] = fmaf(p, Vs[c * D + j + 4 * i], o[i]);
    }
  }

  rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 1);
  rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 2);
  const int q = q0 + r;
  if (q < N) {
    const float inv = 1.f / rowsum;
    float* orow = out + (static_cast<size_t>(b) * N + q) * C + h * D;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) orow[j + 4 * i] = o[i] * inv;
  }
}

}  // namespace

// qkv_is_f32: 1 for the fp32 instantiation (fp32 qkv and out), 0 for bf16.
// Requires head_dim == 64 and a 16-byte aligned, contiguous qkv (checked by
// the Python wrapper; a wrong head_dim is refused here too).
extern "C" int uvl_qkv_attention(const void* qkv, int qkv_is_f32, const float* key_bias,
                                 void* out, int B, int N, int H, int head_dim,
                                 float scale, void* stream) {
  if (head_dim != D) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qkv_is_f32) {
    const dim3 grid((N + FQ - 1) / FQ, H, B);
    qkv_attention_f32_kernel<<<grid, FTHREADS, 0, s>>>(
        static_cast<const float*>(qkv), key_bias, static_cast<float*>(out), N, H, scale);
  } else {
    const dim3 grid((N + BQ - 1) / BQ, H, B);
    qkv_attention_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const bf16*>(qkv), key_bias, static_cast<bf16*>(out), N, H, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
