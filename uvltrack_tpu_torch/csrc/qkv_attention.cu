// Masked multi-head attention from the raw fused-qkv layout: the port of
// uvltrack_tpu/ops/pallas_attention.py::_attn_kernel_qkv (:119), which is
// also the attention half of _ln_qkv_attn_kernel (:167) and, in x's dtype,
// of the int8 kernels (_attn_heads_concat :409 in _ln_qkv_attn_kernel_q8
// :433 and _ln_qkv_attn_proj_kernel_q8 :489). Two instantiations: bf16
// (tensor cores; the kernel of csrc/attention.cuh, which kernel #3 shares)
// and fp32 (FFMA; below).
//
//   e   = exp(clip(q . k * D^-1/2 + key_bias, -80, 80))
//   out = bf16( (bf16(e) . v) * (1 / sum_k e) )           (late division)
//
// Layouts: qkv (B, N, 3*H*D) with features [q|k|v] x head x dim, so q, k and
// v are one base pointer offset by 0, C and 2C with strides (N*3C, 3C, D);
// key_bias (B, N) fp32; out (B, N, H*D). D = 64.
//
// Bound on the H100 (UVLTrack-B, N=361, H=12): 0.40 GFLOP of tensor-core work
// against 1.66 MB of qkv in and 0.55 MB out, ~0.66 us of bytes at 3.35 TB/s
// vs ~0.40 us of operations: the bytes bound it. The grid and tiling are
// attention.cuh's: (32-row query tile, head, batch), 144 blocks at N=361,
// 132 at N=321.
#include "attention.cuh"

using uvl::bf16;

namespace {

constexpr int D = attn::D;
constexpr float CLAMP = attn::CLAMP;

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
    const bf16* base = static_cast<const bf16*>(qkv);
    const int C = H * D;
    launch_attention_bf16(base, base + C, base + 2 * C, static_cast<long long>(N) * 3 * C,
                          3 * C, D, key_bias, static_cast<bf16*>(out), B, N, H, scale, s);
  }
  return static_cast<int>(cudaGetLastError());
}
