// Masked multi-head attention from the raw fused-qkv layout: the port of
// uvltrack_tpu/ops/pallas_attention.py::_attn_kernel_qkv (:119, kernel #2),
// which is also the attention half of _ln_qkv_attn_kernel (:167) and
// _ln_qkv_attn_proj_kernel (:291) and, in x's dtype, of the int8 kernels
// (_attn_heads_concat :409 in _ln_qkv_attn_kernel_q8 :433 and
// _ln_qkv_attn_proj_kernel_q8 :489). Two instantiations of the TMA + wgmma
// body in csrc/attention.cuh (design and bounds in its note), which kernel #3
// shares: bf16 (attention_bf16_kernel) and fp32 (qkv_attention_f32_kernel,
// every product as three bf16 hi/lo passes, fp32-accurate); at B.N rows
// where the split rule splits the keys, the batch body of the same header
// (attention_ranges_kernel: one block a query tile, the split's key ranges
// added in its order in registers), with the same bits.
//
//   e   = exp(clip(q . k * D^-1/2 + key_bias, -80, 80))
//   out = (T(e) . v) * (1 / sum_k e)        T = bf16 or fp32, the late division
//
// Layouts: qkv (B, N, 3*H*D) with features [q|k|v] x head x dim, so q, k and
// v are one base pointer offset by 0, C and 2C with strides (N*3C, 3C, D);
// key_bias (B, N) fp32; out (B, N, H*D) in qkv's type. D = 64.
#include "attention.cuh"

namespace {

template <typename T, bool BATCH>
int launch_qkv(const void* qkv, const float* key_bias, void* out, int B, int N, int H,
               float scale, cudaStream_t s) {
  const T* base = static_cast<const T*>(qkv);
  const int C = H * uvl::attn::D;
  const long long sb = static_cast<long long>(N) * 3 * C;
  if constexpr (BATCH)
    return uvl::attn::launch_attention_batch<T>(base, base + C, base + 2 * C, sb, 3 * C,
                                                uvl::attn::D, key_bias, static_cast<T*>(out), B,
                                                N, H, scale, s);
  else
    return uvl::attn::launch_attention<T>(base, base + C, base + 2 * C, sb, 3 * C, uvl::attn::D,
                                          key_bias, static_cast<T*>(out), B, N, H, scale, s);
}

template <bool BATCH>
int entry(const void* qkv, int qkv_is_f32, const float* key_bias, void* out, int B, int N, int H,
          int head_dim, float scale, void* stream) {
  if (head_dim != uvl::attn::D) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = qkv_is_f32
                      ? launch_qkv<float, BATCH>(qkv, key_bias, out, B, N, H, scale, s)
                      : launch_qkv<uvl::bf16, BATCH>(qkv, key_bias, out, B, N, H, scale, s);
  return err ? err : static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv_is_f32: 1 for the fp32 instantiation (fp32 qkv and out), 0 for bf16.
// Requires head_dim == 64 and a 16-byte aligned, contiguous qkv (checked by
// the Python wrapper; a wrong head_dim is refused here too).
extern "C" int uvl_qkv_attention(const void* qkv, int qkv_is_f32, const float* key_bias,
                                 void* out, int B, int N, int H, int head_dim,
                                 float scale, void* stream) {
  return entry<false>(qkv, qkv_is_f32, key_bias, out, B, N, H, head_dim, scale, stream);
}

// The same on the batch body (csrc/attention.cuh): the same arguments, the
// same bits; the wrapper picks it (takes_attn_batch).
extern "C" int uvl_qkv_attention_batch(const void* qkv, int qkv_is_f32, const float* key_bias,
                                       void* out, int B, int N, int H, int head_dim,
                                       float scale, void* stream) {
  return entry<true>(qkv, qkv_is_f32, key_bias, out, B, N, H, head_dim, scale, stream);
}
