// Masked multi-head attention on head-major q, k, v: the port of
// uvltrack_tpu/ops/pallas_attention.py::_attn_kernel (:78, entry
// `fused_attention` :96), kernel #3, which the JAX package reaches through
// attention_core in BERT's layers (uvltrack_tpu/models/bert.py:85) when
// N >= min_seq_len() (UVLTRACK_PALLAS_MIN_N, default 128; BERT runs at
// N = MAX_QUERY_LEN = 40, so at the default it stays on the plain path).
//
//   e   = exp(clip(q . k * D^-1/2 + key_bias, -80, 80))
//   out = bf16( (bf16(e) . v) * (1 / sum_k e) )
//
// The kernel is csrc/attention.cuh's bf16 TMA + wgmma body, shared with
// csrc/qkv_attention.cu; this source only binds it to three separate base
// pointers. q, k and v carry (batch, token, head) strides, which its 4-D
// tensor maps take as they are, so BERT's view(B, N, H, D) of its (B, N, C)
// query/key/value products needs no transpose copy; the output is (B, N, H,
// D) contiguous, which the wrapper returns as a (B, H, N, D) view. An
// all-masked key row (BERT's text mask all 0 in BBOX mode: bias -10000
// everywhere) clamps every score to -80, so every key gets e^-80 and the
// row is the uniform average of v, as in the Pallas kernel.
//
// Bound on the H100 (BERT-base layer, B=1, N=40, H=12, D=64), each input
// read once and each output written once: 4.9 MFLOP against 3 x 61 KB of
// bf16 q, k, v, 160 B of bias and 61 KB out (~0.07 us at 3.35 TB/s, ~0.005
// us of operations): the bytes bound it, and at this size any kernel is
// bound by its launch and one load round trip (a few us). At N=40 the grid
// is one query tile and one key tile a head (12 blocks, no split).
#include "attention.cuh"

// q, k, v: bf16 with element (b, n, h, d) at base + b*sb + n*sn + h*sh + d;
// out (B, N, H, D) bf16 contiguous. Requires head_dim == 64, strides that
// are multiples of 8 and 16-byte aligned bases (checked by the Python
// wrapper; a wrong head_dim is refused here too).
extern "C" int uvl_attention(const void* q, const void* k, const void* v, long long sb,
                             int sn, int sh, const float* key_bias, void* out, int B, int N,
                             int H, int head_dim, float scale, void* stream) {
  using uvl::bf16;
  if (head_dim != uvl::attn::D) return static_cast<int>(cudaErrorInvalidValue);
  const int err = uvl::attn::launch_attention<bf16>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), sb,
      sn, sh, key_bias, static_cast<bf16*>(out), B, N, H, scale,
      static_cast<cudaStream_t>(stream));
  return err ? err : static_cast<int>(cudaGetLastError());
}
