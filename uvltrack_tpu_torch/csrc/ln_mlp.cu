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
// At TPU.COMPUTE_DTYPE=float32 (fp32 x and weights; _xla_ln_mlp with fp32
// weights, :601-613) nothing rounds to bf16: y, h and out are fp32, W1 and
// W2 arrive as their hi and lo bf16 planes (csrc/split_hilo.cu, split once
// per weight and cached by the wrapper) and every product runs three passes,
// hi.hi + lo.hi + hi.lo. ln_fc1_gelu runs the core's persistent
// ln_hilo_kernel (64 x 192 tiles, x normalized and split a k-tile at a time,
// a 3-stage ring of 64 KB stages) and writes an fp32 hidden (M, F);
// fc2_bias reads it as an fp32 A (split by the consumers) against W2's
// planes, 64 x 128 tiles, K split over clusters of 3 (108 blocks at
// M=321/361, C=768), fp32 out.
//
// Bound on the H100 (UVLTrack-B, C=768, F=3072), each input read once and
// each output written once: M=361 with fp32 x, 3.41 GFLOP of bf16
// tensor-core work (~3.4 us at 989 TFLOP/s) against 9.4 MB of bf16 weights
// + 1.1 MB of x + 0.55 MB out (~3.3 us at 3.35 TB/s): about even, the
// operations ahead; M=321 with bf16 x, 3.03 GFLOP (~3.1 us) against 10.4 MB.
//
// The Pallas program keeps the whole (N, 4C) hidden tensor in VMEM. On
// Hopper one 64-row tile of it in bf16 is 393 KB, beyond the 227 KB of
// shared memory a block may use, so this port is two launches of the TMA +
// wgmma core (gemm_sm90.cuh) and the hidden tensor makes one round trip
// through L2 (2.2 MB at M=361, far inside the 50 MB L2):
//   - ln_fc1_gelu (kind LN_BIAS_GELU): the normalized 64-row block in shared
//     memory once, W1 through a 3-stage TMA ring, 64 x 192 tiles (two
//     m64n96k16 warpgroups), epilogue + b1, GELU, bf16: 16 x 6 = 96 blocks
//     at M=321/361, one wave on the 132 SMs at one block an SM (BN=128
//     would give 144 blocks, two waves of the LN prologue);
//   - fc2_bias (kind SPLITK_BIAS): K = F = 3072 split over clusters of 4
//     blocks (768 each), hidden and W2 both through a 4-stage TMA ring,
//     64 x 192 tiles (two m64n96k16 warpgroups), the four fp32 partials
//     summed through distributed shared memory in rank order (the same
//     output on every run), + b2, bf16: 4 x 6 x 4 = 96 blocks at
//     M=321/361, one wave at one block an SM (129 KB of shared memory).
//     BN=128 gave 144 blocks, two an SM on 12 SMs, which then read twice
//     the bytes of the others: 11.3 us against 9.2-9.8 us at BN=192 (an
//     A/B on one H100, uvltrack_tpu_torch/tools/gemm_ab.py).
// The old kernels (PR 4) ran one 32-deep shared-memory stage with WMMA and
// paid one device-memory latency a k-step (24 steps for fc1, 96 for fc2 on
// 144 blocks of 4 warps); the TMA ring keeps the loads in flight instead.
#include "gemm_sm90.cuh"

using uvl::bf16;

// x_is_f32: 1 when x is fp32 (the joint blocks' stream), 0 when bf16;
// w_is_f32: 1 for fp32 weights given as their hi/lo planes, W1 (2, F, C)
// and W2 (2, C, F) bf16 (split_hilo; fp32 x only), with an fp32 hidden and
// out; out_is_f32 with bf16 weights: fc2_bias writes an fp32 out (a
// tensor-parallel rank's partial h_r . W2_r^T, the caller's b2 zero: the
// model group sums the partials, then adds b2 and rounds once). stages: a bitmask of the launches to make -- 1 ln_fc1_gelu (x -> hidden),
// 2 fc2_bias (hidden -> out), 3 both (the kernel's function; the wrapper's
// call). Requires C % 64 == 0, C <= 1024, F % 256 == 0 and 16-byte aligned
// x, W1, W2 and hidden (checked by the Python wrapper).
extern "C" int uvl_ln_mlp(const void* x, int x_is_f32, const float* gamma, const float* beta,
                          const void* w1, const float* b1, const void* w2, const float* b2,
                          int w_is_f32, int out_is_f32, void* hidden, void* out, int M, int C,
                          int F, float eps, int stages, void* stream) {
  using namespace uvl::sm90;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_is_f32) {
    if (!x_is_f32) return static_cast<int>(cudaErrorInvalidValue);
    float* h = static_cast<float*>(hidden);
    int err = 0;
    if (stages & 1)
      err = launch_ln_hilo<LN_BIAS_GELU, 192, 3>(static_cast<const float*>(x), gamma, beta,
                                                 static_cast<const HiLo*>(w1), b1, h, M, C, F,
                                                 eps, s);
    if (!err && (stages & 2))
      err = launch_splitk_gemm<SPLITK_BIAS, float, float, HiLo, 128, 4, 3>(
          h, static_cast<const HiLo*>(w2), nullptr, nullptr, b2, static_cast<float*>(out), M, F,
          C, s);
    return err ? err : static_cast<int>(cudaGetLastError());
  }
  bf16* h = static_cast<bf16*>(hidden);
  int err = 0;
  if (stages & 1) {
    const bf16* w = static_cast<const bf16*>(w1);
    err = x_is_f32 ? launch_ln_gemm<LN_BIAS_GELU, float, bf16, bf16, 192, 3>(
                       static_cast<const float*>(x), gamma, beta, w, nullptr, b1, h, M, C, F,
                       eps, s)
                 : launch_ln_gemm<LN_BIAS_GELU, bf16, bf16, bf16, 192, 3>(
                       static_cast<const bf16*>(x), gamma, beta, w, nullptr, b1, h, M, C, F,
                       eps, s);
  }
  if (!err && (stages & 2))
    err = out_is_f32
              ? launch_splitk_gemm<SPLITK_BIAS, bf16, bf16, bf16, 192, 4, 4, float>(
                    h, static_cast<const bf16*>(w2), nullptr, nullptr, b2,
                    static_cast<float*>(out), M, F, C, s)
              : launch_splitk_gemm<SPLITK_BIAS, bf16, bf16, bf16, 192, 4, 4>(
                    h, static_cast<const bf16*>(w2), nullptr, nullptr, b2,
                    static_cast<bf16*>(out), M, F, C, s);
  return err ? err : static_cast<int>(cudaGetLastError());
}
