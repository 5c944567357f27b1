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
// A tensor-parallel rank's share (F/tp of fc1's columns and fc2's rows, an
// fp32 out before b2; uvl_ln_mlp_partial) runs at a training step's M = B.N
// = 5,776 rows, where the launches above lost to their library calls (207
// us at F = 1,536 against 84): the 64-row LN kind normalizes its x rows again
// for every column tile, with no product overlapping that prologue, on a
// non-persistent grid of 728 blocks, and fc2 splits K over clusters of 4 at
// an M whose tiles alone fill the card. The share runs three launches
// instead, the last two on the core's large-M body (persistent, 128-row
// tiles, K unsplit, TMA-stored epilogues; gemm_sm90.cuh):
//   - ln_rows_kernel: y = bf16(LN(x)), each row normalized once (8.9 MB of y
//     at B's C = 768, which stays in L2 for the next launch);
//   - LN_BIAS_GELU: the hidden tensor gelu(y . W1^T + b1) in bf16, 128 x 128
//     tiles, the GELUs taken from the fp32 tile staged in shared memory;
//   - GEMM_F32OUT: the hidden tensor . W2^T, 128 x 128-256 tiles, fp32 out.
// Bound at F = 1,536: 2 x 13.6 GFLOP (27.6 us at 989 TFLOP/s). Two designs
// lost to this one on one H100 (uvltrack_tpu_torch/tools/gemm_ab.py --tp):
// x normalized a k-tile ahead of the products inside each 128 x 128 tile
// (fc1 135 us: every column tile read its fp32 rows again, and each row
// block's statistics pass waited on device memory with no product running),
// and the GELU applied to the accumulator fragments (fc1 88 us).
// The old kernels (PR 4) ran one 32-deep shared-memory stage with WMMA and
// paid one device-memory latency a k-step (24 steps for fc1, 96 for fc2 on
// 144 blocks of 4 warps); the TMA ring keeps the loads in flight instead.
#include "gemm_sm90.cuh"

using uvl::bf16;

// x_is_f32: 1 when x is fp32 (the joint blocks' stream), 0 when bf16;
// w_is_f32: 1 for fp32 weights given as their hi/lo planes, W1 (2, F, C)
// and W2 (2, C, F) bf16 (split_hilo; fp32 x only), with an fp32 hidden and
// out. stages: a bitmask of the launches to make -- 1 ln_fc1_gelu (x ->
// hidden), 2 fc2_bias (hidden -> out), 3 both (the kernel's function; the
// wrapper's call). Requires C % 64 == 0, C <= 1024, F % 256 == 0 and
// 16-byte aligned x, W1, W2 and hidden (checked by the Python wrapper).
extern "C" int uvl_ln_mlp(const void* x, int x_is_f32, const float* gamma, const float* beta,
                          const void* w1, const float* b1, const void* w2, const float* b2,
                          int w_is_f32, void* hidden, void* out, int M, int C, int F,
                          float eps, int stages, void* stream) {
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
    err = launch_splitk_gemm<SPLITK_BIAS, bf16, bf16, bf16, 192, 4, 4>(
        h, static_cast<const bf16*>(w2), nullptr, nullptr, b2, static_cast<bf16*>(out), M, F, C,
        s);
  return err ? err : static_cast<int>(cudaGetLastError());
}

// A tensor-parallel rank's share, out (M, C) fp32 = gelu(LN(x) . W1^T + b1)
// (rounded to bf16) . W2^T (+ b2, null for the share itself): x (M, C) bf16
// or fp32 (x_is_f32), W1 (F, C) and W2 (C, F) bf16 (F = the rank's hidden
// columns), b1 (F,) and b2 (C,) fp32; normed (M, C) and hidden (M, F) bf16
// scratch. stages: 1 LN and fc1 (x -> hidden), 2 fc2 (hidden -> out), 3
// both. Requires C % 64 == 0, C <= 1024, F % 64 == 0 and 16-byte aligned
// tensors (checked by the Python wrapper).
extern "C" int uvl_ln_mlp_partial(const void* x, int x_is_f32, const float* gamma,
                                  const float* beta, const void* w1, const float* b1,
                                  const void* w2, const float* b2, void* normed, void* hidden,
                                  float* out, int M, int C, int F, float eps, int stages,
                                  void* stream) {
  using namespace uvl::sm90;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* y = static_cast<bf16*>(normed);
  bf16* h = static_cast<bf16*>(hidden);
  int err = 0;
  if (stages & 1) {
    err = x_is_f32 ? launch_ln_rows(static_cast<const float*>(x), gamma, beta, y, M, C, eps, s)
                   : launch_ln_rows(static_cast<const bf16*>(x), gamma, beta, y, M, C, eps, s);
    if (!err)
      err = launch_large_m<LN_BIAS_GELU, bf16>(y, static_cast<const bf16*>(w1), nullptr, b1, h,
                                               M, C, F, s);
  }
  if (!err && (stages & 2))
    err = launch_large_m<GEMM_F32OUT, float>(h, static_cast<const bf16*>(w2), nullptr, b2, out,
                                             M, F, C, s);
  return err ? err : static_cast<int>(cudaGetLastError());
}
