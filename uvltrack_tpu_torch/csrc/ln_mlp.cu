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
// The kernel itself takes the same three launches at the B.N rows of a
// lockstep or training step (M >= LARGE_M_ROWS of ops/ln_qkv_attention.py;
// uvl_ln_mlp_large_m below, out kind 0), and gives the 64-row launches'
// bits: its fc1 takes the GELU with erfcf (gelu_erf), and fc2 + b2 (the
// large-M body's LN_BIAS kind with a bf16 out, on the hidden tensor) sums K
// = F in the FC2_SPLIT parts of fc2_bias's clusters, each from zero, added
// in rank order. So a row's MLP output is the same whichever rows it is
// batched with. There the 64-row launches lost to their library calls: at
// B=8, N=361, fp32 x, 105.5 us for fc1 and 67.3 for fc2 against 53.6 and
// 20.5 (tools/gemm_ab.py --mlp on one H100; PERF.md section 6 row 7m has
// the large-M pair's times). fc2's tile width is pick_bn's up to 192 (its
// two accumulator sets, the running sum and the part, leave no registers for
// 256). Not built, for a later PR: fc2 split over K in clusters on the
// persistent grid, or a fixed-order stream-K; at B=8, N=361 fc2's 92 tiles
// of 192 leave 40 of 132 SMs idle in its one round.
// The old kernels (PR 4) ran one 32-deep shared-memory stage with WMMA and
// paid one device-memory latency a k-step (24 steps for fc1, 96 for fc2 on
// 144 blocks of 4 warps); the TMA ring keeps the loads in flight instead.
#include "gemm_sm90.cuh"

using uvl::bf16;

namespace {
// fc2's K split four ways: over the 64-row body's clusters, and in the
// large-M body's parts (the same sums in the same order, the same bits)
constexpr int FC2_SPLIT = 4;
}  // namespace

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
    err = launch_splitk_gemm<SPLITK_BIAS, bf16, bf16, bf16, 192, 4, FC2_SPLIT>(
        h, static_cast<const bf16*>(w2), nullptr, nullptr, b2, static_cast<bf16*>(out), M, F, C,
        s);
  return err ? err : static_cast<int>(cudaGetLastError());
}

// The large-M entry (kernel #7 at M >= LARGE_M_ROWS, and a tensor-parallel
// rank's share at any M): ln_rows_kernel x -> normed (M, C) bf16, fc1 + GELU
// (LN_BIAS_GELU) into the hidden (M, F) bf16, then fc2 on the core's large-M
// body. out_kind 0: the kernel's function, bit for bit uvl_ln_mlp's, out
// (M, C) bf16 = bf16(h . W2^T + b2) (the GELU with erfcf; fc2 of kind
// LN_BIAS, a bf16 out, K summed in FC2_SPLIT parts added in order); 1: a
// share, out (M, C) fp32 = h . W2^T (+ b2; null for the share itself; kind
// GEMM_F32OUT, K unsplit; the rational erf in the GELU). x (M, C) bf16 or
// fp32 (x_is_f32), W1 (F, C) and W2 (C, F) bf16, b1 (F,) and b2 (C,) fp32.
// stages: 1 LN and fc1 (x -> hidden), 2 fc2 (hidden -> out), 3 both. fc2's
// tile width is pick_bn's. Requires C % 64 == 0, C <= 1024, F % 64 == 0 and
// 16-byte aligned tensors (checked by the Python wrapper).
extern "C" int uvl_ln_mlp_large_m(const void* x, int x_is_f32, const float* gamma,
                                  const float* beta, const void* w1, const float* b1,
                                  const void* w2, const float* b2, void* normed, void* hidden,
                                  void* out, int out_kind, int M, int C, int F, float eps,
                                  int stages, void* stream) {
  using namespace uvl::sm90;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* y = static_cast<bf16*>(normed);
  bf16* h = static_cast<bf16*>(hidden);
  const bf16* w2b = static_cast<const bf16*>(w2);
  if (out_kind != 0 && out_kind != 1) return static_cast<int>(cudaErrorInvalidValue);
  int err = 0;
  if (stages & 1) {
    err = x_is_f32 ? launch_ln_rows(static_cast<const float*>(x), gamma, beta, y, M, C, eps, s)
                   : launch_ln_rows(static_cast<const bf16*>(x), gamma, beta, y, M, C, eps, s);
    const bf16* w1b = static_cast<const bf16*>(w1);
    if (!err)
      err = out_kind == 0
                ? launch_large_m<LN_BIAS_GELU, bf16, false, false, 1, true>(y, w1b, nullptr, b1,
                                                                            h, M, C, F, s)
                : launch_large_m<LN_BIAS_GELU, bf16>(y, w1b, nullptr, b1, h, M, C, F, s);
  }
  if (!err && (stages & 2))
    err = out_kind == 0
              ? launch_large_m<LN_BIAS, bf16, false, false, FC2_SPLIT>(
                    h, w2b, nullptr, b2, static_cast<bf16*>(out), M, F, C, s)
              : launch_large_m<GEMM_F32OUT, float>(h, w2b, nullptr, b2, static_cast<float*>(out),
                                                   M, F, C, s);
  return err ? err : static_cast<int>(cudaGetLastError());
}
