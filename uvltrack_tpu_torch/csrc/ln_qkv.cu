// LayerNorm + fused qkv projection: the prologue half of
// uvltrack_tpu/ops/pallas_attention.py::_ln_qkv_attn_kernel (:167, bf16
// weight) and of its int8-weight variant _ln_qkv_attn_kernel_q8 (:433-456).
//
//   out[m, n] = TO( sum_k TC(LN(x)[m, k]) * W[n, k] (* s[n]) + b[n] )
//   LN(x) = (x - mean) * rsqrt(max(mean(x^2) - mean^2, 0) + eps) * g + beta
//
// fp32 statistics with flax's fast variance clamped at 0, fp32 accumulation,
// fp32 epilogue (the int8 scale multiplies the accumulator, then the bias is
// added), one rounding to the output's type at the end: the rounding points
// of the Pallas kernels. The compute type TC is the output's type TO:
//   - bf16 weight (#1): TC = bf16 whatever x is; the normalized row is
//     rounded to bf16 before the product;
//   - int8 weight (#5): TC = x's type. bf16 x rounds like #1; fp32 x (the
//     joint blocks' stream) keeps the normalized row and qkv in fp32. That
//     product runs as two bf16 tensor-core passes, y = hi + lo (split_bf16 in
//     common.cuh): the int8 payload is exact in bf16, so the sum loses at
//     most 2^-17 |y| per term -- fp32-accurate, where one bf16 pass (a TPU's
//     default precision) or TF32 would round y.
//   - fp32 weight (#1 at TPU.COMPUTE_DTYPE=float32, every block's stream
//     fp32): TC = fp32. W is split into hi and lo bf16 too, and the product
//     runs three passes, hi.hi + lo.hi + hi.lo (the lo.lo term, at most
//     2^-18 |y||w|, dropped), as qkv_attention[fp32] does: fp32-accurate
//     without TF32.
//
// Layouts: x (M, C) bf16 or fp32, rows = B*N tokens; W (3C, C) bf16, int8 or
// fp32 in PyTorch's Linear layout (out, in), s (3C,) fp32 per-row scale of
// the int8 payload; b, g, beta fp32; out (M, 3C) bf16, or fp32 for an fp32 x
// with an int8 or fp32 W.
//
// Bound on the H100 (UVLTrack-B, C=768), each input read once and each
// output written once: M=361, fp32 x, bf16 W: 1.28 GFLOP of bf16 tensor-core
// work (~1.3 us at 989 TFLOP/s) against 3.5 MB of W + 1.1 MB of x + 1.7 MB
// of bf16 out (~1.9 us at 3.35 TB/s): the bytes bound it. M=321, bf16 x,
// int8 W: 1.14 GFLOP (~1.15 us) against 1.77 MB of int8 W + 0.49 MB of x +
// 1.48 MB of bf16 out (~1.1 us): about even. M=361, fp32 x, int8 W: 2 x
// 1.28 GFLOP for the two passes (~2.6 us) against 6.2 MB (~1.9 us). The TPU
// kernels keep the whole weight resident in VMEM and run grid=(B,): one
// program, which on Hopper would occupy one of 132 SMs.
//
// All four instantiations run on the TMA + wgmma core of gemm_sm90.cuh
// (kind LN_BIAS): the normalized 64-row block of a block sits in shared
// memory once (a bf16 x arrives there by TMA and is normalized in place), W
// streams through a 4-stage TMA ring, 64 x 128 output tiles (two m64n64k16
// warpgroups), 18 x 6 = 108 blocks at M=321/361, C=768 (F=2304): one wave on
// the 132 SMs, one block an SM. An fp32 W (fp32x-fp32w) streams through a
// 3-stage ring of 32 KB fp32 tiles, each split into its hi/lo bf16 tiles in
// place before its three passes; its bound at B=1, N=361, C=768: 7.08 MB of
// W + 1.11 MB of x + 3.33 MB of fp32 qkv = 11.5 MB (~3.4 us) against 3 x 1.28
// GFLOP of bf16 passes (~3.9 us), about even. An int8 W crosses device memory at one byte a
// value and is converted to bf16 in shared memory by the consumers, a k-tile
// ahead of the products; its scale multiplies the accumulator in the
// epilogue. With fp32 x the block holds hi and lo halves of the first half of
// the k-tiles, then of the second: the LN block takes the same 96-128 KB as a
// bf16 one, and W streams once. The bound is not what limits these launches:
// the LN prologue is, before the first product of each block, and with int8
// the conversion, which every one of the 6 row-blocks repeats for its W
// tiles (PERF.md, section 6, measures both).
#include "gemm_sm90.cuh"

using uvl::bf16;

// x_is_f32: 1 when x is fp32 (the joint blocks' stream), 0 when bf16.
// w_kind: 0 for a bf16 weight (out bf16), 1 for an int8 payload with its fp32
// per-row scale w_scale (out in x's type), 2 for an fp32 weight (fp32 x
// only; out fp32). Requires C % 64 == 0, C <= 1024 (the LN block in shared
// memory), F % 8 == 0 and 16-byte aligned x and W (checked by the Python
// wrapper).
extern "C" int uvl_ln_qkv(const void* x, int x_is_f32, const float* gamma,
                          const float* beta, const void* w, int w_kind,
                          const float* w_scale, const float* wb, void* out, int M,
                          int C, int F, float eps, void* stream) {
  using namespace uvl::sm90;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x32 = static_cast<const float*>(x);
  const bf16* x16 = static_cast<const bf16*>(x);
  const bf16* w16 = static_cast<const bf16*>(w);
  const int8_t* w8 = static_cast<const int8_t*>(w);
  const bool w_is_i8 = w_kind == 1;
  int err;
  if (w_kind == 2) {
    if (!x_is_f32) return static_cast<int>(cudaErrorInvalidValue);
    err = launch_ln_gemm<LN_BIAS, float, float, float, 128, 3>(
        x32, gamma, beta, static_cast<const float*>(w), nullptr, wb, static_cast<float*>(out),
        M, C, F, eps, s);
  } else if (!w_is_i8 && x_is_f32)
    err = launch_ln_gemm<LN_BIAS, float, bf16, bf16, 128, 4>(
        x32, gamma, beta, w16, nullptr, wb, static_cast<bf16*>(out), M, C, F, eps, s);
  else if (!w_is_i8)
    err = launch_ln_gemm<LN_BIAS, bf16, bf16, bf16, 128, 4>(
        x16, gamma, beta, w16, nullptr, wb, static_cast<bf16*>(out), M, C, F, eps, s);
  else if (x_is_f32)
    err = launch_ln_gemm<LN_BIAS, float, int8_t, float, 128, 4>(
        x32, gamma, beta, w8, w_scale, wb, static_cast<float*>(out), M, C, F, eps, s);
  else
    err = launch_ln_gemm<LN_BIAS, bf16, int8_t, bf16, 128, 4>(
        x16, gamma, beta, w8, w_scale, wb, static_cast<bf16*>(out), M, C, F, eps, s);
  return err ? err : static_cast<int>(cudaGetLastError());
}
