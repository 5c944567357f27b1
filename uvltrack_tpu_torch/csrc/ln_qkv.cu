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
//     fp32): TC = fp32. W arrives as its hi and lo bf16 planes, split once
//     per weight by csrc/split_hilo.cu and cached by the wrapper
//     (ops/hilo.py), and the product runs three passes, hi.hi + lo.hi +
//     hi.lo (the lo.lo term, at most 2^-18 |y||w|, dropped), as
//     qkv_attention[fp32] does: fp32-accurate without TF32.
//
// Layouts: x (M, C) bf16 or fp32, rows = B*N tokens; W (3C, C) bf16, int8 or
// fp32 (as its planes (2, 3C, C) bf16) in PyTorch's Linear layout (out, in),
// s (3C,) fp32 per-row scale of the int8 payload; b, g, beta fp32; out
// (M, 3C) bf16, or fp32 for an fp32 x with an int8 or fp32 W.
//
// Bound on the H100 (UVLTrack-B, C=768), each input read once and each
// output written once: M=361, fp32 x, bf16 W: 1.28 GFLOP of bf16 tensor-core
// work (~1.3 us at 989 TFLOP/s) against 3.5 MB of W + 1.1 MB of x + 1.7 MB
// of bf16 out (~1.9 us at 3.35 TB/s): the bytes bound it. M=321, bf16 x,
// int8 W: 1.14 GFLOP (~1.15 us) against 1.77 MB of int8 W + 0.49 MB of x +
// 1.48 MB of bf16 out (~1.1 us): about even. M=361, fp32 x, int8 W: 2 x
// 1.28 GFLOP for the two passes (~2.6 us) against 6.2 MB (~1.9 us). At B.N
// rows the operations bind: B=8, N=361, fp32 x, bf16 W: 10.22 GFLOP (10.3 us)
// against 25.7 MB (7.7 us); N=321, bf16 x: 9.2 us; L at B=8 (C=1024, F=3072):
// 18.2 GFLOP (18.4 us); B-TRAIN's 16 rows, N=361: 20.7 us. The TPU kernels
// keep the whole weight resident in VMEM and run grid=(B,): one program,
// which on Hopper would occupy one of 132 SMs.
//
// Which body a launch takes is the wrapper's choice, by M (LARGE_M_ROWS in
// ops/ln_qkv_attention.py, measured with tools/gemm_ab.py --qkv):
//   - M below it (the tracking step's B=1 rows, 321/361): uvl_ln_qkv, one
//     launch, the 64-row LN body of gemm_sm90.cuh (kind LN_BIAS; the
//     large-M entry's two or three launches measured 1.4x faster there in
//     device time, but the eager step pays each launch's host time, which
//     was not weighed yet): the normalized 64-row
//     block of a block sits in shared memory once (a bf16 x arrives there by
//     TMA and is normalized in place), W streams through a 4-stage TMA ring,
//     64 x 128 output tiles (two m64n64k16 warpgroups), 18 x 6 = 108 blocks
//     at M=321/361, C=768 (F=2304): one wave on the 132 SMs, one block an
//     SM, the LN prologue under the ring's first loads. An int8 W crosses
//     device memory at one byte a value and is converted to bf16 in shared
//     memory by the consumers, a k-tile ahead of the products; its scale
//     multiplies the accumulator in the epilogue. With fp32 x the block
//     holds hi and lo halves of the first half of the k-tiles, then of the
//     second: the LN block takes the same 96-128 KB as a bf16 one, and W
//     streams once.
//   - M at or above it (B.N rows: the lockstep step's S = 4 and 8, L's
//     lockstep step, a training step's 16 rows a step, a tensor-parallel
//     rank's share): uvl_ln_qkv_large_m, where that body lost 2.2-2.8x to
//     F.layer_norm + F.linear: every one of its F/128 column tiles
//     normalized its 64 rows again, with no product under the prologue, in
//     latency-bound waves (828 tiles at B=8, N=361, about 6.3 waves), and
//     with int8 every row block converted W's tiles again. The rows are
//     normalized once by ln_rows_kernel into a bf16 scratch (fp32 x with an
//     int8 W: its hi and lo halves, (M, 2C)), an int8 W is converted to bf16
//     once a call (i8_to_bf16_kernel: 1.77 MB read, 3.5 MB written at C=768,
//     where converting it a k-tile ahead would repeat that work in every row
//     block again), and the product runs on the persistent large-M body
//     (kind LN_BIAS): 128 x BN tiles, K unsplit and summed in order, the
//     bias (and the int8 scale) in the epilogue, a bf16 out rounded from the
//     fragments and stored by TMA while the next tile's products run (fp32
//     out: the staged fp32 store). The rounding points are those of the
//     64-row body: fp32 statistics, the normalized row rounded to bf16 (or
//     split hi/lo), fp32 accumulation 16 deep at a time in the same order
//     (hi then lo), one rounding at the end.
// An fp32 W (fp32x-fp32w) runs the core's persistent ln_hilo_kernel at every
// M: min(tiles, 132) blocks walk the 64 x 128 output tiles (108 at B=1, 828
// at B=8, N=361), each k-tile of x (fp32, by TMA) normalized and split while
// the previous k-tile's three passes run, the W planes' tiles by TMA through
// a 4-stage ring of 48 KB stages (x, hi, lo). Its bound at B=1, N=361,
// C=768: 7.08 MB of W (as read by its planes, the weight's own bytes) + 1.11
// MB of x + 3.33 MB of fp32 qkv = 11.5 MB (~3.4 us) against 3 x 1.28 GFLOP
// of bf16 passes (~3.9 us), about even; the split itself, 7.08 MB read and
// written once per weight, is split_hilo's launch, not this one's. At B=1
// the bound is not what limits the 64-row launches: the LN prologue is,
// before the first product of each block, and with int8 the conversion
// (PERF.md, section 6, measures both).
#include "gemm_sm90.cuh"

using uvl::bf16;

// x_is_f32: 1 when x is fp32 (the joint blocks' stream), 0 when bf16.
// w_kind: 0 for a bf16 weight (out bf16), 1 for an int8 payload with its fp32
// per-row scale w_scale (out in x's type), 2 for an fp32 weight given as its
// hi/lo planes (2, F, C) bf16 (split_hilo; fp32 x only; out fp32).
// Requires C % 64 == 0, C <= 1024 (the LN block in shared
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
    err = launch_ln_hilo<LN_BIAS, 128, 4>(x32, gamma, beta, static_cast<const HiLo*>(w), wb,
                                          static_cast<float*>(out), M, C, F, eps, s);
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

// The large-M entry: the same function as uvl_ln_qkv for a bf16 (w_kind 0)
// or int8 (w_kind 1) W, in three launches or two: ln_rows_kernel x ->
// normed (M, C) bf16, or (M, 2C) hi | lo for an fp32 x with an int8 W; for
// an int8 W, i8_to_bf16_kernel w -> w16 (F, C) bf16 scratch; then the
// large-M body's LN_BIAS product into out (M, F), bf16, or fp32 for an fp32
// x with an int8 W. Requires C % 64 == 0, C <= 1024, F % 8 == 0 and 16-byte
// aligned tensors (checked by the Python wrapper).
extern "C" int uvl_ln_qkv_large_m(const void* x, int x_is_f32, const float* gamma,
                                  const float* beta, const void* w, int w_kind,
                                  const float* w_scale, const float* wb, void* normed, void* w16,
                                  void* out, int M, int C, int F, float eps, void* stream) {
  using namespace uvl::sm90;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x32 = static_cast<const float*>(x);
  const bf16* x16 = static_cast<const bf16*>(x);
  bf16* y = static_cast<bf16*>(normed);
  int err;
  if (w_kind == 0) {
    err = x_is_f32 ? launch_ln_rows(x32, gamma, beta, y, M, C, eps, s)
                   : launch_ln_rows(x16, gamma, beta, y, M, C, eps, s);
    if (!err)
      err = launch_large_m<LN_BIAS, bf16>(y, static_cast<const bf16*>(w), nullptr, wb,
                                          static_cast<bf16*>(out), M, C, F, s);
  } else if (w_kind == 1) {
    bf16* wc = static_cast<bf16*>(w16);
    err = launch_i8_to_bf16(static_cast<const int8_t*>(w), wc, static_cast<size_t>(F) * C, s);
    if (!err && x_is_f32) {
      err = launch_ln_rows<float, true>(x32, gamma, beta, y, M, C, eps, s);
      if (!err)
        err = launch_large_m<LN_BIAS, float, true, true>(y, wc, w_scale, wb,
                                                         static_cast<float*>(out), M, C, F, s);
    } else if (!err) {
      err = launch_ln_rows(x16, gamma, beta, y, M, C, eps, s);
      if (!err)
        err = launch_large_m<LN_BIAS, bf16, true>(y, wc, w_scale, wb, static_cast<bf16*>(out), M,
                                                  C, F, s);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return err ? err : static_cast<int>(cudaGetLastError());
}
