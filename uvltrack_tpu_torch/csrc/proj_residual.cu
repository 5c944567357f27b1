// Output projection + bias + residual add: the epilogue of
// uvltrack_tpu/ops/pallas_attention.py::_ln_qkv_attn_proj_kernel (:291,
// kernel #4, :318-325) and of _ln_qkv_attn_proj_kernel_q8 (:489, kernel #6,
// :511-517). The port composes those kernels as the attention prefix
// (csrc/ln_qkv.cu + csrc/qkv_attention.cu) followed by this kernel.
//
//   out[m, n] = x[m, n] + TX( sum_k A[m, k] * Wp[n, k] (* s[n]) + b[n] )
//
// fp32 accumulation, fp32 epilogue (the int8 scale multiplies the
// accumulator, then the bias is added), ONE rounding of the projection to
// x's type, then the residual add in x's type (a bf16 x rounds twice, as
// the Pallas kernels do; an fp32 x not at all). Instantiations (x, A, Wp):
//   - #4: (bf16, bf16, bf16) and (fp32, bf16, bf16): A is the attention
//     output cast to w_proj's dtype;
//   - #6: (bf16, bf16, int8) and (fp32, fp32, int8): everything in x's
//     type. The fp32 A runs as two bf16 tensor-core passes, A = hi + lo
//     (split_bf16 in common.cuh; the int8 payload is exact in bf16), which
//     is fp32-accurate; no TF32.
//   - #4 at TPU.COMPUTE_DTYPE=float32: (fp32, fp32, fp32), everything fp32
//     (pallas_attention._xla_proj with fp32 weights, plus the residual). Wp
//     arrives as its hi and lo bf16 planes (csrc/split_hilo.cu, split once
//     per weight and cached by the wrapper) and the product runs three
//     passes, hi.hi + lo.hi + hi.lo, as ln_qkv[fp32x-fp32w] does.
//
// Layouts: x, out (M, C) bf16 or fp32, rows = B*N tokens; A (M, K) bf16 or
// fp32; Wp (C, K) bf16, int8 or fp32 (as its planes (2, C, K) bf16) in
// PyTorch's Linear layout, s (C,) fp32 per row; b (C,) fp32.
//
// Bound on the H100 (UVLTrack-B, M=361, K=C=768), each input read once and
// each output written once: the fp32 #6 instantiation moves 1.11 MB of x,
// 1.11 MB of A, 0.59 MB of int8 Wp and 1.11 MB of out (~1.2 us at
// 3.35 TB/s) against 2 x 0.43 GFLOP of bf16 tensor-core passes (~0.9 us):
// the bytes bound it, and more so for the others (0.6-1.2 us). The fp32
// instantiation: 3.33 MB of x, A and out + 2.36 MB of Wp (~1.7 us) against 3
// x 0.43 GFLOP (~1.3 us). The TPU
// kernels run this product inside the one program per batch element with Wp
// resident in VMEM.
//
// Here it runs on the TMA + wgmma core of gemm_sm90.cuh (kind
// SPLITK_RESIDUAL): A and Wp k-tiles stream through a 4-stage TMA ring into
// 64 x 128 output tiles (two m64n64k16 warpgroups). At M=321/361 that is only
// 6 x 6 = 36 tiles, so K is split over clusters of 3 blocks (4 k-tiles each
// at K=768): 108 blocks, one wave on the 132 SMs. The three fp32 partials are
// summed through distributed shared memory in rank order, so the output is
// bitwise the same on every call (paired_ab steps two backends from one
// state); the epilogue adds the bias, rounds, and adds the residual. An int8
// Wp crosses device memory at one byte a value and is converted to bf16 in
// shared memory by the consumers; an fp32 A is TMA-loaded as it is and split
// into hi/lo bf16 tiles there, while the previous k-tile's products run; an
// fp32 Wp's two planes arrive by TMA as a bf16 Wp does (48 KB stages: four
// of them and the split A buffers take 224 KB, one block an SM). With 4 k-tiles a block the launch is bound by
// its latency (the first TMA round trip, the cluster barriers), not by the
// bytes.
//
// At the B.N rows of a lockstep or training step (M >= LARGE_M_ROWS of
// ops/ln_qkv_attn_proj.py, 896) the four bf16- and int8-weight instantiations run
// uvl_proj_residual_large_m below instead, on the core's large-M body (kind
// LM_RESIDUAL): at that M the split-K tiles above alone fill the card three
// times over (B=8, N=361: 46 x 6 x 3 = 828 blocks), and the 64-row body took
// 26.1-28.5 us at B=8 against 11.7-18.1 for F.linear + add (tools/gemm_ab.py
// --proj on one H100; PERF.md section 6 rows 4m, 6m have the large-M
// entry's). Its tiles are 128 x 128-192 on a persistent grid, each tile's K
// summed in the SPLIT parts above, added in their rank order, so the output
// is the split-K body's bit for bit; the epilogue adds the
// bias (and the int8 scale), rounds once to x's type, reads x at the
// accumulator fragments' positions and adds it in x's type, then stores by
// TMA. An int8 W is converted to bf16 once a call; #6's fp32 A at an fp32 x
// is written once a call as hi | lo bf16 rows (split_rows_kernel) and each
// k-tile runs hi.W then lo.W (two passes, the rows written and read once
// more, two ring stages at BN = 192): its time is more than twice the bf16
// W's, and still a third of its library call's (fp32 F.linear).
// A tensor-parallel rank's share of #4's projection, attn_r . Wp_r^T in fp32
// (no bias, no residual; the model group sums the shares, then adds both
// once), runs uvl_dense below (parts 0) on the core's large-M body (kind
// GEMM_F32OUT, gemm_sm90.cuh): at a training step's M = B.N = 5,776 rows
// and C = 768 its 128 x 192 tiles are 46 x 4 = 184, two rounds on 132 SMs,
// with K unsplit (K = C/tp = 128-512: 2-8 k-tiles a tile), on a persistent
// grid whose TMA stores of one tile's fp32 output run while the next tile's
// products do. Bound (B's K = 384): 4.4 MB of A, 0.6 MB of Wp and 17.7 MB of
// fp32 out, 6.8 us at 3.35 TB/s, against 3.4 GFLOP (3.4 us): the bytes,
// mostly the output. (Before, the share ran the fp32-x instantiation above
// on a zero fp32 stream, read back and split over clusters of 3: 50 us.)
//
// The default path's weight products, the projection, fc1 and fc2 of every
// ViT block outside the fused knobs (ops/ln_qkv_attn_proj.py::dense_f32),
// run uvl_dense below: the same function, A . W^T in fp32 from bf16
// operands, the exact products summed in fp32 in another order than
// cuBLAS's. The caller picks the schedule from the shape: at a lockstep
// step's B.N rows the large-M body above (GEMM_F32OUT, 128-row tiles, K
// unsplit); at the tracking step's 321/361 rows, where 128-row tiles would
// leave most of the 132 SMs idle (fc2 at C = 768: 3 x 6 tiles, 48 k-tiles
// each), the 64-row split-K body (64 x 128 tiles, K split over a cluster of
// `parts` blocks, the partials summed in rank order through distributed
// shared memory, as the projection above sums its SPLIT). Both give the same
// bits on every call.
#include "gemm_sm90.cuh"

using uvl::bf16;

namespace {

constexpr int BN = 128;
constexpr int STAGES = 4;
constexpr int SPLIT = 3;

template <int PARTS>
int launch_dense_split(const bf16* a, const bf16* w, float* out, int M, int K, int N,
                       cudaStream_t s) {
  using namespace uvl::sm90;
  return launch_splitk_gemm<GEMM_F32OUT, float, bf16, bf16, BN, STAGES, PARTS>(
      a, w, nullptr, nullptr, nullptr, out, M, K, N, s);
}

template <typename TX, typename TA, typename TW>
int launch(const void* x, const void* a, const void* w, const float* wscale, const float* bias,
           void* out, int M, int K, int C, cudaStream_t s) {
  using namespace uvl::sm90;
  return launch_splitk_gemm<SPLITK_RESIDUAL, TX, TA, TW, BN, STAGES, SPLIT>(
      static_cast<const TA*>(a), static_cast<const TW*>(w), wscale, static_cast<const TX*>(x),
      bias, static_cast<TX*>(out), M, K, C, s);
}

}  // namespace

// x_is_f32 / a_is_f32: 1 for fp32, 0 for bf16; w_kind: 0 for a bf16 weight,
// 1 for an int8 payload with its fp32 per-row scale w_scale, 2 for an fp32
// weight given as its hi/lo planes (2, C, K) bf16 (split_hilo). Only the
// five instantiations above exist; any other combination is refused.
// Requires K % 64 == 0, K >= 192, C % 8 == 0 and 16-byte aligned x, A and Wp
// (checked by the Python wrapper).
extern "C" int uvl_proj_residual(const void* x, int x_is_f32, const void* a, int a_is_f32,
                                 const void* w, int w_kind, const float* w_scale,
                                 const float* bias, void* out, int M, int K, int C,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = static_cast<int>(cudaErrorInvalidValue);
  const bool w_is_i8 = w_kind == 1;
  if (w_kind == 2) {
    if (x_is_f32 && a_is_f32)
      err = launch<float, float, uvl::sm90::HiLo>(x, a, w, w_scale, bias, out, M, K, C, s);
  } else if (!w_is_i8 && !a_is_f32 && x_is_f32)
    err = launch<float, bf16, bf16>(x, a, w, w_scale, bias, out, M, K, C, s);
  else if (!w_is_i8 && !a_is_f32)
    err = launch<bf16, bf16, bf16>(x, a, w, w_scale, bias, out, M, K, C, s);
  else if (w_is_i8 && x_is_f32 && a_is_f32)
    err = launch<float, float, int8_t>(x, a, w, w_scale, bias, out, M, K, C, s);
  else if (w_is_i8 && !x_is_f32 && !a_is_f32)
    err = launch<bf16, bf16, int8_t>(x, a, w, w_scale, bias, out, M, K, C, s);
  return err ? err : static_cast<int>(cudaGetLastError());
}

// The large-M entry: uvl_proj_residual's function at M >= LARGE_M_ROWS
// (ops/ln_qkv_attn_proj.py), bit for bit, on the core's large-M body (kind
// LM_RESIDUAL: 128-row tiles on a persistent grid, K summed in the SPLIT
// parts of the split-K body above, added in its order, the residual read in
// the epilogue and the out stored by TMA), for four of its
// instantiations (x, A, Wp): (bf16, bf16, bf16) and (fp32, bf16, bf16) (#4);
// (bf16, bf16, int8), the payload converted to bf16 once a call into w16
// (C, K) by i8_to_bf16_kernel, its scale in the epilogue (#6); (fp32, fp32,
// int8), converted the same way, the fp32 A written once a call as hi | lo
// bf16 rows into a_split (M, 2K) by split_rows_kernel, each k-tile run as
// hi.W then lo.W. The tile width is pick_bn's. Requires K % 64 == 0, C % 8
// == 0 and 16-byte aligned tensors (checked by the Python wrapper).
extern "C" int uvl_proj_residual_large_m(const void* x, int x_is_f32, const void* a,
                                         int a_is_f32, const void* w, int w_kind,
                                         const float* w_scale, const float* bias,
                                         void* a_split, void* w16, void* out, int M, int K,
                                         int C, void* stream) {
  using namespace uvl::sm90;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_kind != 0 && w_kind != 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool w_is_i8 = w_kind == 1;
  const bf16* wc = static_cast<const bf16*>(w);
  int err = 0;
  if (w_is_i8) {
    err = launch_i8_to_bf16(static_cast<const int8_t*>(w), static_cast<bf16*>(w16),
                            static_cast<size_t>(C) * K, s);
    wc = static_cast<const bf16*>(w16);
  }
  if (err) return err;
  const bf16* a16 = static_cast<const bf16*>(a);
  if (x_is_f32 && a_is_f32 && w_is_i8) {
    bf16* split = static_cast<bf16*>(a_split);
    err = launch_split_rows(static_cast<const float*>(a), split, M, K, s);
    if (!err)
      err = launch_large_m<LM_RESIDUAL, float, true, true, SPLIT>(
          split, wc, w_scale, bias, static_cast<float*>(out), M, K, C, s,
          static_cast<const float*>(x));
  } else if (x_is_f32 && !a_is_f32 && !w_is_i8) {
    err = launch_large_m<LM_RESIDUAL, float, false, false, SPLIT>(
        a16, wc, nullptr, bias, static_cast<float*>(out), M, K, C, s,
        static_cast<const float*>(x));
  } else if (!x_is_f32 && !a_is_f32) {
    err = w_is_i8 ? launch_large_m<LM_RESIDUAL, bf16, true, false, SPLIT>(
                        a16, wc, w_scale, bias, static_cast<bf16*>(out), M, K, C, s,
                        static_cast<const bf16*>(x))
                  : launch_large_m<LM_RESIDUAL, bf16, false, false, SPLIT>(
                        a16, wc, nullptr, bias, static_cast<bf16*>(out), M, K, C, s,
                        static_cast<const bf16*>(x));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return err ? err : static_cast<int>(cudaGetLastError());
}

// The default path's products and a tensor-parallel rank's share of the
// projection: out (M, N) fp32 = A (M, K) . W (N, K)^T, bf16 A and W, no
// bias. parts 0: the large-M body; 1-3: the 64-row body, K split over a
// cluster of `parts` blocks. Requires
// K % 64 == 0, K / 64 >= parts, N % 8 == 0 and 16-byte aligned A, W and out
// (checked by the Python wrapper).
extern "C" int uvl_dense(const void* a, const void* w, float* out, int M, int K, int N,
                         int parts, void* stream) {
  using namespace uvl::sm90;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* a16 = static_cast<const bf16*>(a);
  const bf16* w16 = static_cast<const bf16*>(w);
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (parts == 0)
    err = launch_large_m<GEMM_F32OUT, float>(a16, w16, nullptr, nullptr, out, M, K, N, s);
  else if (parts == 1)
    err = launch_dense_split<1>(a16, w16, out, M, K, N, s);
  else if (parts == 2)
    err = launch_dense_split<2>(a16, w16, out, M, K, N, s);
  else if (parts == 3)
    err = launch_dense_split<3>(a16, w16, out, M, K, N, s);
  return err ? err : static_cast<int>(cudaGetLastError());
}
