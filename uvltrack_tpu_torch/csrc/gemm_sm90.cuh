// The TMA + wgmma GEMM core of the port's products on Hopper (sm_90a):
//   - ln_qkv (csrc/ln_qkv.cu), the LayerNorm-fused qkv projection of kernel
//     #1 (uvltrack_tpu/ops/pallas_attention.py::_ln_qkv_attn_kernel :167,
//     bf16 W) and #5 (_ln_qkv_attn_kernel_q8 :433, int8 W);
//   - proj_residual (csrc/proj_residual.cu), the output projection + residual
//     epilogue of #4 (_ln_qkv_attn_proj_kernel :291) and #6
//     (_ln_qkv_attn_proj_kernel_q8 :489);
//   - both launches of ln_mlp (csrc/ln_mlp.cu), kernel #7 (_ln_mlp_kernel :551),
//     and the products of its tensor-parallel share.
//
//   out[m, n] = TO( EPI( sum_k A[m, k] * W[n, k] (* s[n]) + b[n] ) )   fp32 acc
//
// W is a Linear-layout (N_out, K) weight, K-major: bf16, an int8 payload
// with its fp32 per-row scale s, which multiplies the fp32 accumulator in the
// epilogue (rounded before the bias add: the Pallas kernels' order), or an
// fp32 weight given as its hi and lo bf16 planes (HiLo below; the weights of
// an fp32-compute model: an fp32 A or x and an fp32 output).
// Kinds:
//   - LN_BIAS (ln_qkv) and LN_BIAS_GELU (ln_fc1_gelu): A = LN(x), K = C; EPI
//     is the identity or the erf GELU; TO is bf16, or fp32 for the int8 or
//     fp32 W of an fp32 x;
//   - SPLITK_BIAS (fc2_bias): A is the hidden tensor (M, F), K = F: bf16,
//     or fp32 with an fp32 W (and then an fp32 out);
//   - SPLITK_RESIDUAL (proj_residual): A is the attention output (M, K), bf16
//     or fp32, and out = x + TX(proj) in x's type TX;
//   - GEMM_F32OUT: out = A . W^T (+ b) in fp32, bf16 A (on the SPLITK body:
//     no bias, the default path's products of few rows); with LN_BIAS and
//     LN_BIAS_GELU on rows normalized beforehand, and LM_RESIDUAL, the kinds
//     of the large-M body (its own section below): ln_qkv, both launches of
//     ln_mlp and proj_residual at B.N rows (a lockstep step's, a training
//     step's), and a tensor-parallel rank's shares of #4's projection and
//     of #7;
//   - LM_RESIDUAL (proj_residual at B.N rows, on the large-M body): out =
//     x + TX(A . W^T (* s) + b) in x's type TX, as SPLITK_RESIDUAL.
//
// Bound on the H100: at the tracking step's shapes (M = 321/361 tokens, C =
// 768) every one of these products moves 0.6-10 MB and needs 0.4-3.4 GFLOP of
// bf16 tensor-core passes, 0.6-3.4 us either way: they are latency problems
// (a few k-tiles a block, one wave of blocks), not throughput problems.
//
// One block computes a 64 x BN output tile with NC = 2 consumer warpgroups
// (each a 64 x BN/2 half with wgmma.mma_async m64n{BN/2}k16, bf16 in, fp32
// accumulators in registers) and one producer warp. The producer streams
// 64-deep k-tiles of W (and of A for the SPLITK kinds) by TMA
// (cp.async.bulk.tensor) into a ring of STAGES shared-memory stages guarded by
// full/empty mbarriers, so up to STAGES loads are in flight while the tensor
// cores run. The kernels before this core (one stage, WMMA mma.sync, two
// __syncthreads a 32-deep step) paid one device-memory latency a k-step,
// which held them at 25-98 us against 1-3 us of bound.
//
// Operands the tensor cores cannot take as they arrive are converted by the
// consumers, a k-tile ahead of the products (the conversion of tile kt runs
// while wgmma works on tile kt-1, from a second buffer):
//   - an int8 W tile (TMA without swizzle, 64 bytes a row, so the weight
//     crosses device memory at one byte a value) becomes a bf16 tile (exact:
//     |q| <= 127) in the 128-byte-swizzled layout, each warpgroup its half;
//   - an fp32 operand runs as two bf16 passes, y = hi + lo (split_bf16 in
//     common.cuh; |y - hi - lo| <= 2^-17 |y|, against a B operand that bf16
//     holds exactly): fp32-accurate, no TF32. An fp32 A tile of the SPLITK
//     kinds (TMA, 256 bytes a row) is split by both warpgroups, 32 rows each.
//
// An fp32 W (HiLo): csrc/split_hilo.cu writes its hi and lo bf16 planes once
// per weight (the wrapper caches them, ops/hilo.py), and the producer streams
// both planes' k-tiles by TMA in the 128-byte swizzle wgmma reads, as it
// streams a bf16 W: no consumer splits a W value, and no product waits on a
// split. With the fp32 A side split as above the product runs three passes,
// hi.hi + lo.hi + hi.lo, as the attention body's fp32 products do
// (attention.cuh): the dropped lo.lo term is at most 2^-18 |a||w| a product.
// The LN kinds with an fp32 W run their own persistent body (ln_hilo_kernel
// below): x itself streams through the ring, and each k-tile is normalized
// and split while the previous one's products run.
//
// A operand:
//   - LN kinds: the consumers compute each row's statistics once (fp32,
//     flax's fast variance mean(x^2) - mean^2 clamped at 0) and write the
//     normalized rows, rounded once to bf16, into shared memory in the
//     swizzled K-major layout wgmma reads: C/64 tiles of 64 x 64 (96 KB at
//     C=768, 128 KB at C=1024), while the producer already fills the ring. A
//     bf16 x arrives there first by TMA, the block's 64 rows all in flight at
//     once, and is normalized in place; an fp32 x (twice the bytes, which do
//     not fit beside the ring) is read with 16-byte vector loads, two rows a
//     warp at a time. With an fp32 output (the int8 qkv of an fp32 x)
//     the block holds hi and lo halves of the first C/128 k-tiles, and after
//     those the consumers overwrite it with the second half's, normalized
//     again from x with the row statistics kept in shared memory: the same
//     96-128 KB, and W still streams once.
//   - SPLITK kinds: TMA tiles of A beside the W tiles. With only (M/64)(N_out
//     / BN) output tiles, K is split over a thread-block cluster of SPLIT
//     blocks; each leaves its fp32 partial tile in its shared memory, and
//     block r of the cluster sums its share of the 64 rows over the SPLIT
//     partials through distributed shared memory in rank order 0, 1, ...:
//     the same output on every run (no atomics).
//
// Rows past M: TMA zero-fills the A rows past M, the LN prologue writes zero
// rows, and the epilogue stores nothing there; columns past N_out (a tail
// tile) are zero-filled the same way and not stored.
//
// Host side: each operand's TMA descriptor (cuTensorMapEncodeTiled, linked
// from libcuda with -lcuda) is encoded once per (pointer, type, shape, box)
// and cached (cached_map, which csrc/attention.cuh shares), so the weights'
// descriptors cost no host time after the first call; it goes to the kernel
// as a __grid_constant__ parameter. Dynamic shared memory above 48 KB is opted into with
// cudaFuncSetAttribute, once per instantiation and size. A launcher returns a
// refusal (an unsupported shape, a descriptor or attribute error) before it
// launches, else 0; the C entry points then return cudaGetLastError().
#pragma once

#include <cuda.h>

#include <array>
#include <cstring>
#include <map>
#include <mutex>
#include <type_traits>

#include "common.cuh"


namespace uvl {
namespace sm90 {

enum Kind {
  LN_BIAS = 0,
  LN_BIAS_GELU = 1,
  SPLITK_BIAS = 2,
  SPLITK_RESIDUAL = 3,
  GEMM_F32OUT = 4,
  LM_RESIDUAL = 5
};

constexpr int BM = 64;              // output rows per block (one wgmma M)
constexpr int BK = 64;              // k-tile depth: 64 bf16 = one 128-byte swizzle row
constexpr int NC = 2;               // consumer warpgroups
constexpr int CONSUMERS = NC * 128;
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int A_TILE_BYTES = BM * BK * 2;  // 8 KB: a 64 x 64 bf16 tile
constexpr int MAX_C = 1024;         // LN kinds: 64 rows of C bf16 in shared memory

// The weight type of an fp32 W: each value as its hi and lo bf16 halves
// (split_bf16), which the weight holds as two planes, hi (N_out, K) then lo
// (N_out, K), written by csrc/split_hilo.cu. A k-tile of it in a ring stage
// is the hi tile (BN rows of 128 bytes, swizzled) and the lo tile after it:
// 4 bytes a value, as the fp32 value itself.
struct HiLo {
  bf16 hi, lo;
};

// exact GELU as jax.nn.gelu(approximate=False): 0.5 x erfc(-x / sqrt(2))
__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * erfcf(-v * 0.70710678118654752f);
}

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// spin until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 2-D TMA load of one box at (c0 = column, c1 = row) into shared memory,
// completing `bar`'s transaction count
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// 2-D TMA store of one box of shared memory at src to (c0 = column, c1 =
// row), in this thread's bulk group; elements past the tensor's edges are
// not written
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, int c0, int c1,
                                             uint32_t src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's committed stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// ... and written device memory
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// a float4 of block `rank`'s shared memory at this block's offset `addr`
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// pins the accumulators in place around the asynchronous product, so the
// compiler moves no read or write of them across a fence or a wait
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor of a K-major, 128-byte-swizzled operand
// whose 8-row groups are 1024 bytes apart (the TMA SWIZZLE_128B layout of
// 64-wide bf16 rows): start address >> 4, LBO 1 (unused when swizzled),
// SBO 1024 >> 4, layout type 1 (128B). A k16 step advances the start
// address by 32 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// D (64 x 64, fp32, 32 registers a thread) += A (64 x 16) . B (64 x 16)^T, both
// bf16, K-major, 128-byte swizzled in shared memory
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D (64 x 96, fp32, 48 registers a thread) += A (64 x 16) . B (96 x 16)^T, both
// bf16, K-major, 128-byte swizzled in shared memory
__device__ __forceinline__ void wgmma_n96(float (&d)[48], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D (64 x 128, fp32, 64 registers a thread) += A (64 x 16) . B (128 x 16)^T, both
// bf16, K-major, 128-byte swizzled in shared memory
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D (64 x 192, fp32, 96 registers a thread) += A (64 x 16) . B (192 x 16)^T, both
// bf16, K-major, 128-byte swizzled in shared memory
__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D (64 x 256, fp32, 128 registers a thread) += A (64 x 16) . B (256 x 16)^T, both
// bf16, K-major, 128-byte swizzled in shared memory
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a, uint64_t b) {
  if constexpr (N == 64)
    wgmma_n64(d, a, b);
  else if constexpr (N == 96)
    wgmma_n96(d, a, b);
  else if constexpr (N == 128)
    wgmma_n128(d, a, b);
  else if constexpr (N == 192)
    wgmma_n192(d, a, b);
  else
    wgmma_n256(d, a, b);
}

// wait until at most N of this warpgroup's committed product groups are in
// flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------- type helpers
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// two and four consecutive values of a row, in and out, rounded once to the
// output's type
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
// two consecutive values of a row as fp32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}
// v rounded to T and back (a no-op for fp32)
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const bf16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// ------------------------------------------------------- conversions
// Four int8 values (one 32-bit word, k..k+3) -> four bf16, exact, as two
// bf16x2 words. Each biased byte b + 128 goes into the low mantissa byte of
// 2^23; subtracting 2^23 + 128 leaves b as an fp32 integer, whose upper 16
// bits are its bf16 (|b| <= 128 needs 8 significant bits).
__device__ __forceinline__ uint2 i8x4_to_bf16x4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(
        __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)), 8388736.f));
  return make_uint2(__byte_perm(f[0], f[1], 0x7632), __byte_perm(f[2], f[3], 0x7632));
}

// Rows 0..ROWS-1 of an int8 W k-tile (TMA without swizzle: 64 bytes a row)
// -> bf16 in the 128-byte-swizzled K-major layout (128 bytes a row); the 128
// threads of a warpgroup (t), two 16-byte int8 chunks each at ROWS = 64.
// Reads fall on consecutive 16-byte words; each 8-thread phase of the
// writes covers the 16 distinct chunks of two rows (even rows take the even
// chunks' XOR set, odd rows the odd): no bank conflicts.
template <int ROWS>
__device__ __forceinline__ void convert_w_tile(const uint8_t* src, uint8_t* dst, int t) {
  static_assert(ROWS * 4 % 128 == 0, "whole chunks a thread");
#pragma unroll
  for (int j = 0; j < ROWS * 4 / 128; ++j) {
    const int i = t + 128 * j;
    const int r = i >> 2;
    const int q = i & 3;
    const uint4 v = *reinterpret_cast<const uint4*>(src + r * 64 + q * 16);
    const uint2 a = i8x4_to_bf16x4(v.x), b = i8x4_to_bf16x4(v.y);
    const uint2 c = i8x4_to_bf16x4(v.z), d = i8x4_to_bf16x4(v.w);
    uint8_t* row = dst + r * 128;
    *reinterpret_cast<uint4*>(row + (((2 * q) ^ (r & 7)) << 4)) = make_uint4(a.x, a.y, b.x, b.y);
    *reinterpret_cast<uint4*>(row + (((2 * q + 1) ^ (r & 7)) << 4)) =
        make_uint4(c.x, c.y, d.x, d.y);
  }
}

// Eight fp32 values -> their hi and lo bf16 halves (split_bf16), one
// 16-byte chunk each, stored at hi + off and lo + off.
__device__ __forceinline__ void store_split8(const float (&v)[8], uint8_t* hi, uint8_t* lo,
                                             int off) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    bf16 h0, l0, h1, l1;
    split_bf16(v[2 * e], h0, l0);
    split_bf16(v[2 * e + 1], h1, l1);
    const __nv_bfloat162 hp(h0, h1), lp(l0, l1);
    h[e] = *reinterpret_cast<const uint32_t*>(&hp);
    l[e] = *reinterpret_cast<const uint32_t*>(&lp);
  }
  *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
}

// Rows r0..r0+31 of an fp32 A k-tile (TMA without swizzle: 256 bytes a row)
// -> its hi and lo bf16 tiles in the swizzled layout; the 128 threads of a
// warpgroup (t), two 8-value chunks each.
__device__ __forceinline__ void split_a_tile(const float* src, uint8_t* hi, uint8_t* lo, int r0,
                                             int t) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = t + 128 * j;
    const int r = r0 + (i >> 3);
    const int c = i & 7;
    float v[8];
    load8(src + r * BK + c * 8, v);
    store_split8(v, hi, lo, r * 128 + ((c ^ (r & 7)) << 4));
  }
}

// ------------------------------------------------------ the LN prologue
// Rows m0..m0+63 of x (M, C) -> LN(x) in shared memory as swizzled 64 x 64
// bf16 k-tiles (a_smem, 1024-byte aligned): the byte of element (r, k) is
// (k/64 - k0/64)*8192 + r*128 + (((k%64)/8) ^ (r%8))*16 + (k%8)*2, the layout
// TMA's SWIZZLE_128B gives a 64 x 64 box. Each lane owns the 16-byte output
// chunks ch = lane + 32j of every row (8 values each), so its gamma and beta
// stay in registers; a warp normalizes two rows at a time, each row read
// once with 16-byte loads. Rows past M are zero.
//   LN(x) = (x - mean) * rsqrt(max(mean(x^2) - mean^2, 0) + eps) * g + beta
// (the means as sums times 1/C and rsqrt as rsqrtf, within 2 ulp, in place
// of IEEE divisions and a square root on every row, which cost ~1 us a launch
// at one block an SM).
// HILO: only the chunks [ch0, ch1) (k = 8 ch0 .. 8 ch1 - 1) are written, as a
// bf16 hi tile and, lo_off bytes further, its lo tile (split_bf16). STATS:
// the row statistics come from the whole row (and, with HILO, go to
// stats[r]); else from stats[r], and only the written chunks are loaded.
// SMEM_X: a bf16 x block arrives in a_smem in that same layout (TMA puts it
// there; rows past M zero; x_bar completes when it is in), and each row is
// normalized in place.
constexpr int MAX_CH = MAX_C / 256;  // chunks a lane owns in a row

template <typename TX, bool HILO, bool STATS, bool SMEM_X>
__device__ __forceinline__ void ln_rows_to_smem(const TX* __restrict__ x,
                                                const float* __restrict__ gamma,
                                                const float* __restrict__ beta, int m0, int M,
                                                int C, float eps, uint8_t* a_smem, int ctid,
                                                int ch0, int ch1, int lo_off, float2* stats,
                                                uint32_t x_bar) {
  constexpr int RPI = 2;  // rows a warp normalizes at a time
  const int warp = ctid >> 5;
  const int lane = ctid & 31;
  const int nch = C / 8;
  const float inv_c = 1.f / C;
  auto written = [&](int ch) { return ch < nch && (!HILO || (ch >= ch0 && ch < ch1)); };
  auto offset = [&](int ch, int r) {
    return ((ch >> 3) - (ch0 >> 3)) * A_TILE_BYTES + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
  };
  static_assert(!SMEM_X || (std::is_same<TX, bf16>::value && !HILO), "a bf16 x block in place");
  float g[MAX_CH][8], be[MAX_CH][8];
#pragma unroll
  for (int j = 0; j < MAX_CH; ++j) {
    const int ch = lane + 32 * j;
    if (written(ch)) {
      load8(gamma + ch * 8, g[j]);
      load8(beta + ch * 8, be[j]);
    }
  }
  if constexpr (SMEM_X) mbar_wait(x_bar, 0);  // gamma and beta already in flight
  for (int r0 = warp * RPI; r0 < BM; r0 += (CONSUMERS / 32) * RPI) {
    float v[RPI][MAX_CH][8];
    float s[RPI], ss[RPI];
#pragma unroll
    for (int i = 0; i < RPI; ++i) {
      const int row = m0 + r0 + i;
      s[i] = ss[i] = 0.f;
#pragma unroll
      for (int j = 0; j < MAX_CH; ++j) {
        const int ch = lane + 32 * j;
        if ((STATS ? ch < nch : written(ch)) && row < M) {
          if constexpr (SMEM_X)
            load8(reinterpret_cast<const bf16*>(a_smem + offset(ch, r0 + i)), v[i][j]);
          else
            load8(x + static_cast<size_t>(row) * C + ch * 8, v[i][j]);
          if constexpr (STATS) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              s[i] += v[i][j][e];
              ss[i] += v[i][j][e] * v[i][j][e];
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPI; ++i) {
      const int r = r0 + i;
      const bool live = m0 + r < M;
      float mean, rstd;
      if constexpr (STATS) {
        const float sum = warp_sum(s[i]);
        const float sumsq = warp_sum(ss[i]);
        mean = sum * inv_c;
        const float var = fmaxf(sumsq * inv_c - mean * mean, 0.f);
        rstd = rsqrtf(var + eps);
        if (HILO && lane == 0) stats[r] = make_float2(mean, rstd);
      } else {
        const float2 st = stats[r];
        mean = st.x;
        rstd = st.y;
      }
#pragma unroll
      for (int j = 0; j < MAX_CH; ++j) {
        const int ch = lane + 32 * j;
        if (written(ch)) {
          float y[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            y[e] = 0.f;
            if (live) {
              y[e] = (v[i][j][e] - mean) * rstd;
              y[e] = y[e] * g[j][e] + be[j][e];
            }
          }
          const int off = offset(ch, r);
          if constexpr (HILO) {
            store_split8(y, a_smem, a_smem + lo_off, off);
          } else {
            *reinterpret_cast<uint4*>(a_smem + off) =
                make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]),
                           pack_bf16(y[6], y[7]));
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------ epilogue
// A consumer thread's accumulators of a 64 x BN tile at (m0, n0) -> out:
// (* s) + b (EPI), one rounding to TO, rows past M and columns past N_out
// not stored. Register i of thread t of warpgroup wg holds row (t/32)*16 +
// (t%32)/4 + 8*((i/2)%2), column wg*WN + (i/4)*8 + (t%4)*2 + i%2.
template <int KIND, bool W8, int WN, typename TO>
__device__ __forceinline__ void store_tile(const float (&acc)[WN / 2],
                                           const float* __restrict__ wscale,
                                           const float* __restrict__ bias, TO* __restrict__ out,
                                           int m0, int n0, int M, int N_out, int wg, int t) {
  const int frow = (t / 32) * 16 + (t % 32) / 4;
  const int fcol = wg * WN + (t % 4) * 2;
#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    const int col = n0 + fcol + j * 8;
    if (col >= N_out) continue;
    float2 b = make_float2(0.f, 0.f), sc = make_float2(1.f, 1.f);
    if constexpr (KIND != GEMM_F32OUT) b = *reinterpret_cast<const float2*>(bias + col);
    if constexpr (W8) sc = *reinterpret_cast<const float2*>(wscale + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + frow + 8 * h;
      if (row >= M) continue;
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if constexpr (W8) {
        v0 = __fmul_rn(v0, sc.x);
        v1 = __fmul_rn(v1, sc.y);
      }
      if constexpr (KIND != GEMM_F32OUT) {
        v0 = __fadd_rn(v0, b.x);
        v1 = __fadd_rn(v1, b.y);
      }
      if constexpr (KIND == LN_BIAS_GELU) {
        v0 = gelu_erf(v0);
        v1 = gelu_erf(v1);
      }
      store2(out + static_cast<size_t>(row) * N_out + col, v0, v1);
    }
  }
}

// ---------------------------------------- the LN kinds with a HiLo W
// Rows m0..m0+63 of an fp32 x (M, C) -> their (mean, rstd) in stats[0..63],
// exactly as ln_rows_to_smem's STATS pass computes them (the same loads, the
// same order of the sums). Rows past M get zeros, which nothing reads.
__device__ __forceinline__ void row_stats(const float* __restrict__ x, int m0, int M, int C,
                                          float eps, float2* stats, int ctid) {
  constexpr int RPI = 2;  // rows a warp reduces at a time
  const int warp = ctid >> 5;
  const int lane = ctid & 31;
  const int nch = C / 8;
  const float inv_c = 1.f / C;
  for (int r0 = warp * RPI; r0 < BM; r0 += (CONSUMERS / 32) * RPI) {
    float v[RPI][MAX_CH][8];
    float s[RPI], ss[RPI];
#pragma unroll
    for (int i = 0; i < RPI; ++i) {
      const int row = m0 + r0 + i;
      s[i] = ss[i] = 0.f;
#pragma unroll
      for (int j = 0; j < MAX_CH; ++j) {
        const int ch = lane + 32 * j;
        if (ch < nch && row < M) {
          load8(x + static_cast<size_t>(row) * C + ch * 8, v[i][j]);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            s[i] += v[i][j][e];
            ss[i] += v[i][j][e] * v[i][j][e];
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPI; ++i) {
      const float sum = warp_sum(s[i]);
      const float sumsq = warp_sum(ss[i]);
      const float mean = sum * inv_c;
      const float var = fmaxf(sumsq * inv_c - mean * mean, 0.f);
      if (lane == 0)
        stats[r0 + i] = m0 + r0 + i < M ? make_float2(mean, rsqrtf(var + eps)) : make_float2(0.f, 0.f);
    }
  }
}

// Rows r0..r0+31 of an fp32 x k-tile (TMA without swizzle: 256 bytes a row)
// -> LN(x) of those values, split into the hi and lo bf16 tiles in the
// swizzled layout (ln_rows_to_smem's arithmetic and rounding); gamma and
// beta point at the k-tile's 64 columns. The 128 threads of a warpgroup (t),
// two 8-value chunks each; rows past M are zero.
__device__ __forceinline__ void ln_split_x_tile(const float* src, uint8_t* hi, uint8_t* lo,
                                                int r0, int t, const float2* stats,
                                                const float* __restrict__ gamma,
                                                const float* __restrict__ beta, int m0, int M) {
  const int c = t & 7;  // the chunk of both of this thread's rows
  float g[8], be[8];
  load8(gamma + c * 8, g);
  load8(beta + c * 8, be);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = r0 + ((t + 128 * j) >> 3);
    float v[8], y[8];
    load8(src + r * BK + c * 8, v);
    const float2 st = stats[r];
    const bool live = m0 + r < M;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      y[e] = 0.f;
      if (live) {
        y[e] = (v[e] - st.x) * st.y;
        y[e] = y[e] * g[e] + be[e];
      }
    }
    store_split8(y, hi, lo, r * 128 + ((c ^ (r & 7)) << 4));
  }
}

// --------------------------------------------------- shared-memory plan
// Byte offsets from the 1024-aligned base, the same on host and device.
//   a:    LN kinds: the normalized block (KT tiles of 8 KB; with HILO, hi and
//         lo tiles of the first ceil(KT/2) k-tiles); SPLITK kinds: the A ring
//   b:    the W ring, STAGES x BN x 64 values of TW
//   wcv:  int8 W: two converted bf16 W tiles (BN x 128 bytes each), a
//         k-tile apart
//   acv:  fp32 A of the SPLITK kinds: two (hi, lo) pairs of bf16 A tiles
//   st:   LN with HILO: 64 (mean, rstd) pairs
//   bar:  full[STAGES], empty[STAGES], and the x block's barrier
struct Plan {
  int a, b, wcv, acv, st, bar, total;
};

template <bool LN, bool HILO, int A_ELEM, int W_ELEM, int BN, int STAGES>
__host__ __device__ constexpr Plan plan(int K) {
  const int kt = K / BK;
  Plan p{};
  p.a = 0;
  p.b = LN ? (HILO ? 2 * ((kt + 1) / 2) : kt) * A_TILE_BYTES : STAGES * BM * BK * A_ELEM;
  p.wcv = p.b + STAGES * BN * BK * W_ELEM;
  p.acv = p.wcv + (W_ELEM == 1 ? 2 * BN * 128 : 0);
  p.st = p.acv + (!LN && A_ELEM == 4 ? 4 * A_TILE_BYTES : 0);
  p.bar = p.st + (LN && HILO ? BM * 8 : 0);
  p.total = 1024 + p.bar + (2 * STAGES + 1) * 8;  // + the alignment slack
  return p;
}

// ------------------------------------------------------------ the kernel
// Grid (ceil(N_out / BN), ceil(M / 64), SPLIT); the SPLITK kinds run as
// clusters of SPLIT blocks along z. LN kinds read a bf16 x through map_a
// (TMA, the whole 64-row block at once) and an fp32 x directly; the SPLITK
// kinds read A (TA) through map_a, and SPLITK_RESIDUAL the residual x (TX).
// W (TW) through map_b (a HiLo W: its two planes, 2 N_out rows). out
// (M, N_out) TO. The LN kinds with a HiLo W run ln_hilo_kernel instead.
template <int KIND, typename TX, typename TA, typename TW, typename TO, int BN, int STAGES,
          int SPLIT>
__device__ __forceinline__ void gemm_body(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                          const TX* __restrict__ x,
                                          const float* __restrict__ gamma,
                                          const float* __restrict__ beta,
                                          const float* __restrict__ wscale,
                                          const float* __restrict__ bias, TO* __restrict__ out,
                                          int M, int K, int N_out, float eps) {
  constexpr bool LN = KIND == LN_BIAS || KIND == LN_BIAS_GELU;
  constexpr bool W8 = std::is_same<TW, int8_t>::value;
  constexpr bool WP = std::is_same<TW, HiLo>::value;  // hi/lo W planes: a third pass
  constexpr bool A32 = !LN && std::is_same<TA, float>::value;
  constexpr bool HILO = A32 || (LN && std::is_same<TO, float>::value);  // two bf16 passes
  static_assert(!WP || A32, "a HiLo W here: a SPLITK kind with an fp32 A (ln_hilo_kernel "
                "takes the LN kinds)");
  constexpr bool CONVERT = W8 || A32;
  constexpr bool XS = LN && std::is_same<TX, bf16>::value;  // x block staged by TMA
  // the ring stage is free once converted, unless wgmma reads it directly
  constexpr bool RELEASE_EARLY = W8 && (LN || A32);
  constexpr int WN = BN / NC;                        // columns of one consumer warpgroup
  constexpr int B_STAGE = BN * BK * sizeof(TW);      // one W k-tile
  constexpr int A_STAGE = LN ? 0 : BM * BK * sizeof(TA);
  constexpr uint32_t TX_BYTES = B_STAGE + A_STAGE;
  static_assert(WN % 8 == 0 && (WN == 64 || WN == 96), "a warpgroup takes n64 or n96");
  static_assert(!(LN && SPLIT > 1), "the LN kinds do not split K");

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  constexpr int A_ELEM = LN ? 2 : static_cast<int>(sizeof(TA));
  const Plan p = plan<LN, HILO, A_ELEM, sizeof(TW), BN, STAGES>(K);
  uint8_t* a_smem = base + p.a;
  uint8_t* b_ring = base + p.b;
  uint8_t* wcv = base + p.wcv;
  uint8_t* acv = base + p.acv;
  float2* stats = reinterpret_cast<float2*>(base + p.st);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + p.bar);
  uint64_t* empty = full + STAGES;
  uint64_t* x_full = empty + STAGES;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int rank = SPLIT > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int kt_all = K / BK;
  const int kt0 = rank * kt_all / SPLIT;  // this block's k-tiles: kt0 ..
  const int kt_total = (rank + 1) * kt_all / SPLIT - kt0;
  // LN with HILO: k-tiles the block holds at a time (the first half)
  const int kc = HILO ? (kt_all + 1) / 2 : kt_all;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), CONSUMERS);
    }
    mbar_init(smem_u32(x_full), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[WN / 2];
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = 0.f;
  const int wg = tid / 128;
  const int t = tid % 128;

  if (XS && tid == CONSUMERS) {
    // the block's 64 rows of x, all C/64 tiles in flight at once, into the
    // LN block that the consumers then normalize in place
    const uint32_t xb = smem_u32(x_full);
    mbar_expect_tx(xb, kt_all * A_TILE_BYTES);
    for (int kt = 0; kt < kt_all; ++kt)
      tma_load_2d(smem_u32(a_smem + kt * A_TILE_BYTES), map_a, kt * BK, m0, xb);
  }
  if (tid >= CONSUMERS) {
    // ---- producer warp: one lane keeps STAGES k-tiles in flight
    if (tid == CONSUMERS) {
      for (int kt = 0; kt < kt_total; ++kt) {
        const int s = kt % STAGES;
        const int round = kt / STAGES;
        if (round > 0) mbar_wait(smem_u32(empty + s), (round - 1) & 1);
        const uint32_t bar = smem_u32(full + s);
        mbar_expect_tx(bar, TX_BYTES);
        const int k = (kt0 + kt) * BK;
        tma_load_2d(smem_u32(b_ring + s * B_STAGE), map_b, k, n0, bar);
        if constexpr (WP)  // the lo plane's tile after the hi plane's
          tma_load_2d(smem_u32(b_ring + s * B_STAGE + BN * 128), map_b, k, N_out + n0, bar);
        if constexpr (!LN) tma_load_2d(smem_u32(a_smem + s * A_STAGE), map_a, k, m0, bar);
      }
    }
    __syncwarp();
  } else {
    // ---- consumer warpgroups
    if constexpr (LN) {
      ln_rows_to_smem<TX, HILO, true, XS>(x, gamma, beta, m0, M, K, eps, a_smem, tid, 0, kc * 8,
                                          kc * A_TILE_BYTES, stats, smem_u32(x_full));
      // the generic-proxy stores must be visible to wgmma's async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_barrier_sync(1, CONSUMERS);
    }
    for (int kt = 0; kt < kt_total; ++kt) {
      const int s = kt % STAGES;
      if constexpr (LN && HILO) {
        if (kt == kc) {
          // the second half of the LN block, once no product reads the first
          wgmma_wait_all();
          fence_operands(acc);
          named_barrier_sync(1, CONSUMERS);
          ln_rows_to_smem<TX, true, false, false>(x, gamma, beta, m0, M, K, eps, a_smem, tid,
                                                  kc * 8, kt_all * 8, kc * A_TILE_BYTES, stats,
                                                  0);
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          named_barrier_sync(1, CONSUMERS);
        }
      }
      mbar_wait(smem_u32(full + s), (kt / STAGES) & 1);
      const int cb = kt & 1;  // conversion buffer
      uint32_t a_hi, b0;
      if constexpr (LN)
        a_hi = smem_u32(a_smem + (HILO && kt >= kc ? kt - kc : kt) * A_TILE_BYTES);
      else if constexpr (A32)
        a_hi = smem_u32(acv + cb * 2 * A_TILE_BYTES);
      else
        a_hi = smem_u32(a_smem + s * A_STAGE);
      const uint32_t a_lo = a_hi + (LN ? kc * A_TILE_BYTES : A_TILE_BYTES);
      if constexpr (W8)
        b0 = smem_u32(wcv + cb * BN * 128 + wg * WN * 128);
      else
        b0 = smem_u32(b_ring + s * B_STAGE + wg * WN * 128);
      const uint32_t b_lo = b0 + BN * 128;  // WP: the lo plane's tile

      if constexpr (CONVERT) {
        // convert tile kt while the products of tile kt-1 run; its buffers
        // (cb) were last read by tile kt-2's, complete before the barrier
        // of kt-1
        if constexpr (W8)
          convert_w_tile<WN>(b_ring + s * B_STAGE + wg * WN * 64,
                             wcv + cb * BN * 128 + wg * WN * 128, t);
        if constexpr (A32)
          split_a_tile(reinterpret_cast<const float*>(a_smem + s * A_STAGE),
                       acv + cb * 2 * A_TILE_BYTES, acv + cb * 2 * A_TILE_BYTES + A_TILE_BYTES,
                       wg * 32, t);
        if constexpr (RELEASE_EARLY) mbar_arrive(smem_u32(empty + s));
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        wgmma_wait_all();  // tile kt-1's products: its ring stage is free
        fence_operands(acc);
        if constexpr (!RELEASE_EARLY)
          if (kt > 0) mbar_arrive(smem_u32(empty + (kt - 1) % STAGES));
        // a converted A tile is both warpgroups' work; a W half is one's
        if constexpr (A32)
          named_barrier_sync(1, CONSUMERS);
        else
          named_barrier_sync(2 + wg, 128);
      }
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wgmma<WN>(acc, desc_sw128(a_hi + kk * 32), desc_sw128(b0 + kk * 32));
        if constexpr (HILO) wgmma<WN>(acc, desc_sw128(a_lo + kk * 32), desc_sw128(b0 + kk * 32));
        if constexpr (WP) wgmma<WN>(acc, desc_sw128(a_hi + kk * 32), desc_sw128(b_lo + kk * 32));
      }
      wgmma_commit();
      if constexpr (!CONVERT) {
        wgmma_wait_all();
        fence_operands(acc);
        mbar_arrive(smem_u32(empty + s));
      }
    }
    if constexpr (CONVERT) {
      wgmma_wait_all();
      fence_operands(acc);
    }
  }

  // accumulator fragment of thread t of warpgroup wg: register i holds
  // row (t/32)*16 + (t%32)/4 + 8*((i/2)%2), column wg*WN + (i/4)*8 + (t%4)*2 + i%2
  const int frow = (t / 32) * 16 + (t % 32) / 4;
  const int fcol = wg * WN + (t % 4) * 2;

  if constexpr (SPLIT == 1) {
    static_assert(KIND != SPLITK_RESIDUAL, "the residual epilogue is the split one");
    if (tid < CONSUMERS)
      store_tile<KIND, W8, WN>(acc, wscale, bias, out, m0, n0, M, N_out, wg, t);
  } else {
    // split-K: each block's fp32 partial tile (64 x BN, row stride BN+4)
    // over its own rings, once every consumer is done with them
    constexpr int LDP = BN + 4;
    float* part = reinterpret_cast<float*>(base);
    if (tid < CONSUMERS) {
      named_barrier_sync(1, CONSUMERS);
#pragma unroll
      for (int j = 0; j < WN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(part + (frow + 8 * h) * LDP + fcol + j * 8) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
    cluster_sync();
    // block `rank` sums its rows r_lo .. r_hi-1 over the SPLIT partials, in
    // rank order
    const int r_lo = rank * BM / SPLIT;
    const int r_hi = (rank + 1) * BM / SPLIT;
    const uint32_t part0 = smem_u32(part);
    for (int e = tid; e < (r_hi - r_lo) * (BN / 4); e += THREADS) {
      const int r = r_lo + e / (BN / 4);
      const int c = (e % (BN / 4)) * 4;
      const uint32_t addr = part0 + (r * LDP + c) * 4;
      float4 sum = ld_cluster_f4(addr, 0);
#pragma unroll
      for (int q = 1; q < SPLIT; ++q) {
        const float4 p4 = ld_cluster_f4(addr, q);
        sum.x += p4.x;
        sum.y += p4.y;
        sum.z += p4.z;
        sum.w += p4.w;
      }
      const int row = m0 + r;
      const int col = n0 + c;
      if (row < M && col < N_out) {
        if constexpr (W8) {
          const float4 sc = *reinterpret_cast<const float4*>(wscale + col);
          sum = make_float4(__fmul_rn(sum.x, sc.x), __fmul_rn(sum.y, sc.y),
                            __fmul_rn(sum.z, sc.z), __fmul_rn(sum.w, sc.w));
        }
        float4 v = sum;
        if constexpr (KIND != GEMM_F32OUT) {
          const float4 b = *reinterpret_cast<const float4*>(bias + col);
          v = make_float4(__fadd_rn(sum.x, b.x), __fadd_rn(sum.y, b.y), __fadd_rn(sum.z, b.z),
                          __fadd_rn(sum.w, b.w));
        }
        const size_t i = static_cast<size_t>(row) * N_out + col;
        if constexpr (KIND == SPLITK_RESIDUAL) {
          // the projection rounded once to x's type, then the residual add
          // in x's type
          const float4 r4 = load4(x + i);
          v = make_float4(r4.x + round_to(v.x, x), r4.y + round_to(v.y, x),
                          r4.z + round_to(v.z, x), r4.w + round_to(v.w, x));
        }
        store4(out + i, v);
      }
    }
    cluster_sync();  // no block leaves while another reads its partials
  }
}

template <int KIND, typename TX, typename TW, typename TO, int BN, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
ln_gemm_kernel(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_b, const TX* __restrict__ x,
               const float* __restrict__ gamma, const float* __restrict__ beta,
               const float* __restrict__ wscale, const float* __restrict__ bias,
               TO* __restrict__ out, int M, int K, int N_out, float eps) {
  gemm_body<KIND, TX, bf16, TW, TO, BN, STAGES, 1>(&map_x, &map_b, x, gamma, beta, wscale, bias,
                                                   out, M, K, N_out, eps);
}

template <int KIND, typename TX, typename TA, typename TW, typename TO, int BN, int STAGES,
          int SPLIT>
__global__ void __cluster_dims__(1, 1, SPLIT) __launch_bounds__(THREADS, 2)
splitk_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b, const TX* __restrict__ x,
                   const float* __restrict__ wscale, const float* __restrict__ bias,
                   TO* __restrict__ out, int M, int K, int N_out) {
  gemm_body<KIND, TX, TA, TW, TO, BN, STAGES, SPLIT>(&map_a, &map_b, x, nullptr, nullptr, wscale,
                                                     bias, out, M, K, N_out, 0.f);
}

// The LN kinds with an fp32 x, an fp32 out and a HiLo W (the qkv and fc1
// of an fp32-compute model), persistent: a grid of min(tiles, SMs) blocks,
// block i taking the output tiles i T/G .. (i+1) T/G - 1 of the T 64 x BN
// tiles in row-block-major order, so a block's tiles mostly share a row
// block, and the producer runs on into the next tile's k-tiles while the
// consumers finish one. Each ring stage holds a 64 x 64 fp32 x tile (TMA,
// unswizzled) and the W tile's hi and lo planes (TMA, swizzled). Per row
// block the consumers compute the 64 rows' statistics once (row_stats, from
// device memory); per k-tile they normalize and split the x tile into one of
// two hi/lo buffers (ln_split_x_tile, 32 rows a warpgroup) while the
// previous k-tile's products run, then issue hi.hi + lo.hi + hi.lo. No LN
// block is held, so the ring has STAGES stages at any C and no k-tile waits
// on a drain; the operands and rounding points are those of the LN-block
// form this replaced (ln_rows_to_smem with HILO, W split in shared memory),
// and so is the order of the products.
//   x ring:  STAGES x 16 KB; W ring: STAGES x BN x 256 bytes; acv: two
//   (hi, lo) A tiles (32 KB); stats: 64 (mean, rstd); full/empty barriers
struct HiloPlan {
  int x, w, acv, st, bar, total;
};

template <int BN, int STAGES>
__host__ __device__ constexpr HiloPlan hilo_plan() {
  HiloPlan p{};
  p.x = 0;
  p.w = STAGES * BM * BK * 4;
  p.acv = p.w + STAGES * BN * BK * 4;
  p.st = p.acv + 4 * A_TILE_BYTES;
  p.bar = p.st + BM * 8;
  p.total = 1024 + p.bar + 2 * STAGES * 8;
  return p;
}

template <int KIND, int BN, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
ln_hilo_kernel(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_w, const float* __restrict__ x,
               const float* __restrict__ gamma, const float* __restrict__ beta,
               const float* __restrict__ bias, float* __restrict__ out, int M, int K, int N_out,
               float eps) {
  constexpr int WN = BN / NC;
  constexpr int X_STAGE = BM * BK * 4;
  constexpr int W_STAGE = BN * BK * 4;  // the hi tile, then the lo tile
  static_assert(WN == 64 || WN == 96, "a warpgroup takes n64 or n96");
  constexpr HiloPlan p = hilo_plan<BN, STAGES>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* x_ring = base + p.x;
  uint8_t* w_ring = base + p.w;
  uint8_t* acv = base + p.acv;
  float2* stats = reinterpret_cast<float2*>(base + p.st);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + p.bar);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int tiles_n = (N_out + BN - 1) / BN;
  const int tiles = tiles_n * ((M + BM - 1) / BM);
  const int t_begin = static_cast<int>(static_cast<long long>(blockIdx.x) * tiles / gridDim.x);
  const int t_end = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * tiles / gridDim.x);
  const int kt_all = K / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer warp: one lane streams every tile's k-tiles, STAGES ahead
    if (tid == CONSUMERS) {
      int g = 0;  // k-tiles streamed so far, over all of this block's tiles
      for (int tile = t_begin; tile < t_end; ++tile) {
        const int n0 = (tile % tiles_n) * BN;
        const int m0 = (tile / tiles_n) * BM;
        for (int kt = 0; kt < kt_all; ++kt, ++g) {
          const int s = g % STAGES;
          if (g >= STAGES) mbar_wait(smem_u32(empty + s), (g / STAGES - 1) & 1);
          const uint32_t bar = smem_u32(full + s);
          mbar_expect_tx(bar, X_STAGE + W_STAGE);
          const int k = kt * BK;
          tma_load_2d(smem_u32(x_ring + s * X_STAGE), &map_x, k, m0, bar);
          tma_load_2d(smem_u32(w_ring + s * W_STAGE), &map_w, k, n0, bar);
          tma_load_2d(smem_u32(w_ring + s * W_STAGE + BN * 128), &map_w, k, N_out + n0, bar);
        }
      }
    }
    __syncwarp();
    return;
  }

  // ---- consumer warpgroups
  const int wg = tid / 128;
  const int t = tid % 128;
  int g = 0;
  int m_stats = -1;  // the row block whose statistics are in shared memory
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int n0 = (tile % tiles_n) * BN;
    const int m0 = (tile / tiles_n) * BM;
    if (m0 != m_stats) {
      // every read of the previous statistics came before the last barrier 1
      row_stats(x, m0, M, K, eps, stats, tid);
      named_barrier_sync(1, CONSUMERS);
      m_stats = m0;
    }
    float acc[WN / 2];
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < kt_all; ++kt, ++g) {
      const int s = g % STAGES;
      mbar_wait(smem_u32(full + s), (g / STAGES) & 1);
      // normalize and split x tile kt into buffer g&1 while the products of
      // the k-tile before it (the other buffer) run; this buffer's last
      // reader, two k-tiles back, completed before the previous barrier
      uint8_t* a_hi = acv + (g & 1) * 2 * A_TILE_BYTES;
      ln_split_x_tile(reinterpret_cast<const float*>(x_ring + s * X_STAGE), a_hi,
                      a_hi + A_TILE_BYTES, wg * 32, t, stats, gamma + kt * BK, beta + kt * BK,
                      m0, M);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wgmma_wait_all();  // the previous k-tile's products: its ring stage is free
      fence_operands(acc);
      if (kt > 0) mbar_arrive(smem_u32(empty + (g - 1) % STAGES));
      named_barrier_sync(1, CONSUMERS);  // both halves of the A tile are in
      const uint32_t ah = smem_u32(a_hi);
      const uint32_t al = ah + A_TILE_BYTES;
      const uint32_t bh = smem_u32(w_ring + s * W_STAGE + wg * WN * 128);
      const uint32_t bl = bh + BN * 128;
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wgmma<WN>(acc, desc_sw128(ah + kk * 32), desc_sw128(bh + kk * 32));
        wgmma<WN>(acc, desc_sw128(al + kk * 32), desc_sw128(bh + kk * 32));
        wgmma<WN>(acc, desc_sw128(ah + kk * 32), desc_sw128(bl + kk * 32));
      }
      wgmma_commit();
    }
    wgmma_wait_all();
    fence_operands(acc);
    mbar_arrive(smem_u32(empty + (g - 1) % STAGES));
    store_tile<KIND, false, WN>(acc, nullptr, bias, out, m0, n0, M, N_out, wg, t);
  }
}

// ----------------------------------------------- the large-M body (B.N rows)
// The plain products of many rows (M = B.N tokens of a batch: a lockstep
// step's S.N rows, a training step's 16.N):
//   - GEMM_F32OUT: out (M, N_out) fp32 = A . W^T (+ b);
//   - LN_BIAS: out (M, N_out) = TO(A . W^T (* s) + b), A the rows normalized
//     once by ln_rows_kernel (ln_qkv at M >= LARGE_M_ROWS of
//     ops/ln_qkv_attention.py): a bf16 out for a bf16 W (#1) and for the
//     int8 W of a bf16 x (#5, the payload converted to bf16 once a call by
//     i8_to_bf16_kernel, exact; s the per-row scale, in the epilogue); an
//     fp32 out for the int8 W of an fp32 x, whose normalized rows stay fp32
//     as hi and lo bf16 halves (ALO: A is (M, 2K), hi | lo, and each k-tile
//     runs hi.W then lo.W, 16 deep at a time, the 64-row body's order);
//   - LN_BIAS_GELU: out (M, N_out) bf16 = gelu(A . W^T + b), A the rows
//     normalized once by ln_rows_kernel (fc1 of kernel #7 and of a rank's
//     MLP share);
//   - fc2 of kernel #7 (ln_mlp at M >= LARGE_M_ROWS) is LN_BIAS with a bf16
//     out on the hidden tensor: nothing in that kind normalizes, the rows
//     were normalized before it (ln_qkv) or are the GELU's (fc2), and its
//     epilogue, bf16(A . W^T + b), is fc2_bias's;
//   - LM_RESIDUAL: out (M, N_out) = x + TX(A . W^T (* s) + b) in x's type
//     TX (proj_residual at M >= its LARGE_M_ROWS, kernels #4 and #6): the
//     product rounded once to TX, then the residual x (M, N_out) added in
//     TX, read at the accumulator fragments' own positions in the epilogue
//     (SPLITK_RESIDUAL's order of operations); an int8 W converted once a
//     call, s its scale; an fp32 A (#6 at an fp32 x) as hi | lo rows (ALO),
//     written once a call by split_rows_kernel;
// A (M, K) and W (N_out, K) bf16. At that M the output tiles alone fill the
// card, so K is not split over blocks: each tile sums its k-tiles in order,
// and two calls give the same bits. fc2 and LM_RESIDUAL sum them in the
// parts of the 64-row body's split-K clusters (PARTS), each from zero, and
// add the parts in its rank order, so their outputs are that body's bit for
// bit; the kernel's fc1 takes that body's GELU (erfcf, ERF) for the same. At B.N rows the 64-row LN body above lost
// 2.5-3.3x to this one (device time, ln_qkv at B = 4-16): its every column
// tile normalizes its 64 rows again (F/128 = 18 times at F = 2,304), and its
// 828 tiles at B=8 run in waves with no product under the next tile's
// prologue. The tracking step's B=1 rows (321/361) stay on the 64-row body,
// one launch where this entry makes two (three with int8), though this body
// is the faster there too in device time (9.2 against 12.8 us). Tiles of
// 128 x BN, one per block at a time, on a
// persistent grid of min(tiles, SMs) blocks, block i taking tiles i T/G ..
// (i+1) T/G - 1 in row-block-major order:
//   - a producer warpgroup, one lane of which streams the A k-tile (128
//     rows) and the W k-tile (BN rows) of every tile through a STAGES-deep
//     TMA ring, on into the next tile's while the consumers finish one; its
//     registers go to the consumers (setmaxnreg);
//   - two consumer warpgroups each own 64 rows of the tile and all BN
//     columns (wgmma m64n{BN}k16, BN/2 fp32 accumulators a thread), so they
//     synchronize only on the ring's barriers, and keep one k-tile's
//     products in flight behind the next;
//   - at the tile's end each writes its rows (+ b) in fp32 into its staging
//     in shared memory, 128 columns at a time, and stores them by TMA
//     (cp.async.bulk.tensor, boxes of 64 rows x 128 bytes in the 128-byte
//     swizzle, conflict-free for the accumulator fragments), which runs
//     while the next tile's products do. A bf16 LN_BIAS out is rounded from
//     the fragments straight into bf16 boxes of 64 columns, all BN columns
//     at once (the same 32 KB a warpgroup as 128 fp32 columns), and stored
//     the same way. LN_BIAS_GELU first turns the
//     staged rows into their exact GELU in bf16 (gelu_staged), with many
//     GELUs in flight a thread once the accumulators are dead: applied to
//     the fragments, the GELUs took longer than fc1's products.
// BN is 128, 192 or 256 (LN_BIAS_GELU: 128 or 192) as pick_bn says, the
// fewest rounds of tiles over the SMs. 128 x 128 tiles of two consumers
// read more shared memory a k-tile (the W tile twice, the TMA writes) than
// the tensor cores need in that time; the wider tiles stay under it, where
// the rounds allow. Two other schedules were slower on one H100: the GELUs
// on three extra epilogue warps beside the next tile's products (a thread
// of 512 gets 128 registers, and the consumers' accumulators spilled), and
// in eight slices between the next tile's first k-tiles (the slices
// outlasted the products).
constexpr int LBM = 2 * BM;  // rows of a large-M tile: 64 a consumer warpgroup
constexpr int LM_THREADS = CONSUMERS + 128;  // + a producer warpgroup (one lane streams)

// Byte offsets from the 1024-aligned base: the ring (a: STAGES A k-tiles of
// 128 rows, with ALO the hi tile then the lo tile; w: STAGES W k-tiles of BN
// rows), the staged output of each warpgroup (out: 64 rows x OUT_CH columns
// in fp32, the product and bias, or, for a bf16 LN_BIAS out, all BN columns
// in bf16; out16: LN_BIAS_GELU's GELU of it in bf16), the full/empty
// barriers.
template <int KIND, typename TO, int BN, int STAGES, bool ALO>
struct LargeMPlan {
  static constexpr bool GELU = KIND == LN_BIAS_GELU;
  static constexpr bool B16OUT =
      (KIND == LN_BIAS || KIND == LM_RESIDUAL) && std::is_same<TO, bf16>::value;
  static constexpr int A_TILE = LBM * BK * 2;  // one 128-row A k-tile
  static constexpr int A_STAGE = (ALO ? 2 : 1) * A_TILE;
  static constexpr int W_STAGE = BN * BK * 2;
  static constexpr int OUT_CH = B16OUT ? BN : BN < 128 ? BN : 128;  // columns staged at a time
  static constexpr int F32_WG = BM * OUT_CH * (B16OUT ? 2 : 4);
  static constexpr int B16_WG = GELU ? BM * OUT_CH * 2 : 0;
  static constexpr int a = 0;
  static constexpr int w = STAGES * A_STAGE;
  static constexpr int out = w + STAGES * W_STAGE;
  static constexpr int out16 = out + 2 * F32_WG;
  static constexpr int bar = out16 + 2 * B16_WG;
  static constexpr int total = 1024 + bar + (2 * STAGES + 4) * 8;  // + the alignment slack
};

// erf(x) in fp32 as a rational function of x on [-4, 4] (x p(x^2) / q(x^2),
// XLA's f32 erf; |erf| rounds to 1 beyond), within a few ulps of 1 in
// absolute terms: one fast division and 11 FMAs. The large-M GELU pass took
// three times as long with erfcf (gelu_erf), whose tail accuracy a bf16
// output does not keep.
__device__ __forceinline__ float erf_rational(float x) {
  x = fminf(fmaxf(x, -4.f), 4.f);
  const float x2 = x * x;
  float p = -2.72614225801306e-10f;
  p = fmaf(p, x2, 2.77068142495902e-08f);
  p = fmaf(p, x2, -2.10102402082508e-06f);
  p = fmaf(p, x2, -5.69250639462346e-05f);
  p = fmaf(p, x2, -7.34990630326855e-04f);
  p = fmaf(p, x2, -2.95459980854025e-03f);
  p = fmaf(p, x2, -1.60960333262415e-02f);
  float q = -1.45660718464996e-05f;
  q = fmaf(q, x2, -2.13374055278905e-04f);
  q = fmaf(q, x2, -1.68282697438203e-03f);
  q = fmaf(q, x2, -7.37332916720468e-03f);
  q = fmaf(q, x2, -1.42647390514189e-02f);
  return __fdividef(x * p, q);
}

// exact GELU, 0.5 v (1 + erf(v / sqrt(2))), with erf_rational
__device__ __forceinline__ float gelu_rational(float v) {
  return 0.5f * v * (1.f + erf_rational(v * 0.70710678118654752f));
}

// Rows 0..63 x columns 0..WIDTH-1 of a consumer warpgroup's staged fp32
// values (boxes of 32 columns) -> their exact GELU in bf16 (boxes of 64
// columns), both in the 128-byte swizzle; the 128 threads (t) take 8
// consecutive values of a row at a time, rows t % 64, so each 8-lane phase
// of a 16-byte access touches 8 rows' distinct chunks. Apart from the
// accumulators, which are dead by then: the registers they held carry many
// GELUs at once, where applying it to the fragments one by one left the
// epilogue slower than the tile's products.
template <int WIDTH, bool ERF>
__device__ __forceinline__ void gelu_staged(const uint8_t* __restrict__ f32,
                                            uint8_t* __restrict__ b16, int t) {
  auto gelu = [](float v) { return ERF ? gelu_erf(v) : gelu_rational(v); };
  constexpr int Q = WIDTH / 16;  // 8-value groups a thread
  const int r = t & 63;
  float4 v[Q][2];
#pragma unroll
  for (int q = 0; q < Q; ++q) {  // every load first, so the GELUs overlap
    const int cg = (t >> 6) + 2 * q;  // the 8-column group
    const uint8_t* src = f32 + (cg >> 2) * (BM * 128) + r * 128;
    v[q][0] = *reinterpret_cast<const float4*>(src + ((((cg & 3) * 2) ^ (r & 7)) << 4));
    v[q][1] = *reinterpret_cast<const float4*>(src + ((((cg & 3) * 2 + 1) ^ (r & 7)) << 4));
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int cg = (t >> 6) + 2 * q;
    const float4 lo = v[q][0], hi = v[q][1];
    uint8_t* dst = b16 + (cg >> 3) * (BM * 128) + r * 128 + (((cg & 7) ^ (r & 7)) << 4);
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(pack_bf16(gelu(lo.x), gelu(lo.y)), pack_bf16(gelu(lo.z), gelu(lo.w)),
                   pack_bf16(gelu(hi.x), gelu(hi.y)), pack_bf16(gelu(hi.z), gelu(hi.w)));
  }
}

// The rows of an fp32 A (M, K) -> their hi and lo bf16 halves (split_bf16)
// side by side, y (M, 2K), the hi half of a row in columns 0..K-1 and its lo
// half after it: the ALO operand of LM_RESIDUAL (#6's projection of an fp32
// attention output). 8 values a thread, one 32-byte load and two 16-byte
// stores.
__global__ void __launch_bounds__(256)
split_rows_kernel(const float* __restrict__ a, bf16* __restrict__ y, int M, int K) {
  const int per_row = K / 8;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(M) * per_row) return;
  const size_t row = i / per_row;
  const int ch = static_cast<int>(i % per_row);
  float v[8];
  load8(a + row * K + ch * 8, v);
  uint8_t* hi = reinterpret_cast<uint8_t*>(y + row * 2 * K);
  store_split8(v, hi, hi + K * 2, ch * 16);
}

// The LN of the rows of x (M, C) into y (M, C) bf16, one warp a row, with
// ln_rows_to_smem's arithmetic (fp32 sums in its order, fast variance
// clamped at 0, rsqrtf, one rounding): the A operand of the large-M LN
// kinds, so that no tile normalizes its rows again. HILO: the normalized
// row stays fp32 as its hi and lo bf16 halves (split_bf16, as
// ln_rows_to_smem's HILO writes them), y (M, 2C), the hi half of a row in
// columns 0..C-1 and its lo half after it. Each lane owns the 16-byte
// chunks ch = lane + 32j of its row, and loads its gamma and beta with its
// x, so the row waits on one round trip; rows read once, with 16-byte loads.
template <typename TX, bool HILO = false>
__global__ void __launch_bounds__(256)
ln_rows_kernel(const TX* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, bf16* __restrict__ y, int M, int C, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const int nch = C / 8;
  const float inv_c = 1.f / C;
  float v[MAX_CH][8], g[MAX_CH][8], be[MAX_CH][8];
#pragma unroll
  for (int j = 0; j < MAX_CH; ++j) {
    const int ch = lane + 32 * j;
    if (ch < nch) {
      load8(x + static_cast<size_t>(row) * C + ch * 8, v[j]);
      load8(gamma + ch * 8, g[j]);
      load8(beta + ch * 8, be[j]);
    }
  }
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int j = 0; j < MAX_CH; ++j) {
    if (lane + 32 * j < nch) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s += v[j][e];
        ss += v[j][e] * v[j][e];
      }
    }
  }
  const float mean = warp_sum(s) * inv_c;
  const float var = fmaxf(warp_sum(ss) * inv_c - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);
#pragma unroll
  for (int j = 0; j < MAX_CH; ++j) {
    const int ch = lane + 32 * j;
    if (ch < nch) {
      float o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        o[e] = (v[j][e] - mean) * rstd;
        o[e] = o[e] * g[j][e] + be[j][e];
      }
      if constexpr (HILO) {
        uint8_t* hi = reinterpret_cast<uint8_t*>(y + static_cast<size_t>(row) * 2 * C);
        store_split8(o, hi, hi + C * 2, ch * 16);
      } else {
        *reinterpret_cast<uint4*>(y + static_cast<size_t>(row) * C + ch * 8) =
            make_uint4(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]), pack_bf16(o[4], o[5]),
                       pack_bf16(o[6], o[7]));
      }
    }
  }
}

// An int8 W payload (n values, n % 16 == 0) -> bf16, exact (|q| <= 127):
// the large-M body's W operand for the int8 kinds, converted once a call
// (the 64-row body converts every W tile in each of its row blocks). 16
// values a thread, one 16-byte load and two 16-byte stores.
__global__ void __launch_bounds__(256)
i8_to_bf16_kernel(const int8_t* __restrict__ w, bf16* __restrict__ out, size_t n) {
  const size_t i = (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 16;
  if (i >= n) return;
  const uint4 v = *reinterpret_cast<const uint4*>(w + i);
  const uint2 a = i8x4_to_bf16x4(v.x), b = i8x4_to_bf16x4(v.y);
  const uint2 c = i8x4_to_bf16x4(v.z), d = i8x4_to_bf16x4(v.w);
  uint4* o = reinterpret_cast<uint4*>(out + i);
  o[0] = make_uint4(a.x, a.y, b.x, b.y);
  o[1] = make_uint4(c.x, c.y, d.x, d.y);
}

// --------------------------------------------------------------- host side
template <typename T>
struct TmaType;
template <>
struct TmaType<bf16> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct TmaType<int8_t> {  // bytes are bytes: the kernels convert the payload
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};
template <>
struct TmaType<float> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

// The TMA descriptor of a rank-R tensor of T at ptr (dims and box in
// elements, innermost first; strides in bytes of dims 1..R-1): bf16 with the
// 128-byte swizzle wgmma reads, int8 and fp32 unswizzled (the consumers
// convert them), unless the caller names a swizzle (store_map's output
// boxes). Encoded once per (pointer, type, dims, strides, box, swizzle) and
// cached: weights never move, and an activation's key repeats whenever the
// allocator hands its buffer out again. The cache holds only what the
// arguments determine, so libraries that share it (see below) agree on it;
// it is cleared at 4096 entries, which bounds a long-lived process's.
template <typename T, int R>
inline int cached_map(const T* ptr, const cuuint64_t (&dims)[R], const cuuint64_t (&strides)[R - 1],
                      const cuuint32_t (&box)[R], CUtensorMap* map,
                      CUtensorMapSwizzle swizzle = sizeof(T) == 2 ? CU_TENSOR_MAP_SWIZZLE_128B
                                                                  : CU_TENSOR_MAP_SWIZZLE_NONE) {
  using Key = std::array<uint64_t, 3 * R + 2>;  // ptr, type, dims, strides, box, swizzle
  static std::mutex mu;
  static std::map<Key, CUtensorMap> cache;
  Key key{};
  key[0] = reinterpret_cast<uintptr_t>(ptr);
  key[1] = static_cast<uint64_t>(TmaType<T>::value);
  for (int i = 0; i < R; ++i) {
    key[2 + i] = dims[i];
    key[2 + R + i] = box[i];
    if (i + 1 < R) key[2 + 2 * R + i] = strides[i];
  }
  key[3 * R + 1] = static_cast<uint64_t>(swizzle);
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it == cache.end()) {
    if (cache.size() >= 4096) cache.clear();
    CUtensorMap m;
    cuuint32_t elem[R];
    for (int i = 0; i < R; ++i) elem[i] = 1;
    const CUresult r = cuTensorMapEncodeTiled(
        &m, TmaType<T>::value, R, const_cast<T*>(ptr), dims, strides, box, elem,
        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
    it = cache.emplace(key, m).first;
  }
  std::memcpy(map, &it->second, sizeof(CUtensorMap));
  return 0;
}

// A row-major (rows, cols) matrix of T read in boxes of box_rows x 64 values
template <typename T>
inline int tensor_map(const T* ptr, uint64_t rows, uint64_t cols, uint32_t box_rows,
                      CUtensorMap* map) {
  return cached_map<T, 2>(ptr, {cols, rows}, {cols * sizeof(T)}, {BK, box_rows}, map);
}

// The large-M body's output (rows, cols) of T, stored in boxes of 64 rows x
// 128 bytes in the 128-byte swizzle (its staging layout in shared memory)
template <typename T>
inline int store_map(const T* ptr, uint64_t rows, uint64_t cols, CUtensorMap* map) {
  return cached_map<T, 2>(ptr, {cols, rows}, {cols * sizeof(T)}, {128 / sizeof(T), BM}, map,
                          CU_TENSOR_MAP_SWIZZLE_128B);
}

// A weight's descriptor, boxes of box_rows x 64 values; a HiLo W's covers
// both of its planes, (2 N_out, K) bf16, the lo plane's rows after the hi's
template <typename TW>
inline int weight_map(const TW* w, uint64_t n_out, uint64_t k, uint32_t box_rows,
                      CUtensorMap* map) {
  if constexpr (std::is_same<TW, HiLo>::value)
    return tensor_map(reinterpret_cast<const bf16*>(w), 2 * n_out, k, box_rows, map);
  else
    return tensor_map(w, n_out, k, box_rows, map);
}

// the output type of the SPLITK kinds: x's for the residual; fp32 for
// GEMM_F32OUT and with a HiLo W (an fp32-compute model's fc2), else bf16
template <int KIND, typename TX, typename TW>
using splitk_out_t = std::conditional_t<
    KIND == SPLITK_RESIDUAL, TX,
    std::conditional_t<KIND == GEMM_F32OUT || std::is_same<TW, HiLo>::value, float, bf16>>;

// SMs of the current device (the persistent grid's size)
inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// cudaFuncSetAttribute for the dynamic shared memory a launch needs, made
// again only when a larger size than `allowed` (the launcher's own record
// for its kernel) is asked for
template <typename F>
inline int allow_smem(F* kernel, int bytes, int& allowed) {
  if (bytes > allowed) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = bytes;
  }
  return 0;
}

constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory a block may use

// The launchers have internal linkage: each keeps its kernel's opted-in
// shared-memory size in a static, and a static of an inline function would
// otherwise be one object across every loaded library that instantiates it
// (GNU unique symbols), while each library's kernel needs its own opt-in.
namespace {

// The large-M body (see its section above): a persistent grid over the
// 128 x BN tiles. Internal linkage, as the launchers: proj_residual.cu and
// ln_mlp.cu both instantiate GEMM_F32OUT, and each library registers and
// launches its own copy. SCALE: an int8 W's per-row scale multiplies the
// accumulator (wscale); ALO: A is (M, 2K), hi | lo halves of fp32 rows;
// PARTS: K summed in that many parts, each from zero, added in order (the
// 64-row body's split-K reduction); ERF: LN_BIAS_GELU's GELU with erfcf, as
// the 64-row body's (gelu_erf), else the rational erf; resid: LM_RESIDUAL's
// x (M, N_out), in the out's type.
template <int KIND, typename TO, int BN, int STAGES, bool SCALE, bool ALO, int PARTS, bool ERF>
__global__ void __launch_bounds__(LM_THREADS, 1)
large_m_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_w,
               const __grid_constant__ CUtensorMap map_out, const float* __restrict__ wscale,
               const float* __restrict__ bias, const TO* __restrict__ resid, int M, int K,
               int N_out) {
  using P = LargeMPlan<KIND, TO, BN, STAGES, ALO>;
  constexpr bool GELU = P::GELU;
  constexpr bool B16OUT = P::B16OUT;
  constexpr bool RESID = KIND == LM_RESIDUAL;
  constexpr int OUT_BOX = 128 / sizeof(TO);  // columns of one 128-byte output box
  static_assert(BN % 64 == 0 && P::OUT_CH % 64 == 0 && BN <= 256,
                "BN: wgmma's n, whole output boxes of either type");
  static_assert(GELU ? std::is_same<TO, bf16>::value
                     : KIND == LN_BIAS || RESID ||
                           (KIND == GEMM_F32OUT && std::is_same<TO, float>::value),
                "GEMM_F32OUT: an fp32 out; LN_BIAS_GELU: a bf16 out; LN_BIAS, LM_RESIDUAL: either");
  static_assert(!(SCALE || ALO) || KIND == LN_BIAS || RESID,
                "an int8 W's scale, hi/lo A: LN_BIAS, LM_RESIDUAL");
  static_assert(!ALO || std::is_same<TO, float>::value, "hi/lo rows: an fp32 out");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* a_ring = base + P::a;
  uint8_t* w_ring = base + P::w;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + P::bar);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int tiles_n = (N_out + BN - 1) / BN;
  const int tiles = tiles_n * ((M + LBM - 1) / LBM);
  const int t_begin = static_cast<int>(static_cast<long long>(blockIdx.x) * tiles / gridDim.x);
  const int t_end = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * tiles / gridDim.x);
  const int kt_all = K / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer warpgroup: its registers go to the consumers, and one
    // lane streams every tile's k-tiles, STAGES ahead
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == CONSUMERS) {
      int g = 0;  // k-tiles streamed so far, over all of this block's tiles
      for (int tile = t_begin; tile < t_end; ++tile) {
        const int n0 = (tile % tiles_n) * BN;
        const int m0 = (tile / tiles_n) * LBM;
        for (int kt = 0; kt < kt_all; ++kt, ++g) {
          const int s = g % STAGES;
          if (g >= STAGES) mbar_wait(smem_u32(empty + s), (g / STAGES - 1) & 1);
          const uint32_t bar = smem_u32(full + s);
          mbar_expect_tx(bar, P::A_STAGE + P::W_STAGE);
          tma_load_2d(smem_u32(a_ring + s * P::A_STAGE), &map_a, kt * BK, m0, bar);
          if constexpr (ALO)  // the lo half's tile after the hi half's
            tma_load_2d(smem_u32(a_ring + s * P::A_STAGE + P::A_TILE), &map_a, K + kt * BK, m0,
                        bar);
          tma_load_2d(smem_u32(w_ring + s * P::W_STAGE), &map_w, kt * BK, n0, bar);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: warpgroup wg owns rows wg*64 .. wg*64+63 of a
  // tile; its barrier is 2 + wg, and its thread t == 0 issues its TMA stores
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid / 128;
  const int t = tid % 128;
  const int wg_bar = 2 + wg;
  uint8_t* staged = base + P::out + wg * P::F32_WG;
  uint8_t* staged16 = base + P::out16 + wg * P::B16_WG;
  const int frow = (t / 32) * 16 + (t % 32) / 4;  // a fragment's first row
  int g = 0;
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int n0 = (tile % tiles_n) * BN;
    const int r0 = (tile / tiles_n) * LBM + wg * BM;
    // PARTS > 1: the k-tiles of each part r (r kt/PARTS .. (r+1) kt/PARTS - 1,
    // the 64-row body's split-K ranks) summed from zero into `part`, and the
    // parts added into acc in order, as that body's cluster adds its ranks'
    // partials: every output bit for bit the 64-row body's
    float acc[BN / 2], part[PARTS > 1 ? BN / 2 : 1];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (PARTS > 1 ? BN / 2 : 1); ++i) part[i] = 0.f;
    auto ktile = [&](float(&d)[BN / 2], uint32_t a_tile, uint32_t w_tile) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wgmma<BN>(d, desc_sw128(a_tile + kk * 32), desc_sw128(w_tile + kk * 32));
        if constexpr (ALO)
          wgmma<BN>(d, desc_sw128(a_tile + P::A_TILE + kk * 32), desc_sw128(w_tile + kk * 32));
      }
    };
    int r = 0, part_end = kt_all / PARTS;
    for (int kt = 0; kt < kt_all; ++kt, ++g) {
      const int s = g % STAGES;
      mbar_wait(smem_u32(full + s), (g / STAGES) & 1);
      const uint32_t a_tile = smem_u32(a_ring + s * P::A_STAGE + wg * A_TILE_BYTES);
      const uint32_t w_tile = smem_u32(w_ring + s * P::W_STAGE);
      fence_operands(acc);
      if constexpr (PARTS > 1) fence_operands(part);
      wgmma_fence();
      if constexpr (PARTS > 1)
        ktile(part, a_tile, w_tile);
      else
        ktile(acc, a_tile, w_tile);
      wgmma_commit();
      // one k-tile's products stay in flight: the one before is done, and
      // its ring stage is free
      wgmma_wait<1>();
      fence_operands(acc);
      if constexpr (PARTS > 1) fence_operands(part);
      if (kt > 0) mbar_arrive(smem_u32(empty + (g - 1) % STAGES));
      if constexpr (PARTS > 1) {
        if (kt + 1 == part_end) {  // the part is complete once its products are
          wgmma_wait<0>();
          fence_operands(part);
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) {
            acc[i] = r == 0 ? part[i] : __fadd_rn(acc[i], part[i]);
            part[i] = 0.f;
          }
          ++r;
          part_end = (r + 1) * kt_all / PARTS;
        }
      }
    }
    wgmma_wait<0>();
    fence_operands(acc);
    mbar_arrive(smem_u32(empty + (g - 1) % STAGES));

    if constexpr (B16OUT) {
      // ---- bf16 epilogue: bf16(acc (* s) + b) of all BN columns into the
      // staged boxes once the warpgroup's previous stores have read them
      // (each 8-lane phase writes 8 rows' distinct chunks), then TMA stores
      if (t == 0) bulk_wait_read();
      named_barrier_sync(wg_bar, 128);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = j * 8 + (t % 4) * 2;
        float2 b = make_float2(0.f, 0.f), sc = make_float2(1.f, 1.f);
        if (n0 + col < N_out) {
          b = *reinterpret_cast<const float2*>(bias + n0 + col);
          if constexpr (SCALE) sc = *reinterpret_cast<const float2*>(wscale + n0 + col);
        }
        const int byte = col * 2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = frow + 8 * h;
          float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if constexpr (SCALE) {
            v0 = __fmul_rn(v0, sc.x);
            v1 = __fmul_rn(v1, sc.y);
          }
          v0 = __fadd_rn(v0, b.x);
          v1 = __fadd_rn(v1, b.y);
          if constexpr (RESID) {
            // the product rounded to bf16, then x + it, rounded again
            if (r0 + r < M && n0 + col < N_out) {
              const float2 xr = load2(resid + static_cast<size_t>(r0 + r) * N_out + n0 + col);
              v0 = xr.x + round_to(v0, resid);
              v1 = xr.y + round_to(v1, resid);
            }
          }
          *reinterpret_cast<uint32_t*>(staged + (byte >> 7) * (BM * 128) + r * 128 +
                                       ((((byte & 127) >> 4) ^ (r & 7)) << 4) + (byte & 15)) =
              pack_bf16(v0, v1);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_barrier_sync(wg_bar, 128);
      if (t == 0 && r0 < M) {
        for (int bx = 0; bx < BN / OUT_BOX && n0 + bx * OUT_BOX < N_out; ++bx)
          tma_store_2d(&map_out, n0 + bx * OUT_BOX, r0, smem_u32(staged + bx * BM * 128));
        bulk_commit();
      }
      continue;
    }
    // ---- epilogue, OUT_CH columns at a time: the fp32 product ((* s) + b)
    // into the staged rows once the warpgroup's previous stores have read
    // them, (LN_BIAS_GELU: its GELU in bf16, gelu_staged) then TMA stores
#pragma unroll
    for (int c0 = 0; c0 < BN; c0 += P::OUT_CH) {
      const int cw = c0 + P::OUT_CH < BN ? P::OUT_CH : BN - c0;
      if (t == 0) bulk_wait_read();
      named_barrier_sync(wg_bar, 128);
#pragma unroll
      for (int j = c0 / 8; j < (c0 + cw) / 8; ++j) {
        const int col = j * 8 + (t % 4) * 2;
        float2 b = make_float2(0.f, 0.f), sc = make_float2(1.f, 1.f);
        if (bias != nullptr && n0 + col < N_out)
          b = *reinterpret_cast<const float2*>(bias + n0 + col);
        if constexpr (SCALE)
          if (n0 + col < N_out) sc = *reinterpret_cast<const float2*>(wscale + n0 + col);
        const int byte = (col - c0) * 4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = frow + 8 * h;
          float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if constexpr (SCALE) {
            v0 = __fmul_rn(v0, sc.x);
            v1 = __fmul_rn(v1, sc.y);
          }
          if (bias != nullptr) {
            v0 = __fadd_rn(v0, b.x);
            v1 = __fadd_rn(v1, b.y);
          }
          if constexpr (RESID) {  // an fp32 x: x + the product, exactly as fp32 adds
            if (r0 + r < M && n0 + col < N_out) {
              const float2 xr = load2(resid + static_cast<size_t>(r0 + r) * N_out + n0 + col);
              v0 = xr.x + v0;
              v1 = xr.y + v1;
            }
          }
          store2(reinterpret_cast<float*>(staged + (byte >> 7) * (BM * 128) + r * 128 +
                                          ((((byte & 127) >> 4) ^ (r & 7)) << 4) + (byte & 15)),
                 v0, v1);
        }
      }
      if constexpr (GELU) {
        named_barrier_sync(wg_bar, 128);
        if (cw == P::OUT_CH)
          gelu_staged<P::OUT_CH, ERF>(staged, staged16, t);
        else if constexpr (BN % P::OUT_CH != 0)  // BN = 192's last 64 columns
          gelu_staged<BN % P::OUT_CH, ERF>(staged, staged16, t);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_barrier_sync(wg_bar, 128);
      if (t == 0 && r0 < M) {
        const uint8_t* src = GELU ? staged16 : staged;
        for (int bx = 0; bx < cw / OUT_BOX && n0 + c0 + bx * OUT_BOX < N_out; ++bx)
          tma_store_2d(&map_out, n0 + c0 + bx * OUT_BOX, r0, smem_u32(src + bx * BM * 128));
        bulk_commit();
      }
    }
  }
  if (t == 0) bulk_wait();
}

// LN kinds: out (M, N_out) = TO(EPI(LN(x) . W^T (* s) + b)); W (N_out, C)
// bf16, or int8 with its per-row scale s (an fp32 W: launch_ln_hilo)
template <int KIND, typename TX, typename TW, typename TO, int BN, int STAGES>
inline int launch_ln_gemm(const TX* x, const float* gamma, const float* beta, const TW* w,
                          const float* wscale, const float* bias, TO* out, int M, int C,
                          int N_out, float eps, cudaStream_t stream) {
  static_assert(!std::is_same<TW, HiLo>::value, "a HiLo W of the LN kinds: launch_ln_hilo");
  constexpr bool HILO = std::is_same<TO, float>::value;
  if (C % BK != 0 || C > MAX_C || N_out % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (std::is_same<TW, int8_t>::value && wscale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = plan<true, HILO, 2, sizeof(TW), BN, STAGES>(C).total;
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_x{}, map_b;  // map_x: a bf16 x only
  int err = tensor_map(w, N_out, C, BN, &map_b);
  if (!err && std::is_same<TX, bf16>::value) err = tensor_map(x, M, C, BM, &map_x);
  if (err) return err;
  static int allowed = 0;
  auto* kernel = ln_gemm_kernel<KIND, TX, TW, TO, BN, STAGES>;
  if ((err = allow_smem(kernel, smem, allowed))) return err;
  const dim3 grid((N_out + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, THREADS, smem, stream>>>(map_x, map_b, x, gamma, beta, wscale, bias, out, M, C,
                                          N_out, eps);
  return 0;
}

// SPLITK kinds, K split over a cluster of SPLIT blocks: A (M, K) bf16 or
// fp32, W (N_out, K) bf16, int8 with its scale s, or HiLo (its planes; an
// fp32 A);
//   SPLITK_BIAS:     out = TO(A . W^T + b), TO = fp32 for a HiLo W, else bf16
//   SPLITK_RESIDUAL: out = x + TX(A . W^T (* s) + b), in x's type TX
//   GEMM_F32OUT:     out = A . W^T in fp32, bf16 A and W, no bias
template <int KIND, typename TX, typename TA, typename TW, int BN, int STAGES, int SPLIT>
inline int launch_splitk_gemm(const TA* a, const TW* w, const float* wscale, const TX* x,
                              const float* bias, splitk_out_t<KIND, TX, TW>* out, int M, int K,
                              int N_out, cudaStream_t stream) {
  using TO = splitk_out_t<KIND, TX, TW>;
  constexpr bool HILO = std::is_same<TA, float>::value;
  if (K % BK != 0 || K / BK < SPLIT || N_out % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (std::is_same<TW, int8_t>::value && wscale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (KIND == SPLITK_RESIDUAL && x == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = plan<false, HILO, sizeof(TA), sizeof(TW), BN, STAGES>(K).total;
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  static_assert(BM * (BN + 4) * 4 <= STAGES * (BM * BK * sizeof(TA) + BN * BK * sizeof(TW)),
                "the fp32 partial tile fits over the rings");
  CUtensorMap map_a, map_b;
  int err = tensor_map(a, M, K, BM, &map_a);
  if (!err) err = weight_map(w, N_out, K, BN, &map_b);
  if (err) return err;
  static int allowed = 0;
  auto* kernel = splitk_gemm_kernel<KIND, TX, TA, TW, TO, BN, STAGES, SPLIT>;
  if ((err = allow_smem(kernel, smem, allowed))) return err;
  const dim3 grid((N_out + BN - 1) / BN, (M + BM - 1) / BM, SPLIT);
  kernel<<<grid, THREADS, smem, stream>>>(map_a, map_b, x, wscale, bias, out, M, K, N_out);
  return 0;
}

// LN kinds with an fp32 x and W: out (M, N_out) fp32 = EPI(LN(x) . W^T + b),
// W given as its planes (HiLo, csrc/split_hilo.cu); the persistent grid of
// ln_hilo_kernel
template <int KIND, int BN, int STAGES>
inline int launch_ln_hilo(const float* x, const float* gamma, const float* beta, const HiLo* w,
                          const float* bias, float* out, int M, int C, int N_out, float eps,
                          cudaStream_t stream) {
  constexpr int smem = hilo_plan<BN, STAGES>().total;
  static_assert(smem <= SMEM_LIMIT, "the rings fit a block's shared memory");
  // C <= MAX_C: row_stats holds MAX_CH chunks of a row a lane
  if (C % BK != 0 || C > MAX_C || N_out % 8 != 0 || M <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_x, map_w;
  int err = tensor_map(x, M, C, BM, &map_x);
  if (!err) err = weight_map(w, N_out, C, BN, &map_w);
  if (err) return err;
  static int allowed = 0;
  auto* kernel = ln_hilo_kernel<KIND, BN, STAGES>;
  if ((err = allow_smem(kernel, smem, allowed))) return err;
  const int tiles = ((N_out + BN - 1) / BN) * ((M + BM - 1) / BM);
  const int sms = sm_count();
  const int grid = tiles < sms ? tiles : sms;
  kernel<<<grid, THREADS, smem, stream>>>(map_x, map_w, x, gamma, beta, bias, out, M, C, N_out,
                                          eps);
  return 0;
}


// The large-M body's tile width for (M, N_out), up to `widest`: the fewest
// rounds of tiles over the SMs times the width (a round's time grows with
// the width), the widest on a tie (fewer passes over A), or with
// narrow_on_tie the narrowest. The C-wide outputs of fc2 and proj_residual,
// whose K runs in parts (two accumulator sets: at 192 columns ptxas keeps
// part of them on the stack), took the narrower width on their tie of
// rounds on one H100 (tools/gemm_ab.py --mlp/--proj at B=16, N=361, the
// only such tie of their shapes: fc2 63.2 us at 128 against 68.2 at 192,
// proj_residual 44.6 against 53.6); ln_qkv's 3C-wide output keeps the
// widest.
inline int pick_bn(int M, int N_out, int widest, bool narrow_on_tie = false) {
  const int sms = sm_count();
  const long long rows = (M + LBM - 1) / LBM;
  auto cost = [&](int bn) { return (rows * ((N_out + bn - 1) / bn) + sms - 1) / sms * bn; };
  int best = widest;
  for (int bn : {192, 128})
    if (bn < widest && (cost(bn) < cost(best) || (narrow_on_tie && cost(bn) == cost(best))))
      best = bn;
  return best;
}

template <int KIND, typename TO, int BN, int STAGES, bool SCALE = false, bool ALO = false,
          int PARTS = 1, bool ERF = false>
inline int launch_large_m_bn(const bf16* a, const bf16* w, const float* wscale,
                             const float* bias, TO* out, int M, int K, int N_out,
                             cudaStream_t stream, const TO* resid) {
  using P = LargeMPlan<KIND, TO, BN, STAGES, ALO>;
  static_assert(P::total <= SMEM_LIMIT, "the ring and the staging fit a block's shared memory");
  CUtensorMap map_a, map_w, map_out;
  int err = tensor_map(a, M, ALO ? 2 * K : K, LBM, &map_a);
  if (!err) err = tensor_map(w, N_out, K, BN, &map_w);
  if (!err) err = store_map(out, M, N_out, &map_out);
  if (err) return err;
  static int allowed = 0;
  auto* kernel = large_m_kernel<KIND, TO, BN, STAGES, SCALE, ALO, PARTS, ERF>;
  if ((err = allow_smem(kernel, P::total, allowed))) return err;
  const int tiles = ((N_out + BN - 1) / BN) * ((M + LBM - 1) / LBM);
  const int sms = sm_count();
  const int grid = tiles < sms ? tiles : sms;
  kernel<<<grid, LM_THREADS, P::total, stream>>>(map_a, map_w, map_out, wscale, bias, resid, M,
                                                 K, N_out);
  return 0;
}

// The large-M body: GEMM_F32OUT, out (M, N_out) fp32 = A . W^T (+ b; bias
// may be null); LN_BIAS_GELU, out (M, N_out) bf16 = gelu(A . W^T + b), A the
// rows ln_rows_kernel normalized; LN_BIAS, out (M, N_out) = TO(A . W^T (* s)
// + b), s (SCALE) an int8 W's per-row scale, A (ALO) the hi | lo halves of
// fp32 rows, (M, 2K), with an fp32 out; LM_RESIDUAL, out (M, N_out) =
// resid + TO(A . W^T (* s) + b), resid the residual x (M, N_out) in TO. A
// (M, K), W (N_out, K) bf16. PARTS > 1: K summed in PARTS parts added in
// order (the 64-row body's split-K order: fc2 and proj_residual give its
// bits); ERF: the 64-row body's GELU (the kernel's fc1). The tile width is
// pick_bn's: 128, 192 or 256 (LN_BIAS_GELU and PARTS > 1: 128 or 192), ties
// to the narrower width for PARTS > 1.
template <int KIND, typename TO, bool SCALE = false, bool ALO = false, int PARTS = 1,
          bool ERF = false>
inline int launch_large_m(const bf16* a, const bf16* w, const float* wscale, const float* bias,
                          TO* out, int M, int K, int N_out, cudaStream_t stream,
                          const TO* resid = nullptr) {
  if (K % BK != 0 || K <= 0 || N_out % 8 != 0 || M <= 0 || (KIND != GEMM_F32OUT && !bias) ||
      (SCALE && !wscale) || ((KIND == LM_RESIDUAL) != (resid != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  // two accumulator sets (PARTS > 1) leave no registers for 256 columns
  constexpr int WIDEST = KIND == LN_BIAS_GELU || PARTS > 1 ? 192 : 256;
  const int bn = pick_bn(M, N_out, WIDEST, PARTS > 1);
  // four stages of 32 or 40 KB at BN = 128 or 192, three of 48 KB at 256,
  // beside 64 KB of staging (a bf16 LN_BIAS or LM_RESIDUAL out stages 2 x
  // 64 x BN bf16, at most the same 64 KB); LN_BIAS_GELU's 96 KB of staging
  // leave room for four at 128, three at 192; ALO's stages hold two A tiles
  // (32 KB), so three at 128, two at 192 and 256
  constexpr bool GELU = KIND == LN_BIAS_GELU;
  if (bn == 128)
    return launch_large_m_bn<KIND, TO, 128, ALO ? 3 : 4, SCALE, ALO, PARTS, ERF>(
        a, w, wscale, bias, out, M, K, N_out, stream, resid);
  if (bn == 192)
    return launch_large_m_bn<KIND, TO, 192, GELU ? 3 : ALO ? 2 : 4, SCALE, ALO, PARTS, ERF>(
        a, w, wscale, bias, out, M, K, N_out, stream, resid);
  if constexpr (WIDEST == 256) {
    if (bn == 256)
      return launch_large_m_bn<KIND, TO, 256, ALO ? 2 : 3, SCALE, ALO, PARTS, ERF>(
          a, w, wscale, bias, out, M, K, N_out, stream, resid);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// y (M, C) bf16 = LN(x) of x (M, C) bf16 or fp32 (ln_rows_kernel); HILO:
// y (M, 2C), the hi | lo halves of each fp32 normalized row
template <typename TX, bool HILO = false>
inline int launch_ln_rows(const TX* x, const float* gamma, const float* beta, bf16* y, int M,
                          int C, float eps, cudaStream_t stream) {
  if (C % 8 != 0 || C > MAX_C || M <= 0) return static_cast<int>(cudaErrorInvalidValue);
  ln_rows_kernel<TX, HILO><<<(M + 7) / 8, 256, 0, stream>>>(x, gamma, beta, y, M, C, eps);
  return 0;
}

// y (M, 2K) bf16 = the hi | lo halves of the fp32 rows of a (M, K)
// (split_rows_kernel)
inline int launch_split_rows(const float* a, bf16* y, int M, int K, cudaStream_t stream) {
  if (K % 8 != 0 || K <= 0 || M <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t threads = static_cast<size_t>(M) * (K / 8);
  split_rows_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(a, y, M, K);
  return 0;
}

// out (n,) bf16 = the int8 payload w (n,), exact (i8_to_bf16_kernel)
inline int launch_i8_to_bf16(const int8_t* w, bf16* out, size_t n, cudaStream_t stream) {
  if (n % 16 != 0 || n == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t threads = n / 16;
  i8_to_bf16_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(w, out, n);
  return 0;
}

}  // namespace
}  // namespace sm90
}  // namespace uvl
