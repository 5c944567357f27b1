// The TMA + wgmma GEMM core of the port's bf16-weight products on Hopper
// (sm_90a): the LayerNorm-fused qkv projection of csrc/ln_qkv.cu (kernel #1's
// prefix, uvltrack_tpu/ops/pallas_attention.py::_ln_qkv_attn_kernel :167) and
// both launches of csrc/ln_mlp.cu (kernel #7, _ln_mlp_kernel :551).
//
//   out[m, n] = bf16( EPI( sum_k A[m, k] * W[n, k] + b[n] ) )      fp32 acc
//
// W is a Linear-layout (N_out, K) bf16 weight, K-major. Three kinds:
//   - LN_BIAS (ln_qkv) and LN_BIAS_GELU (ln_fc1_gelu): A = bf16(LN(x)), K = C;
//     EPI is the identity or the erf GELU;
//   - SPLITK_BIAS (fc2_bias): A is the bf16 hidden tensor (M, F), K = F.
//
// One block computes a 64 x BN output tile with NC = 2 consumer warpgroups
// (each a 64 x BN/2 half with wgmma.mma_async m64n{BN/2}k16, bf16 in, fp32
// accumulators in registers) and one producer warp. The producer streams
// 64-deep k-tiles of W by TMA (cp.async.bulk.tensor, 128-byte swizzle) into
// a ring of STAGES shared-memory stages guarded by full/empty mbarriers, so
// up to STAGES loads are in flight while the tensor cores run; the old
// kernels (one stage, WMMA mma.sync, two __syncthreads a 32-deep step)
// paid one device-memory latency a k-step, 24 for K=768 and 96 for
// K=3072, which is what held them at 80-98 us against 2-3 us of bound.
//
// A operand:
//   - LN kinds: the consumers compute each row's statistics once (fp32,
//     flax's fast variance clamped at 0, the contract of common.cuh's
//     ln_stats) from 16-byte vector loads of x, and write the normalized rows,
//     rounded once to bf16, into shared memory in the swizzled K-major layout
//     wgmma reads: C/64 tiles of 64 x 64 (96 KB at C=768, 128 KB at C=1024),
//     while the producer already fills the ring. The normalized rows never
//     reach device memory, and no k-step reloads x.
//   - SPLITK_BIAS: TMA tiles of the hidden tensor beside the W tiles. With
//     only (M/64)(C/BN) output tiles (24 at M=361, C=768, BN=192), K is split
//     over a thread-block cluster of SPLIT blocks (4 x 768 at F=3072); each
//     leaves its fp32 partial tile in its shared memory, and block r of the
//     cluster sums rows 16r..16r+15 over the SPLIT partials through
//     distributed shared memory in rank order 0, 1, 2, 3: the same output on
//     every run (no atomics).
//
// Rows past M: TMA zero-fills the hidden tensor's rows past M, the LN
// prologue writes zero rows, and the epilogue stores nothing there; columns
// past N_out (a tail tile) are zero-filled the same way and not stored.
//
// Host side: each operand's TMA descriptor (cuTensorMapEncodeTiled, linked
// from libcuda with -lcuda) is encoded once per (pointer, rows, columns, box
// rows) and cached, so the weights' descriptors cost no host time after the
// first call; it goes to the kernel as a __grid_constant__ parameter.
// Dynamic shared memory above 48 KB is opted into with cudaFuncSetAttribute,
// once per instantiation and size. Every launch returns cudaGetLastError().
#pragma once

#include <cuda.h>

#include <cstring>
#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

namespace uvl {
namespace sm90 {

enum Kind { LN_BIAS = 0, LN_BIAS_GELU = 1, SPLITK_BIAS = 2 };

constexpr int BM = 64;              // output rows per block (one wgmma M)
constexpr int BK = 64;              // k-tile depth: 64 bf16 = one 128-byte swizzle row
constexpr int NC = 2;               // consumer warpgroups
constexpr int CONSUMERS = NC * 128;
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int A_TILE_BYTES = BM * BK * 2;  // 8 KB
constexpr int MAX_C = 1024;         // LN kinds: 64 rows of C bf16 in shared memory

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

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a, uint64_t b) {
  if constexpr (N == 64)
    wgmma_n64(d, a, b);
  else
    wgmma_n96(d, a, b);
}

// ------------------------------------------------------ the LN prologue
// Rows m0..m0+63 of x (M, C) -> bf16(LN(x)) in shared memory as C/64
// swizzled 64 x 64 k-tiles (a_smem, 1024-byte aligned): the byte of element
// (r, k) is (k/64)*8192 + r*128 + (((k%64)/8) ^ (r%8))*16 + (k%8)*2, the
// layout TMA's SWIZZLE_128B gives a 64 x 64 box. Each lane owns the 16-byte
// output chunks ch = lane + 32j of every row (8 values each), so its gamma
// and beta stay in registers; a warp normalizes two rows at a time, each
// row read once with 16-byte loads. Rows past M are zero.
constexpr int MAX_CH = MAX_C / 256;  // chunks a lane owns in a row

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

template <typename TX>
__device__ __forceinline__ void ln_rows_to_smem(const TX* __restrict__ x,
                                                const float* __restrict__ gamma,
                                                const float* __restrict__ beta, int m0, int M,
                                                int C, float eps, uint8_t* a_smem, int ctid) {
  constexpr int RPI = 2;  // rows a warp normalizes at a time
  const int warp = ctid >> 5;
  const int lane = ctid & 31;
  const int nch = C / 8;
  float g[MAX_CH][8], be[MAX_CH][8];
#pragma unroll
  for (int j = 0; j < MAX_CH; ++j) {
    const int ch = lane + 32 * j;
    if (ch < nch) {
      load8(gamma + ch * 8, g[j]);
      load8(beta + ch * 8, be[j]);
    }
  }
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
      const int r = r0 + i;
      const bool live = m0 + r < M;
      const float sum = warp_sum(s[i]);
      const float sumsq = warp_sum(ss[i]);
      const float mean = sum / C;
      const float var = fmaxf(sumsq / C - mean * mean, 0.f);
      const float rstd = 1.f / sqrtf(var + eps);
#pragma unroll
      for (int j = 0; j < MAX_CH; ++j) {
        const int ch = lane + 32 * j;
        if (ch < nch) {
          uint32_t packed[4];
#pragma unroll
          for (int e = 0; e < 8; e += 2) {
            float y0 = 0.f, y1 = 0.f;
            if (live) {
              y0 = (v[i][j][e] - mean) * rstd;
              y0 = y0 * g[j][e] + be[j][e];
              y1 = (v[i][j][e + 1] - mean) * rstd;
              y1 = y1 * g[j][e + 1] + be[j][e + 1];
            }
            const __nv_bfloat162 p = __floats2bfloat162_rn(y0, y1);
            packed[e / 2] = *reinterpret_cast<const uint32_t*>(&p);
          }
          const int off = (ch >> 3) * A_TILE_BYTES + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
          *reinterpret_cast<uint4*>(a_smem + off) =
              make_uint4(packed[0], packed[1], packed[2], packed[3]);
        }
      }
    }
  }
}

// ------------------------------------------------------------ the kernel
// Grid (ceil(N_out / BN), ceil(M / 64), SPLIT); SPLITK_BIAS runs as clusters
// of SPLIT blocks along z. x/A: LN kinds read x (TX) directly; SPLITK_BIAS
// reads A through map_a. W through map_b. out (M, N_out) bf16.
template <int KIND, typename TX, int BN, int STAGES, int SPLIT>
__device__ __forceinline__ void gemm_body(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                          const TX* __restrict__ x,
                                          const float* __restrict__ gamma,
                                          const float* __restrict__ beta,
                                          const float* __restrict__ bias, bf16* __restrict__ out,
                                          int M, int K, int N_out, float eps) {
  constexpr bool LN = KIND != SPLITK_BIAS;
  constexpr int WN = BN / NC;                 // columns of one consumer warpgroup
  constexpr int B_STAGE_BYTES = BN * BK * 2;  // one W k-tile
  constexpr uint32_t TX_BYTES = B_STAGE_BYTES + (LN ? 0 : A_TILE_BYTES);
  static_assert(WN % 8 == 0 && (WN == 64 || WN == 96), "a warpgroup takes n64 or n96");

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int kt_total = K / BK / SPLIT;  // k-tiles of this block
  uint8_t* a_smem = base;               // LN: all C/64 tiles; else the A ring
  uint8_t* b_ring = base + (LN ? (K / BK) * A_TILE_BYTES : STAGES * A_TILE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(b_ring + STAGES * B_STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int rank = SPLIT > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int kt0 = rank * kt_total;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[WN / 2];
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = 0.f;
  const int wg = tid / 128;

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
        tma_load_2d(smem_u32(b_ring + s * B_STAGE_BYTES), map_b, k, n0, bar);
        if constexpr (!LN) tma_load_2d(smem_u32(a_smem + s * A_TILE_BYTES), map_a, k, m0, bar);
      }
    }
    __syncwarp();
  } else {
    // ---- consumer warpgroups
    if constexpr (LN) {
      ln_rows_to_smem(x, gamma, beta, m0, M, K, eps, a_smem, tid);
      // the generic-proxy stores must be visible to wgmma's async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_barrier_sync(1, CONSUMERS);
    }
    for (int kt = 0; kt < kt_total; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(smem_u32(full + s), (kt / STAGES) & 1);
      const uint32_t a0 = smem_u32(a_smem + (LN ? kt : s) * A_TILE_BYTES);
      const uint32_t b0 = smem_u32(b_ring + s * B_STAGE_BYTES + wg * WN * 128);
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma<WN>(acc, desc_sw128(a0 + kk * 32), desc_sw128(b0 + kk * 32));
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(acc);
      mbar_arrive(smem_u32(empty + s));
    }
  }

  // accumulator fragment of thread t of warpgroup wg: register i holds
  // row (t/32)*16 + (t%32)/4 + 8*((i/2)%2), column wg*WN + (i/4)*8 + (t%4)*2 + i%2
  const int t = tid % 128;
  const int frow = (t / 32) * 16 + (t % 32) / 4;
  const int fcol = wg * WN + (t % 4) * 2;

  if constexpr (SPLIT == 1) {
    if (tid < CONSUMERS) {
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
        const int col = n0 + fcol + j * 8;
        if (col >= N_out) continue;
        const float2 b = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + frow + 8 * h;
          if (row >= M) continue;
          float v0 = __fadd_rn(acc[4 * j + 2 * h], b.x);
          float v1 = __fadd_rn(acc[4 * j + 2 * h + 1], b.y);
          if constexpr (KIND == LN_BIAS_GELU) {
            v0 = gelu_erf(v0);
            v1 = gelu_erf(v1);
          }
          *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row) * N_out + col) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  } else {
    // split-K: each block's fp32 partial tile (64 x BN, row stride BN+4)
    // over its own ring, once every consumer is done with the ring
    constexpr int LDP = BN + 4;
    float* part = reinterpret_cast<float*>(base);
    static_assert(BM * LDP * 4 <= STAGES * (A_TILE_BYTES + B_STAGE_BYTES), "partials fit the ring");
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
    // block `rank` sums rows rank*16 .. rank*16+15 over the SPLIT partials,
    // in rank order
    constexpr int ROWS = BM / SPLIT;
    const uint32_t part0 = smem_u32(part);
    for (int e = tid; e < ROWS * (BN / 4); e += THREADS) {
      const int r = rank * ROWS + e / (BN / 4);
      const int c = (e % (BN / 4)) * 4;
      const uint32_t addr = part0 + (r * LDP + c) * 4;
      float4 sum = ld_cluster_f4(addr, 0);
#pragma unroll
      for (int q = 1; q < SPLIT; ++q) {
        const float4 p = ld_cluster_f4(addr, q);
        sum.x += p.x;
        sum.y += p.y;
        sum.z += p.z;
        sum.w += p.w;
      }
      const int row = m0 + r;
      const int col = n0 + c;
      if (row < M && col < N_out) {
        const float4 b = *reinterpret_cast<const float4*>(bias + col);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(__fadd_rn(sum.x, b.x), __fadd_rn(sum.y, b.y));
        const __nv_bfloat162 hi = __floats2bfloat162_rn(__fadd_rn(sum.z, b.z), __fadd_rn(sum.w, b.w));
        uint2 pk;
        pk.x = *reinterpret_cast<const uint32_t*>(&lo);
        pk.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(out + static_cast<size_t>(row) * N_out + col) = pk;
      }
    }
    cluster_sync();  // no block leaves while another reads its partials
  }
}

template <int KIND, typename TX, int BN, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
ln_gemm_kernel(const __grid_constant__ CUtensorMap map_b, const TX* __restrict__ x,
               const float* __restrict__ gamma, const float* __restrict__ beta,
               const float* __restrict__ bias, bf16* __restrict__ out, int M, int K, int N_out,
               float eps) {
  gemm_body<KIND, TX, BN, STAGES, 1>(nullptr, &map_b, x, gamma, beta, bias, out, M, K, N_out,
                                     eps);
}

template <int BN, int STAGES, int SPLIT>
__global__ void __cluster_dims__(1, 1, SPLIT) __launch_bounds__(THREADS, 2)
splitk_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b, const float* __restrict__ bias,
                   bf16* __restrict__ out, int M, int K, int N_out) {
  gemm_body<SPLITK_BIAS, bf16, BN, STAGES, SPLIT>(&map_a, &map_b, nullptr, nullptr, nullptr,
                                                  bias, out, M, K, N_out, 0.f);
}

// --------------------------------------------------------------- host side
// The TMA descriptor of a row-major (rows, cols) bf16 matrix read in boxes
// of box_rows x 64 with the 128-byte swizzle, encoded once per key and
// cached (weights never move; an activation's key repeats whenever the
// allocator hands its buffer out again).
inline int tensor_map(const void* ptr, uint64_t rows, uint64_t cols, uint32_t box_rows,
                      CUtensorMap* map) {
  using Key = std::tuple<uintptr_t, uint64_t, uint64_t, uint32_t>;
  static std::mutex mu;
  static std::map<Key, CUtensorMap> cache;
  const Key key{reinterpret_cast<uintptr_t>(ptr), rows, cols, box_rows};
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it == cache.end()) {
    CUtensorMap m;
    const cuuint64_t dims[2] = {cols, rows};
    const cuuint64_t strides[1] = {cols * 2};
    const cuuint32_t box[2] = {BK, box_rows};
    const cuuint32_t elem[2] = {1, 1};
    const CUresult r = cuTensorMapEncodeTiled(
        &m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
        elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
    it = cache.emplace(key, m).first;
  }
  std::memcpy(map, &it->second, sizeof(CUtensorMap));
  return 0;
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

// LN kinds: out (M, N_out) = EPI(bf16(LN(x)) . W^T + b); W (N_out, C) bf16
template <int KIND, typename TX, int BN, int STAGES>
inline int launch_ln_gemm(const TX* x, const float* gamma, const float* beta, const bf16* w,
                          const float* bias, bf16* out, int M, int C, int N_out, float eps,
                          cudaStream_t stream) {
  if (C % BK != 0 || C > MAX_C || N_out % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 1024 + (C / BK) * A_TILE_BYTES + STAGES * BN * BK * 2 + 2 * STAGES * 8;
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_b;
  int err = tensor_map(w, N_out, C, BN, &map_b);
  if (err) return err;
  static int allowed = 0;
  auto* kernel = ln_gemm_kernel<KIND, TX, BN, STAGES>;
  if ((err = allow_smem(kernel, smem, allowed))) return err;
  const dim3 grid((N_out + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, THREADS, smem, stream>>>(map_b, x, gamma, beta, bias, out, M, C, N_out, eps);
  return static_cast<int>(cudaGetLastError());
}

// out (M, N_out) = bf16(A . W^T + b); A (M, K) bf16, W (N_out, K) bf16,
// K split over a cluster of SPLIT blocks
template <int BN, int STAGES, int SPLIT>
inline int launch_splitk_gemm(const bf16* a, const bf16* w, const float* bias, bf16* out, int M,
                              int K, int N_out, cudaStream_t stream) {
  if (K % (BK * SPLIT) != 0 || N_out % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 1024 + STAGES * (A_TILE_BYTES + BN * BK * 2) + 2 * STAGES * 8;
  CUtensorMap map_a, map_b;
  int err = tensor_map(a, M, K, BM, &map_a);
  if (!err) err = tensor_map(w, N_out, K, BN, &map_b);
  if (err) return err;
  static int allowed = 0;
  auto* kernel = splitk_gemm_kernel<BN, STAGES, SPLIT>;
  if ((err = allow_smem(kernel, smem, allowed))) return err;
  const dim3 grid((N_out + BN - 1) / BN, (M + BM - 1) / BM, SPLIT);
  kernel<<<grid, THREADS, smem, stream>>>(map_a, map_b, bias, out, M, K, N_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace uvl
