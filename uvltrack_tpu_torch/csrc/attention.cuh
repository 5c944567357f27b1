// The masked-attention body of the port on Hopper (sm_90a), shared by
// csrc/qkv_attention.cu and csrc/attention.cu. It replaces the math of
// uvltrack_tpu/ops/pallas_attention.py::_attn_kernel (:78, kernel #3) and
// _attn_kernel_qkv (:119, kernel #2, also the attention half of
// _ln_qkv_attn_kernel :167, _ln_qkv_attn_proj_kernel :291 and, in x's dtype,
// of _ln_qkv_attn_kernel_q8 :433 and _ln_qkv_attn_proj_kernel_q8 :489), which
// differ only in where q, k and v live. Two instantiations:
//   - attention_bf16_kernel: bf16 q, k, v and out; one bf16 pass a product;
//   - qkv_attention_f32_kernel: fp32 q, k, v and out (the int8 kernels'
//     attention in the fp32 joint blocks), where nothing is rounded to bf16.
//
//   e   = exp(clip(q . k * D^-1/2 + key_bias, -80, 80))   fp32, no max
//         subtraction: the clamp keeps exp finite and turns the -1e10 ViT /
//         -10000 BERT mask bias into e^-80 (an all-masked row averages v)
//   out = (T(e) . v) * (1 / sum_k e)                       the sum over the
//         unrounded fp32 e, the division last; T(e) is bf16(e) in the bf16
//         body and e itself in the fp32 one
//
// q, k, v: element (b, n, h, d) at base + b*sb + n*sn + h*sh + d, the same
// strides for all three (a fused qkv row, or BERT's (B, N, H*D) products
// viewed head-major); key_bias (B, N) fp32; out (B, N, H, D) contiguous in
// the input's type. D = 64.
//
// Bound on the H100 at the tracking step's shapes (B=1, H=12, N=321/361):
// 0.40 GFLOP of bf16 tensor-core work (three hi/lo passes, 1.20 GFLOP, in
// fp32) against 1.7-2.2 MB of bf16 (3.3-4.4 MB of fp32) in and out: 0.59 /
// 0.66 us bf16, 1.32 us fp32, all bytes. A block does a handful of 64-key
// tiles, so what costs is latency: the launch and a load round trip, then a
// chain of dependent products and exps a tile.
//
// Design: one block is one consumer warpgroup owning 64 query rows (one
// wgmma M) of one head, plus one producer warp. The producer brings Q once
// and the block's 64-key tiles of K and V by TMA (4-D tensor maps over (d, n,
// h, b): rows past N are zero-filled, never the next batch element's) into
// a ring of STAGES stages guarded by full/empty mbarriers, so the next
// tiles are in flight while the tensor cores work on this one; the
// consumers fetch each tile's key bias into registers a tile ahead. Per
// tile:
//   - S = Q K^T: wgmma.m64n64k16 from shared memory, Q and K K-major in the
//     128-byte-swizzled layout (a bf16 row of D = 64 is one swizzle row);
//   - the clamp, the exp (expf: the plain versions' function), the mask of
//     keys past N (explicitly, e = 0, selected after the exp: a branch
//     around each exp serialized the 32 of a tile and cost 5x) and the fp32
//     row sums run on the accumulator registers;
//   - O += T(e) V with the register-A form of wgmma: the m64n64 accumulator
//     of S, read k16 slice by k16 slice, is the A fragment, packed pairwise
//     into bf16x2; V is the B operand read MN-major (its rows run along D),
//     through the transpose bit of wgmma on the same swizzled tile.
// The fp32 body runs every product fp32-accurately as bf16 hi/lo passes
// (split_bf16: |y - hi - lo| <= 2^-17 |y|), never TF32: Q and each K/V tile
// are split in place when they land (the fp32 tile's 16 KB hold its two
// bf16 halves),
//   S = Qhi.Khi + Qhi.Klo + Qlo.Khi,   O += Ehi.Vhi + Ehi.Vlo + Elo.Vhi,
// with e split in registers.
// At batch 1 the 64-row tiles give only 6 x 12 = 72 blocks at N=321/361, so
// the keys may be split over a thread-block cluster of SPLIT blocks (a
// rank's tiles are a contiguous key range; choose_split picks it). With the
// clamp in place of a running max, partial O and row sums over disjoint keys
// simply add: each rank leaves its fp32 partials in its shared memory, and
// rank r sums its share of the 64 rows over the SPLIT partials through
// distributed shared memory, in rank order 0, 1, ...: the same output on
// every run (no atomics). Rows past N are not stored.
//
// At B.N rows (a lockstep or training step: tiles.H.B blocks) the rule, timed
// at B=1, still picks a split of 3 from 48 (b, h) pairs on (B-S4, B-S8, a tp
// rank's heads at B=16), and there each block does two key tiles between its
// launch, its load round trip and two cluster barriers. The batch body
// (attention_ranges_kernel, launch_attention_batch) keeps the split's order
// and drops the cluster: one block does all its query tile's keys, in the
// split's ranges, each range into a fresh fp32 O and row sums, the ranges
// added in rank order ((O_0 + O_1) + O_2, as the partials are summed through
// distributed shared memory; O's running total in shared memory, the row
// sums in registers), so its bits are the split launch's. On one H100 it
// takes 0.73-0.80 of the split launch's time at those shapes in bf16 and
// 0.73-0.87 in fp32 (PERF.md, rows 2m and 5bm).
#pragma once

#include "gemm_sm90.cuh"

namespace uvl {
namespace attn {
// internal linkage: both kernel libraries include this header, and a static
// of an inline function (a launcher's opted-in shared-memory size) would
// otherwise be one object across the loaded libraries
namespace {

using sm90::smem_u32;

constexpr int D = 64;              // head dim
constexpr int BQ = 64;             // query rows a block: one wgmma M
constexpr int BKV = 64;            // keys a tile
constexpr int CONSUMERS = 128;     // one warpgroup
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int TILE16 = BKV * D * 2;      // a 64 x 64 bf16 tile, 8 KB
constexpr int LDO = D + 4;         // fp32 partial-O row stride
constexpr float CLAMP = 80.f;
constexpr int MAX_SPLIT = 3;

// Shared-memory plan, byte offsets from the 1024-aligned base:
//   q:    the Q tile as it lands (T); fp32: then its hi and lo bf16 tiles,
//         in place
//   ring: STAGES x (K tile, V tile) as they land (T); fp32: then each
//         tile's hi and lo, in place
//   part: over the ring once every tile is consumed: the fp32 partial O (64
//         x LDO) and row sums (64) of a split
//   bar:  full[STAGES], empty[STAGES], q_full
// About 73 KB (bf16) and 81 KB (fp32): two blocks an SM either way.
template <typename T, bool RANGES = false>
struct Plan {
  static constexpr bool F32 = sizeof(T) == 4;
  // the batch body's bf16 ring has a stage less, for the range totals: at
  // 73 KB three blocks fit an SM (at 89 KB two, 1.3x slower)
  static constexpr int STAGES = F32 ? 2 : RANGES ? 3 : 4;
  static constexpr int TILE = BKV * D * static_cast<int>(sizeof(T));
  static constexpr int q = 0;
  static constexpr int ring = TILE;
  static constexpr int part = ring;
  static constexpr int rsum = part + BQ * LDO * 4;
  static constexpr int bar = ring + STAGES * 2 * TILE;
  static constexpr int total = 1024 + bar + (2 * STAGES + 1) * 8;  // + the alignment slack
  static_assert(rsum + BQ * 4 <= bar, "the partials fit over the ring");
  // the batch body: each thread's O over the ranges before the current one,
  // value e of consumer thread t at float e * CONSUMERS + t (conflict-free)
  static constexpr int tot = (bar + (2 * STAGES + 1) * 8 + 15) & ~15;
  static constexpr int total_ranges = 1024 + tot + 32 * CONSUMERS * 4;
};

// The fp32 tile at `tile` (64 rows of 64 values, 256 bytes a row, as TMA
// lands it) -> its hi and lo bf16 halves (split_bf16) in the swizzled layout
// wgmma reads, in place: hi over the first 8 KB, lo over the second. The
// 128 threads of the warpgroup (t) read all their values, four 8-value
// chunks each, before any of them writes.
__device__ __forceinline__ void split_tile_in_place(uint8_t* tile, int t) {
  float v[4][8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = t + 128 * j;
    sm90::load8(reinterpret_cast<const float*>(tile) + (i >> 3) * D + (i & 7) * 8, v[j]);
  }
  sm90::named_barrier_sync(1, CONSUMERS);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = t + 128 * j;
    const int r = i >> 3;
    sm90::store_split8(v[j], tile, tile + TILE16, r * 128 + (((i & 7) ^ (r & 7)) << 4));
  }
}

// 4-D TMA load of one box at (d, n, h, b)
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma descriptor of an MN-major, 128-byte-swizzled B operand: a [k][n]
// tile with 64 n values (one 128-byte swizzle row) a k row, 8-row groups
// 1024 bytes apart (the TMA SWIZZLE_128B layout of 64-wide bf16 rows). SBO
// is the stride between 8-row groups along k; LBO, the stride between 64-wide
// atoms along n, is never used at n = 64 and is given the same 1024 bytes.
// A k16 step advances the start address by 16 rows, 2048 bytes.
__device__ __forceinline__ uint64_t desc_sw128_mn(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// D (64 x 64, fp32) += A (64 x 16, bf16 from registers: the m64n16 slice of
// an accumulator, packed pairwise) . B, with B (16 x 64) read MN-major from
// shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_n64_rs(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// a float of block `rank`'s shared memory at this block's offset `addr`
__device__ __forceinline__ float ld_cluster_f32(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

__device__ __forceinline__ float clamped_exp(float s, float scale, float bias) {
  const float t = fminf(fmaxf(__fadd_rn(__fmul_rn(s, scale), bias), -CLAMP), CLAMP);
  return expf(t);
}

// The key bias of a consumer thread's 16 key columns of the tile at j0
// (g*8 + c0 + {0, 1}, g = 0..7); 0 past N
__device__ __forceinline__ void load_bias(const float* __restrict__ kb, int j0, int c0, int N,
                                          float (&v)[16]) {
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const int j = j0 + g * 8 + c0;
    v[2 * g] = j < N ? __ldg(kb + j) : 0.f;
    v[2 * g + 1] = j + 1 < N ? __ldg(kb + j + 1) : 0.f;
  }
}

// the row sums of rows frow and frow + 8 over the four threads that share
// them (after it every one of the four holds the same bits)
__device__ __forceinline__ void reduce_row_sums(float (&rs)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
  }
}

// ------------------------------------------------------------ the body
// Grid (ceil(N/64) * SPLIT, H, B), clusters of SPLIT blocks along x: block
// x is query tile x / SPLIT, cluster rank x % SPLIT. RANGES (the batch body,
// SPLIT 1): the block's keys in `ranges` contiguous ranges of tiles, range r
// tiles r.T/ranges .. (r+1).T/ranges - 1 (rank r's of a split of `ranges`),
// each summed from zero, the ranges added in order.
template <typename T, int SPLIT, bool RANGES = false>
__device__ __forceinline__ void attention_body(const CUtensorMap* map_q, const CUtensorMap* map_k,
                                               const CUtensorMap* map_v,
                                               const float* __restrict__ key_bias,
                                               T* __restrict__ out, int N, int H, float scale,
                                               int ranges = 1) {
  static_assert(SPLIT == 1 || !RANGES, "the ranges of a split are its ranks");
  using P = Plan<T, RANGES>;
  constexpr bool F32 = P::F32;
  constexpr int STAGES = P::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + P::bar);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;

  const int tid = threadIdx.x;
  const int rank = SPLIT > 1 ? static_cast<int>(sm90::cluster_rank()) : 0;
  const int q0 = (blockIdx.x / SPLIT) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tiles = (N + BKV - 1) / BKV;
  const int tile0 = rank * tiles / SPLIT;  // this rank's key tiles: tile0 ..
  const int ntiles = (rank + 1) * tiles / SPLIT - tile0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(smem_u32(full + s), 1);
      sm90::mbar_init(smem_u32(empty + s), CONSUMERS);
    }
    sm90::mbar_init(smem_u32(q_full), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // consumer thread t's accumulator fragment: register i holds row
  // (t/32)*16 + (t%32)/4 + 8*((i/2)%2), column (i/4)*8 + (t%4)*2 + i%2
  const int t = tid;
  const int frow = (t >> 5) * 16 + ((t & 31) >> 2);
  const int fcol = (t & 3) * 2;
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float rs[2] = {0.f, 0.f};  // rows frow and frow + 8

  if (tid >= CONSUMERS) {
    // ---- producer warp: one lane brings Q once, then keeps the rank's
    // K/V tiles in flight
    if (tid == CONSUMERS) {
      const uint32_t qb = smem_u32(q_full);
      sm90::mbar_expect_tx(qb, P::TILE);
      tma_load_4d(smem_u32(base + P::q), map_q, 0, q0, h, b, qb);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) sm90::mbar_wait(smem_u32(empty + s), (it / STAGES - 1) & 1);
        const uint32_t bar = smem_u32(full + s);
        uint8_t* kt = base + P::ring + s * 2 * P::TILE;
        sm90::mbar_expect_tx(bar, 2 * P::TILE);
        tma_load_4d(smem_u32(kt), map_k, 0, (tile0 + it) * BKV, h, b, bar);
        tma_load_4d(smem_u32(kt + P::TILE), map_v, 0, (tile0 + it) * BKV, h, b, bar);
      }
    }
    __syncwarp();
  } else {
    // ---- the consumer warpgroup
    const float* kb = key_bias + static_cast<size_t>(b) * N;
    float kbias[16], next[16];  // this tile's key bias and the next one's
    load_bias(kb, tile0 * BKV, fcol, N, next);
    sm90::mbar_wait(smem_u32(q_full), 0);
    const uint32_t q_hi = smem_u32(base + P::q);
    const uint32_t q_lo = q_hi + TILE16;
    if constexpr (F32) split_tile_in_place(base + P::q, t);
    // RANGES: the sums of the ranges before the current one (O's in shared
    // memory: in registers it took two blocks an SM to one)
    float* tot = reinterpret_cast<float*>(base + P::tot) + t;
    float den[2];
    int range = 0, range_end = tiles / ranges;  // the current range's end
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % STAGES;
      const int j0 = (tile0 + it) * BKV;
      if constexpr (RANGES) {
        if (it == range_end) {  // a range starts: the last one's sums into the totals
          range_end = (++range + 1) * tiles / ranges;
          reduce_row_sums(rs);
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            tot[e * CONSUMERS] = range == 1 ? o[e] : tot[e * CONSUMERS] + o[e];
            o[e] = 0.f;
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            den[r] = range == 1 ? rs[r] : den[r] + rs[r];
            rs[r] = 0.f;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) kbias[i] = next[i];
      if (it + 1 < ntiles) load_bias(kb, j0 + BKV, fcol, N, next);
      sm90::mbar_wait(smem_u32(full + s), (it / STAGES) & 1);
      uint8_t* kt = base + P::ring + s * 2 * P::TILE;
      const uint32_t k_hi = smem_u32(kt), v_hi = smem_u32(kt + P::TILE);
      const uint32_t k_lo = k_hi + TILE16, v_lo = v_hi + TILE16;  // fp32 only
      if constexpr (F32) {
        split_tile_in_place(kt, t);
        split_tile_in_place(kt + P::TILE, t);
        // the generic-proxy stores must be visible to wgmma's async proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        sm90::named_barrier_sync(1, CONSUMERS);
      }

      // S = Q K^T
      float sacc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
      sm90::fence_operands(sacc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        sm90::wgmma_n64(sacc, sm90::desc_sw128(q_hi + kk * 32), sm90::desc_sw128(k_hi + kk * 32));
        if constexpr (F32) {
          sm90::wgmma_n64(sacc, sm90::desc_sw128(q_hi + kk * 32),
                          sm90::desc_sw128(k_lo + kk * 32));
          sm90::wgmma_n64(sacc, sm90::desc_sw128(q_lo + kk * 32),
                          sm90::desc_sw128(k_hi + kk * 32));
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_operands(sacc);

      // e in registers; the A fragments of P.V, k16 slice kk in a[4kk..4kk+3]
      uint32_t a_hi[16], a_lo[F32 ? 16 : 1];
#pragma unroll
      for (int p = 0; p < 16; ++p) {
        const int i = 2 * p;
        const int col = j0 + (i / 4) * 8 + fcol;
        // every exp computed, then the keys past N selected out
        float e0 = clamped_exp(sacc[i], scale, kbias[2 * (i / 4)]);
        float e1 = clamped_exp(sacc[i + 1], scale, kbias[2 * (i / 4) + 1]);
        e0 = col < N ? e0 : 0.f;
        e1 = col + 1 < N ? e1 : 0.f;
        rs[p & 1] += e0;
        rs[p & 1] += e1;
        if constexpr (F32) {
          bf16 h0, l0, h1, l1;
          split_bf16(e0, h0, l0);
          split_bf16(e1, h1, l1);
          const __nv_bfloat162 hp(h0, h1), lp(l0, l1);
          a_hi[p] = *reinterpret_cast<const uint32_t*>(&hp);
          a_lo[p] = *reinterpret_cast<const uint32_t*>(&lp);
        } else {
          a_hi[p] = sm90::pack_bf16(e0, e1);
        }
      }

      // O += T(e) V
      sm90::fence_operands(o);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint32_t ah[4] = {a_hi[4 * kk], a_hi[4 * kk + 1], a_hi[4 * kk + 2], a_hi[4 * kk + 3]};
        wgmma_n64_rs(o, ah, desc_sw128_mn(v_hi + kk * 2048));
        if constexpr (F32) {
          const uint32_t al[4] = {a_lo[4 * kk], a_lo[4 * kk + 1], a_lo[4 * kk + 2],
                                  a_lo[4 * kk + 3]};
          wgmma_n64_rs(o, ah, desc_sw128_mn(v_lo + kk * 2048));
          wgmma_n64_rs(o, al, desc_sw128_mn(v_hi + kk * 2048));
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_operands(o);
      sm90::mbar_arrive(smem_u32(empty + s));  // K and V read
    }
    reduce_row_sums(rs);
    if constexpr (RANGES) {
      if (range > 0) {  // the last range after the others: ((O_0 + O_1) + O_2)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[e] = tot[e * CONSUMERS] + o[e];
#pragma unroll
        for (int r = 0; r < 2; ++r) rs[r] = den[r] + rs[r];
      }
    }
  }

  const size_t row_stride = static_cast<size_t>(H) * D;
  T* out_bh = out + static_cast<size_t>(b) * N * row_stride + static_cast<size_t>(h) * D;
  if constexpr (SPLIT == 1) {
    if (tid < CONSUMERS) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + frow + 8 * r;
        if (row >= N) continue;
        const float inv = 1.f / rs[r];
#pragma unroll
        for (int g = 0; g < 8; ++g)
          sm90::store2(out_bh + row * row_stride + g * 8 + fcol, o[4 * g + 2 * r] * inv,
                       o[4 * g + 2 * r + 1] * inv);
      }
    }
  } else {
    float* part = reinterpret_cast<float*>(base + P::part);
    float* prs = reinterpret_cast<float*>(base + P::rsum);
    if (tid < CONSUMERS) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int g = 0; g < 8; ++g)
          *reinterpret_cast<float2*>(part + (frow + 8 * r) * LDO + g * 8 + fcol) =
              make_float2(o[4 * g + 2 * r], o[4 * g + 2 * r + 1]);
        if ((t & 3) == 0) prs[frow + 8 * r] = rs[r];
      }
    }
    sm90::cluster_sync();
    // rank r sums its rows over the SPLIT partials, in rank order
    const int r_lo = rank * BQ / SPLIT;
    const int r_hi = (rank + 1) * BQ / SPLIT;
    const uint32_t part0 = smem_u32(part);
    const uint32_t prs0 = smem_u32(prs);
    for (int e = tid; e < (r_hi - r_lo) * (D / 4); e += THREADS) {
      const int r = r_lo + e / (D / 4);
      const int c = (e % (D / 4)) * 4;
      const int row = q0 + r;
      if (row >= N) continue;
      const uint32_t addr = part0 + (r * LDO + c) * 4;
      float4 sum = sm90::ld_cluster_f4(addr, 0);
      float den = ld_cluster_f32(prs0 + r * 4, 0);
#pragma unroll
      for (int k = 1; k < SPLIT; ++k) {
        const float4 p4 = sm90::ld_cluster_f4(addr, k);
        sum.x += p4.x;
        sum.y += p4.y;
        sum.z += p4.z;
        sum.w += p4.w;
        den += ld_cluster_f32(prs0 + r * 4, k);
      }
      const float inv = 1.f / den;
      sm90::store4(out_bh + row * row_stride + c,
                   make_float4(sum.x * inv, sum.y * inv, sum.z * inv, sum.w * inv));
    }
    sm90::cluster_sync();  // no block leaves while another reads its partials
  }
}

template <int SPLIT>
__global__ void __cluster_dims__(SPLIT, 1, 1) __launch_bounds__(THREADS, 2)
attention_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const float* __restrict__ key_bias, bf16* __restrict__ out, int N, int H,
                      float scale) {
  attention_body<bf16, SPLIT>(&map_q, &map_k, &map_v, key_bias, out, N, H, scale);
}

template <int SPLIT>
__global__ void __cluster_dims__(SPLIT, 1, 1) __launch_bounds__(THREADS, 2)
qkv_attention_f32_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const float* __restrict__ key_bias, float* __restrict__ out, int N, int H,
                         float scale) {
  attention_body<float, SPLIT>(&map_q, &map_k, &map_v, key_bias, out, N, H, scale);
}

// The batch body: the grid of SPLIT 1, the keys in the ranges of a split of
// `ranges` (bf16 and fp32); three bf16 blocks an SM (136 registers), two fp32
template <typename T>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 ? 3 : 2)
attention_ranges_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const float* __restrict__ key_bias, T* __restrict__ out, int N, int H,
                        float scale, int ranges) {
  attention_body<T, 1, true>(&map_q, &map_k, &map_v, key_bias, out, N, H, scale, ranges);
}

// --------------------------------------------------------------- host side
// The 4-D TMA descriptor (d, n, h, b) of q, k or v with element strides
// (1, sn, sh, sb), read in boxes of 64 keys x 64 values of one head (the
// core's cached encoder: bf16 swizzled for wgmma, fp32 unswizzled for the
// consumers' split). Rows past N are zero-filled.
template <typename T>
inline int head_map(const T* ptr, int B, int N, int H, long long sb, long long sn, long long sh,
                    CUtensorMap* map) {
  using u64 = cuuint64_t;
  constexpr u64 e = sizeof(T);
  return sm90::cached_map<T, 4>(ptr, {u64(D), u64(N), u64(H), u64(B)},
                                {u64(sn) * e, u64(sh) * e, u64(sb) * e}, {D, BKV, 1, 1}, map);
}

// The rule, a cost in key tiles a block: waves x tiles a block, plus the
// split's own cost (cluster scheduling, the partials through distributed
// shared memory, two cluster barriers) where it splits, worth 3 bf16 or 2
// fp32 tiles; a wave is two blocks on each of 132 SMs; the smaller split on a
// tie. At B=1, H=12 it picks 3 at N=321/361 (2 tiles a block) and 1 at
// BERT's N=40/128, the fastest of 1-3 at each when each split was timed
// (PERF.md, PR 8).
template <typename T>
inline int choose_split(int blocks, int tiles) {
  constexpr int slots = 2 * 132;
  constexpr int split_cost = sizeof(T) == 2 ? 3 : 2;
  int best = 1, best_cost = 0;
  for (int split = 1; split <= MAX_SPLIT && split <= tiles; ++split) {
    const int waves = (blocks * split + slots - 1) / slots;
    const int cost = waves * ((tiles + split - 1) / split) + (split > 1 ? split_cost : 0);
    if (split == 1 || cost < best_cost) {
      best = split;
      best_cost = cost;
    }
  }
  return best;
}

template <typename T, int SPLIT>
inline int launch_split(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                        const float* key_bias, T* out, int B, int N, int H, float scale,
                        cudaStream_t stream) {
  static int allowed = 0;
  auto* kernel = [] {
    if constexpr (sizeof(T) == 2)
      return attention_bf16_kernel<SPLIT>;
    else
      return qkv_attention_f32_kernel<SPLIT>;
  }();
  const int smem = Plan<T>::total;
  const int err = sm90::allow_smem(kernel, smem, allowed);
  if (err) return err;
  const dim3 grid(((N + BQ - 1) / BQ) * SPLIT, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(mq, mk, mv, key_bias, out, N, H, scale);
  return 0;
}

// q, k, v with element (b, n, h, d) at base + b*sb + n*sn + h*sh + d; out (B,
// N, H, D) contiguous. Returns a refusal (a descriptor or attribute error)
// before it launches, else 0; the caller returns cudaGetLastError().
template <typename T>
inline int launch_attention(const T* q, const T* k, const T* v, long long sb, long long sn,
                            long long sh, const float* key_bias, T* out, int B, int N, int H,
                            float scale, cudaStream_t stream) {
  if (N <= 0 || B <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  int err = head_map(q, B, N, H, sb, sn, sh, &mq);
  if (!err) err = head_map(k, B, N, H, sb, sn, sh, &mk);
  if (!err) err = head_map(v, B, N, H, sb, sn, sh, &mv);
  if (err) return err;
  const int tiles = (N + BKV - 1) / BKV;
  switch (choose_split<T>(tiles * H * B, tiles)) {
    case 1:
      return launch_split<T, 1>(mq, mk, mv, key_bias, out, B, N, H, scale, stream);
    case 2:
      return launch_split<T, 2>(mq, mk, mv, key_bias, out, B, N, H, scale, stream);
    default:
      return launch_split<T, 3>(mq, mk, mv, key_bias, out, B, N, H, scale, stream);
  }
}

// launch_attention's function on the batch body: the same operands and
// refusals; the ranges are the split choose_split gives launch_attention at
// this (B, N, H), so the bits are the same
template <typename T>
inline int launch_attention_batch(const T* q, const T* k, const T* v, long long sb, long long sn,
                                  long long sh, const float* key_bias, T* out, int B, int N,
                                  int H, float scale, cudaStream_t stream) {
  if (N <= 0 || B <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  int err = head_map(q, B, N, H, sb, sn, sh, &mq);
  if (!err) err = head_map(k, B, N, H, sb, sn, sh, &mk);
  if (!err) err = head_map(v, B, N, H, sb, sn, sh, &mv);
  if (err) return err;
  const int tiles = (N + BKV - 1) / BKV;
  static int allowed = 0;
  auto* kernel = attention_ranges_kernel<T>;
  const int smem = Plan<T, true>::total_ranges;
  err = sm90::allow_smem(kernel, smem, allowed);
  if (err) return err;
  kernel<<<dim3(tiles, H, B), THREADS, smem, stream>>>(mq, mk, mv, key_bias, out, N, H, scale,
                                                       choose_split<T>(tiles * H * B, tiles));
  return 0;
}

}  // namespace
}  // namespace attn
}  // namespace uvl
