// The hi and lo bf16 planes of an fp32 weight: the pre-pass of the GEMM
// core's fp32-weight mode (csrc/gemm_sm90.cuh, HiLo). It replaces no TPU
// kernel: on a TPU the Pallas kernels and XLA take an fp32 weight as it is.
// The port runs fp32 products as bf16 tensor-core passes (no TF32), so an
// fp32 weight has to be split, w = hi + lo + r with |r| <= 2^-17 |w|
// (split_bf16 in common.cuh: hi = bf16_rn(w), lo = bf16_rn(w - hi)). Doing it
// here, once per weight, and caching the planes (ops/hilo.py) lets every
// product launch stream both planes by TMA in the swizzle wgmma reads, where
// the kernels before split every W tile in shared memory in every row block
// of every launch (6 times a W value at B=1, 46 at B=8), with the products
// waiting on it.
//
//   hi[i] = bf16_rn(w[i]),  lo[i] = bf16_rn(w[i] - hi[i])
//
// Layouts: w (n,) fp32 contiguous (any shape flattened); planes (2, n) bf16,
// hi then lo. Bound on the H100: 4 bytes read and 4 written a value; for
// UVLTrack-B's qkv weight 7.08 MB read + 7.08 MB written (~4.2 us at 3.35
// TB/s), once per weight. A grid-stride loop of 256-thread blocks, each thread 8 values a step (two
// 16-byte loads, two 16-byte stores): a copy, bound by the bytes.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256) split_hilo_kernel(const float4* __restrict__ w,
                                                         uint4* __restrict__ hi,
                                                         uint4* __restrict__ lo, long long n8) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n8;
       i += static_cast<long long>(gridDim.x) * 256) {
    const float4 a = w[2 * i], b = w[2 * i + 1];
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uvl::bf16 h0, l0, h1, l1;
      uvl::split_bf16(v[2 * e], h0, l0);
      uvl::split_bf16(v[2 * e + 1], h1, l1);
      const __nv_bfloat162 hp(h0, h1), lp(l0, l1);
      h[e] = *reinterpret_cast<const uint32_t*>(&hp);
      l[e] = *reinterpret_cast<const uint32_t*>(&lp);
    }
    hi[i] = make_uint4(h[0], h[1], h[2], h[3]);
    lo[i] = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

}  // namespace

// w: n fp32 values; planes: 2n bf16 (hi, then lo). Requires n % 8 == 0 and
// 16-byte aligned w and planes (checked by the Python wrapper).
extern "C" int uvl_split_hilo(const float* w, void* planes, long long n, void* stream) {
  if (n <= 0 || n % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n8 = n / 8;
  uvl::bf16* hi = static_cast<uvl::bf16*>(planes);
  const long long want = (n8 + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 8 ? want : 132 * 8);
  split_hilo_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(w), reinterpret_cast<uint4*>(hi),
      reinterpret_cast<uint4*>(hi + n), n8);
  return static_cast<int>(cudaGetLastError());
}
