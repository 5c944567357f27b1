"""The whole attention branch, x + proj(attention(qkv(LN x))): the CUDA port of
uvltrack_tpu/ops/pallas_attention.py::_ln_qkv_attn_proj_kernel (:291,
`fused_ln_qkv_attn_proj` :328, kernel #4, bf16 weights) and
_ln_qkv_attn_proj_kernel_q8 (:489, `fused_ln_qkv_attn_proj_q8` :520, kernel
#6, int8 weights). VitBlock takes them under UVLTRACK_FUSED_PROJ=1
(ops/attention.py::attention_block_core).

The TPU kernels keep both weights resident in VMEM, one program per batch
element. The port composes the prefix kernels of ops/ln_qkv_attention.py
(#1's `ln_qkv` + `qkv_attention`, or #5's int8 pair) with one epilogue
kernel, `proj_residual` (csrc/proj_residual.cu):

    out = x + cast_x(A . Wp^T (* scale) + b_proj)

A is the attention output: bf16 for #4 (cast to w_proj's dtype), x's dtype
for #6. The product rounds once, straight to x's dtype, then the residual
add runs in x's dtype: a bf16 x rounds twice, an fp32 x not at all. (The
composed path, attn_proj_core, rounds the projection to the compute dtype
first, so in the fp32 joint blocks the fused and the composed paths differ
by that rounding, as they do in the JAX package.) Five instantiations:
(x, A, Wp) in {bf16, bf16, bf16}, {fp32, bf16, bf16} (#4), {bf16, bf16,
int8}, {fp32, fp32, int8} (#6) and {fp32, fp32, fp32}: #4 in an
fp32-compute model (TPU.COMPUTE_DTYPE=float32), everything fp32, Wp as its
hi/lo bf16 planes cached by ops/hilo.py, three passes a product.

`proj_residual` runs on the TMA + wgmma core of csrc/gemm_sm90.cuh, on one
of two bodies by the rows M = B*N (ln_qkv_attention.takes_large_m, as
`ln_qkv`, from this module's own LARGE_M_ROWS): below it (the tracking
step's B=1 and a lockstep batch of 2) the 64-row body, with K split over
clusters of PROJ_SPLIT blocks (one 64-deep k-tile each at the least) and
summed in rank order; from it, with a bf16 or int8 weight (the B.N rows of a
lockstep or training step), the large-M entry `uvl_proj_residual_large_m`:
128-row tiles on a persistent grid, K summed in the split-K body's
PROJ_SPLIT parts in its order (so its output is that body's bit for bit),
the residual added in the epilogue, an int8 W converted to bf16 once a call
and an fp32 A written once a call as hi | lo bf16 rows. Both give the same
bits on two calls. The instantiations keep their tags; build.body_counts()
counts the bodies apart (`proj_residual[*-64]`, `proj_residual[*-lm]`). An
fp32 weight keeps the split body at every M. The wrapper checks, launches
and counts through ops/build.py, as the prefix wrappers do; a CPU tensor
takes the plain version.

Under tensor parallelism (parallel/tp.py) a rank's share of the projection,
`proj_partial`, is attn_r . Wp_r^T in fp32 before the bias and the
residual, at a training step's B.N rows: bf16 operands run the same source's
`uvl_dense` on the core's large-M body (128-row tiles on a
persistent grid, K unsplit, the fp32 output stored by TMA), tagged
proj_residual[bf16a-bf16w-fp32o].

The default path's weight products (the projection, fc1 and fc2 of every ViT
block outside the fused knobs: ops/attention.py::attn_proj_core and
ln_mlp_core) go through `dense_f32`, ops/quant.py::quant_dot's function on
the GEMM core: a . w^T in fp32 from bf16 operands, whose products are exact
in fp32, so only the order of the sum differs from the upcast cuBLAS product.
It takes the core for CUDA bf16 operands that need no gradient, with K a
multiple of 64 (`dense_fallback` says why not otherwise, and on the card
build.FALLBACKS counts it); everything else takes quant_dot. The same
source's `uvl_dense`, counted as dense[bf16a-bf16w-fp32o]: from
LARGE_M_ROWS rows the large-M body of proj_partial; below it (the
tracking step's B=1) fc1 stays there and the projection and fc2 take the
64-row body, with K split over a cluster of `dense_parts` blocks;
build.body_counts() counts the bodies apart (`dense[*-lm]`, `dense[*-64]`).
"""

from __future__ import annotations

import functools

import torch

from ..utils.costs import counted, nbytes
from . import build, hilo, library
from . import ln_qkv_attention as lqa
from .build import INT, PTR, check_cuda, grad_needed, no_grad_through, require
from .quant import QuantizedTensor, quant_dot

PROJ_SPLIT = 3  # blocks of a cluster that split K (csrc/proj_residual.cu SPLIT)
# rows M = B*N from which `proj_residual` with a bf16 or int8 weight runs on
# the large-M body (uvl_proj_residual_large_m), above ln_qkv's and ln_mlp's
# 512. Measured with tools/gemm_ab.py --proj at B in {1, 2, 3, 4, 8, 16}, N=321
# bf16 x and N=361 fp32 x (PERF.md, section 6, rows 4m and 6m): the large-M
# entry's device time is flat from B=1 to B=4 (one round of tiles: 11.3-12.2
# us with a bf16 W), the 64-row body's grows with M (6.1-6.4 us at B=1, 8.4-8.5
# at B=2, 13.6-14.1 at B=3); the 64-row body is the faster up to B=2 (M <=
# 722) and the large-M entry from B=3 (M >= 963) in all four instantiations,
# crossing at 830-940 rows by linear interpolation
LARGE_M_ROWS = 896
_OK = {  # (x, A, Wp) dtypes the kernel is instantiated for
    (torch.bfloat16, torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16, torch.int8),
    (torch.float32, torch.float32, torch.int8),
    (torch.float32, torch.float32, torch.float32),
}


def proj_residual_work(x, attn, w_proj, b_proj, wp_scale=None):
    """(FLOPs, bytes) of one projection + residual (utils/costs.py): the
    kernel's and the plain version's."""
    k = attn.shape[-1]
    return (2 * (attn.numel() // k) * k * w_proj.shape[0],
            nbytes(x, attn, w_proj, b_proj, wp_scale) + nbytes(x))


# ----------------------------------------------------------------- plain
@counted(proj_residual_work)
def proj_residual_plain(x, attn, w_proj, b_proj):
    """x + (attn @ w_proj.T (scaled) + b_proj) rounded to x's dtype; w_proj
    a dense weight or a QuantizedTensor."""
    return x + (quant_dot(attn, w_proj) + b_proj.float()).to(x.dtype)


def split_rows_plain(attn):
    """Plain version of split_rows_kernel: fp32 rows (M, K) as their hi and
    lo bf16 halves side by side, (M, 2K), hi = bf16(a), lo = bf16(a - hi)."""
    a = attn.reshape(-1, attn.shape[-1]).float()
    hi = a.to(torch.bfloat16)
    return torch.cat([hi, (a - hi.float()).to(torch.bfloat16)], dim=-1)


def proj_residual_large_m_plain(x, rows, w, w_scale, b_proj):
    """Plain version of the large-M entry's product (kind LM_RESIDUAL): x
    (M, C) + x.dtype(rows . W^T (* s) + b), rows (M, K) bf16 or split (M,
    2K, which contract hi + lo as the body's hi.W + lo.W passes do); W (C, K)
    bf16, an int8 payload's bf16 conversion (exact) with its scale s."""
    c = x.shape[-1]
    return x.reshape(-1, c) + lqa.ln_qkv_large_m_plain(rows, w, w_scale, b_proj, x.dtype)


def proj_partial_plain(attn, w_proj):
    """A tensor-parallel rank's share of the projection: attn . w_proj^T
    (its K/tp input columns) in fp32, no bias, no residual."""
    return quant_dot(attn, w_proj)


def ln_qkv_attn_proj_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                           key_bias, heads: int, eps: float = 1e-6):
    """Plain version of kernel #4: the attention output in w_proj's dtype,
    one rounding of the projection to x's dtype (:318-325)."""
    attn = lqa.ln_qkv_attention_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, key_bias,
                                      heads, eps)
    return proj_residual_plain(x, attn.to(w_proj.dtype), w_proj, b_proj)


def ln_qkv_attn_proj_q8_plain(x, ln_scale, ln_bias, w_q, w_scale, b_qkv, wp_q,
                              wp_scale, b_proj, key_bias, heads: int,
                              eps: float = 1e-6):
    """Plain version of kernel #6: everything in x's dtype (:495-517)."""
    attn = lqa.ln_qkv_attention_q8_plain(x, ln_scale, ln_bias, w_q, w_scale, b_qkv,
                                         key_bias, heads, eps)
    return proj_residual_plain(x, attn, QuantizedTensor(wp_q, wp_scale, x.dtype), b_proj)


# ---------------------------------------------------------------- kernels
@counted(proj_residual_work)
def proj_residual(x, attn, w_proj, b_proj, wp_scale=None):
    """x (B, N, C) bf16|fp32 residual stream; attn (B, N, K) bf16|fp32;
    w_proj (C, K) bf16, int8 with wp_scale (C,) fp32, or fp32 (with an fp32
    x and attn); b_proj (C,) fp32 -> x + proj, (B, N, C) in x's dtype."""
    if torch.compiler.is_exporting():
        return library.proj_residual(x, attn, w_proj, b_proj, wp_scale)
    if x.device.type == "cpu":
        w = w_proj if wp_scale is None else QuantizedTensor(w_proj, wp_scale, attn.dtype)
        return proj_residual_plain(x, attn, w, b_proj)
    b, n, c = x.shape
    k = attn.shape[-1]
    require((x.dtype, attn.dtype, w_proj.dtype) in _OK,
            f"proj_residual: no instantiation for x {x.dtype}, attn {attn.dtype}, "
            f"w_proj {w_proj.dtype}")
    require((wp_scale is not None) == (w_proj.dtype == torch.int8),
            "proj_residual: an int8 w_proj needs its scale, a bf16 or fp32 one none")
    require(tuple(attn.shape) == (b, n, k) and tuple(w_proj.shape) == (c, k)
            and tuple(b_proj.shape) == (c,) and b_proj.dtype == torch.float32,
            "proj_residual: bad shapes or bias dtype")
    require(k % 64 == 0 and k >= 64 * PROJ_SPLIT and c % 64 == 0,
            f"proj_residual: K must be a multiple of 64 and at least {64 * PROJ_SPLIT}, and C "
            f"a multiple of 64 (K={k}, C={c})")
    scale = () if wp_scale is None else (wp_scale,)
    if scale:
        require(wp_scale.dtype == torch.float32 and tuple(wp_scale.shape) == (c,),
                "proj_residual: wp_scale must be (C,) fp32")
    no_grad_through("proj_residual", (x, attn, w_proj, b_proj, *scale),
                    lqa.INT8_NO_GRAD if scale else "call it through ops/autograd.py (LnQkvAttnProj)")
    check_cuda("proj_residual", x, attn, w_proj, b_proj, *scale)
    out = torch.empty_like(x)
    tag = build.dtype_tag
    inst = f"{tag(x)}x-{tag(attn)}a-{tag(w_proj)}w"
    x32, a32 = int(x.dtype == torch.float32), int(attn.dtype == torch.float32)
    if lqa.takes_large_m(b * n, w_proj.dtype, LARGE_M_ROWS):
        # an fp32 A as hi | lo bf16 rows and an int8 W converted to bf16,
        # once a call: scratch of this call (from the CUDA graph's pool under
        # capture, so a graph's replays reuse its addresses)
        a_split = (torch.empty((b * n, 2 * k), dtype=torch.bfloat16, device=x.device)
                   if a32 else None)
        w16 = (torch.empty((c, k), dtype=torch.bfloat16, device=x.device) if scale else None)
        build.launch("proj_residual", inst,
                     [PTR, INT, PTR, INT, PTR, INT, PTR, PTR, PTR, PTR, PTR, INT, INT, INT],
                     x.data_ptr(), x32, attn.data_ptr(), a32, w_proj.data_ptr(),
                     lqa.W_KIND[w_proj.dtype], wp_scale.data_ptr() if scale else None,
                     b_proj.data_ptr(), None if a_split is None else a_split.data_ptr(),
                     None if w16 is None else w16.data_ptr(), out.data_ptr(), b * n, k, c,
                     stream_of=x, entry="uvl_proj_residual_large_m", body="lm")
        return out
    # an fp32 weight goes to the kernel as its cached hi/lo planes
    w32 = w_proj.dtype == torch.float32
    w_arg = hilo.planes(w_proj) if w32 else w_proj
    build.launch("proj_residual", inst,
                 [PTR, INT, PTR, INT, PTR, INT, PTR, PTR, PTR, INT, INT, INT],
                 x.data_ptr(), x32, attn.data_ptr(), a32, w_arg.data_ptr(),
                 lqa.W_KIND[w_proj.dtype], wp_scale.data_ptr() if scale else None,
                 b_proj.data_ptr(), out.data_ptr(), b * n, k, c, stream_of=x,
                 body="" if w32 else "64")
    return out


def ln_qkv_attn_proj(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, key_bias,
                     heads: int, eps: float = 1e-6):
    """Kernel #4's function (bf16 weights, or fp32 ones with an fp32 x):
    `ln_qkv`, `qkv_attention`, then `proj_residual` on the attention output
    in w_proj's dtype; three launches on a CUDA tensor. Returns x + proj in
    x's dtype."""
    attn = lqa.ln_qkv_attention(x, ln_scale, ln_bias, w_qkv, b_qkv, key_bias, heads, eps)
    return proj_residual(x, attn.to(w_proj.dtype), w_proj, b_proj)


def ln_qkv_attn_proj_q8(x, ln_scale, ln_bias, w_q, w_scale, b_qkv, wp_q, wp_scale,
                        b_proj, key_bias, heads: int, eps: float = 1e-6):
    """Kernel #6's function (int8 weights), computing in x's dtype:
    `ln_qkv_q8`, `qkv_attention`, `proj_residual`."""
    attn = lqa.ln_qkv_attention_q8(x, ln_scale, ln_bias, w_q, w_scale, b_qkv, key_bias,
                                   heads, eps)
    return proj_residual(x, attn, wp_q, b_proj, wp_scale)


def proj_partial(attn, w_proj):
    """A tensor-parallel rank's share of kernel #4's projection (parallel/
    tp.py): attn (B, N, K/tp) in w_proj's dtype, w_proj (C, K/tp) ->
    (B, N, C) fp32, no bias, no residual; the caller sums the shares over
    the model group and adds the bias and the residual once. On a CUDA
    tensor, bf16 attn and w_proj: one launch of csrc/proj_residual.cu's
    `uvl_dense` on the core's large-M body (dense_f32's product at M from
    LARGE_M_ROWS, counted apart as proj_residual[bf16a-bf16w-fp32o]),
    K a multiple of 64; fp32 ones (fp32
    compute): `proj_residual`'s fp32 instantiation on a zero fp32 stream
    with a zero bias."""
    if attn.device.type == "cpu":
        return proj_partial_plain(attn, w_proj)
    b, n, k = attn.shape
    c = w_proj.shape[0]
    if attn.dtype == w_proj.dtype == torch.float32:
        zero = torch.zeros((b, n, c), dtype=torch.float32, device=attn.device)
        return proj_residual(zero, attn, w_proj, torch.zeros((c,), dtype=torch.float32,
                                                            device=attn.device))
    require(attn.dtype == w_proj.dtype == torch.bfloat16,
            f"proj_partial: attn and w_proj must be both bf16 or both fp32, got {attn.dtype}, "
            f"{w_proj.dtype}")
    require(tuple(w_proj.shape) == (c, k), "proj_partial: w_proj must be (C, K) for attn's K")
    require(k % 64 == 0 and c % 8 == 0,
            f"proj_partial: K must be a multiple of 64 and C of 8 (K={k}, C={c})")
    no_grad_through("proj_partial", (attn, w_proj),
                    "call it through ops/autograd.py (ProjPartial)")
    check_cuda("proj_partial", attn, w_proj)
    out = torch.empty((b, n, c), dtype=torch.float32, device=attn.device)
    build.launch("proj_residual", "bf16a-bf16w-fp32o", [PTR, PTR, PTR, INT, INT, INT, INT],
                 attn.data_ptr(), w_proj.data_ptr(), out.data_ptr(), b * n, k, c, 0,
                 stream_of=attn, entry="uvl_dense")
    return out


# dense_f32's schedule (tools/gemm_ab.py --dot on one H100, PERF.md section 6
# row D): at a lockstep step's 2,568-2,888 rows the large-M body beat every
# split of the 64-row body in all six products (B and L: 8.8-47 us against
# 11-160); at the tracking step's 321/361 rows, fc1's wide output (N = 4K) ran
# fastest on the large-M body (7.9 us B, 9.5-11 L), the projection unsplit on
# the 64-row body (5.7 / 6.3 against 6.0-7.8 split), fc2 split in 3 (B, 10.1-10.7
# us) and in 2 (L, 12.9-13.6). Its threshold is proj_residual's LARGE_M_ROWS
# (read at each call): no cell runs between 361 and 2,568 rows.
# A split's cost in 64-deep k-tiles of one block: the cluster's reduction
# through distributed shared memory and its barriers
DENSE_SPLIT_COST = 8


def dense_parts(m: int, k: int, n: int, sms: int) -> int:
    """dense_f32's schedule for (M, K) . (N, K)^T on a device of `sms` SMs: 0
    for the large-M body (M from LARGE_M_ROWS, or an output at least twice
    as wide as K), else the 1-3 blocks of a cluster that split K on the
    64-row body: the fewest rounds of blocks over the SMs times the k-tiles
    of a block (plus DENSE_SPLIT_COST when split), the fewer parts on a
    tie."""
    if m >= LARGE_M_ROWS or n >= 2 * k:
        return 0
    tiles, kt = -(-m // 64) * -(-n // 128), k // 64

    def cost(p):
        return -(-tiles * p // sms) * (-(-kt // p) + (DENSE_SPLIT_COST if p > 1 else 0))

    return min(range(1, min(3, kt) + 1), key=lambda p: (cost(p), p))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def dense_fallback(a, w) -> str:
    """Why dense_f32 hands a . w^T to quant_dot ("" when the core takes it):
    "cpu" off the card, "int8w" for a QuantizedTensor, "dtype" unless both
    are bf16, "grad" when autograd needs a gradient, "shape" unless K is
    a multiple of 64, N of 8 and a holds rows, "export" under
    torch.export."""
    if not _on_card(a):
        return "cpu"
    if isinstance(w, QuantizedTensor):
        return "int8w"
    if not (a.dtype == w.dtype == torch.bfloat16):
        return "dtype"
    if grad_needed(a, w):
        return "grad"
    if (a.shape[-1] % 64 or w.shape[0] % 8 or tuple(w.shape[1:]) != (a.shape[-1],)
            or a.numel() == 0):
        return "shape"
    if torch.compiler.is_exporting():
        return "export"
    return ""


def launch_dense(a, w, parts: int):
    """One launch of uvl_dense: a (..., K) . w (N, K)^T -> (..., N) fp32 on
    the body `parts` names (dense_parts)."""
    a = a.contiguous()
    k, n = a.shape[-1], w.shape[0]
    m = a.numel() // k
    check_cuda("dense", a, w)
    out = torch.empty((*a.shape[:-1], n), dtype=torch.float32, device=a.device)
    build.launch("dense", "bf16a-bf16w-fp32o", [PTR, PTR, PTR, INT, INT, INT, INT],
                 a.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n, parts, stream_of=a,
                 entry="uvl_dense", lib="proj_residual", body="64" if parts else "lm")
    return out


def dense_f32(a, w):
    """quant_dot(a, w), a (..., K) and w (N, K) or a QuantizedTensor -> (...,
    N) fp32: on the GEMM core where dense_fallback finds no reason against,
    at dense_parts' schedule; else quant_dot, counted in build.FALLBACKS on
    the card."""
    why = dense_fallback(a, w)
    if why:
        if why != "cpu":
            build.FALLBACKS[f"dense[{why}]"] += 1
        return quant_dot(a, w)
    k = a.shape[-1]
    return launch_dense(a, w, dense_parts(a.numel() // k, k, w.shape[0], _sm_count(a.device)))
