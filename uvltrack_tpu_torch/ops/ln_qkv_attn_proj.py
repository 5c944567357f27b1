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

`proj_residual` runs on the TMA + wgmma core of csrc/gemm_sm90.cuh, with K
split over clusters of PROJ_SPLIT blocks (one 64-deep k-tile each at the
least) and summed in rank order, so two calls give the same bits. The
wrapper checks, launches and counts through ops/build.py, as the prefix
wrappers do; a CPU tensor takes the plain version.
"""

from __future__ import annotations

import torch

from ..utils.costs import counted, nbytes
from . import build, hilo, library
from . import ln_qkv_attention as lqa
from .build import INT, PTR, check_cuda, no_grad_through, require
from .quant import QuantizedTensor, quant_dot

PROJ_SPLIT = 3  # blocks of a cluster that split K (csrc/proj_residual.cu SPLIT)
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
    # an fp32 weight goes to the kernel as its cached hi/lo planes
    w_arg = hilo.planes(w_proj) if w_proj.dtype == torch.float32 else w_proj
    out = torch.empty_like(x)
    tag = build.dtype_tag
    build.launch("proj_residual", f"{tag(x)}x-{tag(attn)}a-{tag(w_proj)}w",
                 [PTR, INT, PTR, INT, PTR, INT, PTR, PTR, PTR, INT, INT, INT],
                 x.data_ptr(), int(x.dtype == torch.float32), attn.data_ptr(),
                 int(attn.dtype == torch.float32), w_arg.data_ptr(), lqa.W_KIND[w_proj.dtype],
                 wp_scale.data_ptr() if scale else None,
                 b_proj.data_ptr(), out.data_ptr(), b * n, k, c, stream_of=x)
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
    (B, N, C) fp32, no bias, no residual. On a CUDA tensor one
    `proj_residual` launch on a zero fp32 residual with a zero bias (its
    fp32-x instantiation: the product is not rounded); the caller sums the
    shares over the model group and adds the bias and the residual once."""
    if attn.device.type == "cpu":
        return proj_partial_plain(attn, w_proj)
    b, n, _ = attn.shape
    c = w_proj.shape[0]
    zero = torch.zeros((b, n, c), dtype=torch.float32, device=attn.device)
    return proj_residual(zero, attn, w_proj, torch.zeros((c,), dtype=torch.float32,
                                                        device=attn.device))
