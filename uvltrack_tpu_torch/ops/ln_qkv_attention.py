"""Fused LayerNorm + qkv + masked attention: the CUDA port of the Pallas kernels
uvltrack_tpu/ops/pallas_attention.py::_ln_qkv_attn_kernel (:167,
`fused_ln_qkv_attention` :207), its int8-weight variant
_ln_qkv_attn_kernel_q8 (:433, `fused_ln_qkv_attention_q8` :459) and, through
their second half, `_attn_kernel_qkv` (:119, `fused_attention_qkv` :143).

The TPU kernels are one program per batch element (grid=(B,)) with the
(C, 3C) weight resident in VMEM. At batch 1 that would be one block on one
of the H100's 132 SMs, so the port splits each in two kernels
(csrc/ln_qkv.cu, csrc/qkv_attention.cu; design and bounds in their notes):

- `ln_qkv` / `ln_qkv_q8`: LN (fp32, fast variance clamped at 0), tensor-core
  product against W, fp32 epilogue (`acc + b`, or `acc * scale + b` for the
  int8 payload), out (B, N, 3C). Both weight types run on the TMA + wgmma
  core of csrc/gemm_sm90.cuh (the 64 normalized rows of a block in shared
  memory once, so C <= 1024; an int8 W streams as bytes and is converted to
  bf16 in shared memory).
- `qkv_attention`: the TMA + wgmma attention body of csrc/attention.cuh,
  one block per (64-row query tile, head, batch element), the keys split
  over a cluster of up to 3 blocks: exp(clip(q.k*D^-1/2 + key_bias, +-80)),
  fp32 row sums, P.V, division at the end; out (B, N, C) before the output
  projection. In fp32 every product runs as three bf16 hi/lo passes.

Compute dtype, as in the Pallas kernels: kernel #1 computes in the weight's
dtype: bf16 for a bf16 weight, whatever x is; fp32 for the fp32 weight of a
model at TPU.COMPUTE_DTYPE=float32, whose stream is fp32 in every block (its
product runs as three bf16 hi/lo passes, no TF32, against the weight's hi and
lo planes, split once and cached by ops/hilo.py). The int8 kernel (#5)
computes in x's dtype: bf16 in the visual blocks, fp32 in the joint blocks,
where nothing is rounded to bf16 (normalized rows, qkv, scores, e, P.V and
the output all stay fp32). So `ln_qkv` has five instantiations (x bf16/fp32
x weight bf16/int8, and fp32x-fp32w) and `qkv_attention` two (bf16, fp32).

Each wrapper checks device, dtype, shape and contiguity, launches on
PyTorch's current stream, raises on a nonzero cudaGetLastError, and counts
its launches per kernel and instantiation (all through ops/build.py: read
them with build.launch_counts() and build.instantiation_counts()). A CPU
tensor takes the plain PyTorch version beside it; a CUDA tensor launches
the kernel or raises. The plain versions compute the same function with the same rounding
points and are what the CPU tests hold against the Pallas interpreter.
"""

from __future__ import annotations

import torch

from ..utils.costs import counted, nbytes
from . import build, hilo, library
from .build import FLOAT, INT, PTR, check_cuda, no_grad_through, require
from .quant import QuantizedTensor, quant_dot

CLAMP = 80.0  # exp-safe score range of the kernels (pallas_attention._CLAMP)
# widest C the LN products take (both weight types): 64 normalized rows of C
# bf16 (or hi/lo halves of half the row) sit in shared memory beside the TMA
# ring (csrc/gemm_sm90.cuh MAX_C; at C=1024 the fc1 launch uses 205,880 of a
# block's 232,448 bytes)
LN_MAX_C = 1024
# csrc/ln_qkv.cu's w_kind by the weight's dtype
W_KIND = {torch.bfloat16: 0, torch.int8: 1, torch.float32: 2}
# the int8 launches' answer under autograd: kernels #5/#6 have no VJP
INT8_NO_GRAD = ("weight-only int8 (TPU.WEIGHT_QUANT) is inference-only, as in the JAX "
                "package: train with TPU.WEIGHT_QUANT unset")


# ------------------------------------------------------------- work
# A kernel and its plain version count the same work (utils/costs.py): the
# products' FLOPs, each input read once and each output written once.
def _rows(x):
    return x.numel() // x.shape[-1], x.shape[-1]


def ln_qkv_work(x, ln_scale, ln_bias, w_qkv, b_qkv, eps=1e-6):
    (m, c), f = _rows(x), w_qkv.shape[0]
    return 2 * m * c * f, nbytes(x, ln_scale, ln_bias, w_qkv, b_qkv) + m * f * w_qkv.dtype.itemsize


def ln_qkv_q8_work(x, ln_scale, ln_bias, w_q, w_scale, b_qkv, eps=1e-6):
    (m, c), f = _rows(x), w_q.shape[0]
    return 2 * m * c * f, nbytes(x, ln_scale, ln_bias, w_q, w_scale, b_qkv) + m * f * x.dtype.itemsize


def qkv_attention_work(qkv, key_bias, heads):
    b, n, f = qkv.shape
    return 4 * b * n * n * f // 3, nbytes(qkv, key_bias) + nbytes(qkv) // 3


# ----------------------------------------------------------------- plain
def layer_norm_fast_var(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 LayerNorm with flax's fast variance mean(x^2) - mean^2 clamped
    at 0, in the Pallas kernels' order: (x - mean) * rsqrt(var + eps) * g + b."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return y * scale.float() + bias.float()


@counted(ln_qkv_work)
def ln_qkv_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, eps: float = 1e-6):
    """Plain version of `ln_qkv` (pallas_attention._xla_ln_qkv): the
    normalized rows and the result in w_qkv's dtype, which for a
    QuantizedTensor is its compute dtype."""
    y = layer_norm_fast_var(x, ln_scale, ln_bias, eps).to(w_qkv.dtype)
    return (quant_dot(y, w_qkv) + b_qkv.float()).to(w_qkv.dtype)


@counted(ln_qkv_q8_work)
def ln_qkv_q8_plain(x, ln_scale, ln_bias, w_q, w_scale, b_qkv, eps: float = 1e-6):
    """Plain version of `ln_qkv_q8`: the q8 kernel's prefix
    (_ln_qkv_attn_kernel_q8 :441-453), computing in x's dtype."""
    return ln_qkv_plain(x, ln_scale, ln_bias, QuantizedTensor(w_q, w_scale, x.dtype),
                        b_qkv, eps)


@counted(qkv_attention_work)
def qkv_attention_plain(qkv, key_bias, heads: int):
    """Plain version of `qkv_attention`: the kernel's clamped, late-divided
    softmax (pallas_attention._attn_kernel_qkv's math), e cast to qkv's
    dtype for P.V (a no-op in fp32)."""
    b, n, f = qkv.shape
    d = f // (3 * heads)
    q, k, v = qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d ** -0.5
    s = (s + key_bias.float()[:, None, None, :]).clamp(-CLAMP, CLAMP)
    e = torch.exp(s)
    o = torch.matmul(e.to(v.dtype).float(), v.float())
    o = o * (1.0 / e.sum(-1, keepdim=True))
    return o.to(qkv.dtype).transpose(1, 2).reshape(b, n, heads * d)


def ln_qkv_attention_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, key_bias,
                           heads: int, eps: float = 1e-6):
    """Plain version of `ln_qkv_attention` (kernel #1's function; with a
    QuantizedTensor, the JAX package's XLA fallback for int8 weights)."""
    qkv = ln_qkv_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, eps)
    return qkv_attention_plain(qkv, key_bias, heads)


def ln_qkv_attention_q8_plain(x, ln_scale, ln_bias, w_q, w_scale, b_qkv, key_bias,
                              heads: int, eps: float = 1e-6):
    """Plain version of `ln_qkv_attention_q8` (kernel #5's function)."""
    qkv = ln_qkv_q8_plain(x, ln_scale, ln_bias, w_q, w_scale, b_qkv, eps)
    return qkv_attention_plain(qkv, key_bias, heads)


# ---------------------------------------------------------------- kernels
def _launch_ln_qkv(x, ln_scale, ln_bias, w, w_scale, b_qkv, eps, out_dtype):
    """W (F, C): F = 3C, or a tensor-parallel rank's 3C/tp rows (its heads'
    q, k and v; parallel/tp.py)."""
    b, n, c = x.shape
    f = w.shape[0]
    require(x.dtype in (torch.bfloat16, torch.float32),
            f"ln_qkv: x must be bf16 or fp32, got {x.dtype}")
    require(all(t.dtype == torch.float32 for t in (ln_scale, ln_bias, b_qkv)),
            "ln_qkv: LN scale/bias and qkv bias must be fp32")
    require(tuple(w.shape) == (f, c) and f % 8 == 0 and tuple(b_qkv.shape) == (f,)
            and tuple(ln_scale.shape) == (c,) and tuple(ln_bias.shape) == (c,),
            f"ln_qkv: bad shapes for C={c}, F={f} (F a multiple of 8)")
    require(c % 64 == 0, f"ln_qkv: C must be a multiple of 64, got {c}")
    tensors = (x, ln_scale, ln_bias, w, b_qkv) + ((w_scale,) if w_scale is not None else ())
    no_grad_through("ln_qkv", tensors, INT8_NO_GRAD if w_scale is not None else
                    "call it through ops/autograd.py (LnQkvAttention, LnQkvAttnProj)")
    check_cuda("ln_qkv", *tensors)
    # an fp32 weight goes to the kernel as its cached hi/lo planes
    w_arg = hilo.planes(w) if w.dtype == torch.float32 else w
    out = torch.empty((b, n, f), dtype=out_dtype, device=x.device)
    build.launch("ln_qkv", f"{build.dtype_tag(x)}x-{build.dtype_tag(w)}w",
                 [PTR, INT, PTR, PTR, PTR, INT, PTR, PTR, PTR, INT, INT, INT, FLOAT],
                 x.data_ptr(), int(x.dtype == torch.float32), ln_scale.data_ptr(),
                 ln_bias.data_ptr(), w_arg.data_ptr(), W_KIND[w.dtype],
                 w_scale.data_ptr() if w_scale is not None else None, b_qkv.data_ptr(),
                 out.data_ptr(), b * n, c, f, eps, stream_of=x)
    return out


@counted(ln_qkv_work)
def ln_qkv(x, ln_scale, ln_bias, w_qkv, b_qkv, eps: float = 1e-6):
    """x (B, N, C) bf16|fp32; ln_scale, ln_bias (C,) fp32; w_qkv (F, C) bf16,
    or fp32 with an fp32 x (Linear layout; F = 3C, 3C/tp under tensor
    parallelism); b_qkv (F,) fp32 -> (B, N, F) in w_qkv's dtype (kernel
    #1's prefix)."""
    if torch.compiler.is_exporting():
        return library.ln_qkv(x, ln_scale, ln_bias, w_qkv, b_qkv, eps)
    if x.device.type == "cpu":
        return ln_qkv_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, eps)
    require(w_qkv.dtype in (torch.bfloat16, torch.float32),
            f"ln_qkv: w_qkv must be bf16 or fp32, got {w_qkv.dtype}")
    require(w_qkv.dtype == torch.bfloat16 or x.dtype == torch.float32,
            f"ln_qkv: an fp32 w_qkv (fp32 compute) needs an fp32 x, got {x.dtype}")
    require(x.shape[-1] <= LN_MAX_C, f"ln_qkv: C must be at most {LN_MAX_C} (the LN block of 64 "
            f"rows in shared memory), got {x.shape[-1]}")
    return _launch_ln_qkv(x, ln_scale, ln_bias, w_qkv, None, b_qkv, eps, w_qkv.dtype)


@counted(ln_qkv_q8_work)
def ln_qkv_q8(x, ln_scale, ln_bias, w_q, w_scale, b_qkv, eps: float = 1e-6):
    """x (B, N, C) bf16|fp32; w_q (3C, C) int8 payload; w_scale (3C,) fp32
    per-row scale -> (B, N, 3C) in x's dtype (kernel #5's prefix)."""
    if torch.compiler.is_exporting():
        return library.ln_qkv_q8(x, ln_scale, ln_bias, w_q, w_scale, b_qkv, eps)
    if x.device.type == "cpu":
        return ln_qkv_q8_plain(x, ln_scale, ln_bias, w_q, w_scale, b_qkv, eps)
    require(w_q.dtype == torch.int8, f"ln_qkv_q8: w_q must be int8, got {w_q.dtype}")
    require(w_scale.dtype == torch.float32 and tuple(w_scale.shape) == (w_q.shape[0],),
            "ln_qkv_q8: w_scale must be (3C,) fp32")
    require(x.shape[-1] <= LN_MAX_C, f"ln_qkv_q8: C must be at most {LN_MAX_C} (the LN block of "
            f"64 rows in shared memory), got {x.shape[-1]}")
    return _launch_ln_qkv(x, ln_scale, ln_bias, w_q, w_scale, b_qkv, eps, x.dtype)


@counted(qkv_attention_work)
def qkv_attention(qkv, key_bias, heads: int):
    """qkv (B, N, 3*H*64) bf16|fp32; key_bias (B, N) fp32 additive ->
    (B, N, H*64) in qkv's dtype."""
    if torch.compiler.is_exporting():
        return library.qkv_attention(qkv, key_bias, heads)
    if qkv.device.type == "cpu":
        return qkv_attention_plain(qkv, key_bias, heads)
    b, n, f = qkv.shape
    require(qkv.dtype in (torch.bfloat16, torch.float32),
            f"qkv_attention: qkv must be bf16 or fp32, got {qkv.dtype}")
    require(key_bias.dtype == torch.float32 and tuple(key_bias.shape) == (b, n),
            "qkv_attention: key_bias must be (B, N) fp32")
    require(f == 3 * heads * 64, f"qkv_attention: head dim must be 64 (F={f}, H={heads})")
    no_grad_through("qkv_attention", (qkv, key_bias),
                    "call it through ops/autograd.py (QkvAttention, LnQkvAttention)")
    check_cuda("qkv_attention", qkv, key_bias)
    out = torch.empty((b, n, f // 3), dtype=qkv.dtype, device=qkv.device)
    build.launch("qkv_attention", build.dtype_tag(qkv),
                 [PTR, INT, PTR, PTR, INT, INT, INT, INT, FLOAT],
                 qkv.data_ptr(), int(qkv.dtype == torch.float32), key_bias.data_ptr(),
                 out.data_ptr(), b, n, heads, 64, 64 ** -0.5, stream_of=qkv)
    return out


def ln_qkv_attention(x, ln_scale, ln_bias, w_qkv, b_qkv, key_bias,
                     heads: int, eps: float = 1e-6):
    """Kernel #1's function: (B, N, C) residual stream -> (B, N, C)
    attention output before the projection, in w_qkv's dtype. On a CUDA
    tensor: `ln_qkv` then `qkv_attention`, two launches."""
    qkv = ln_qkv(x, ln_scale, ln_bias, w_qkv, b_qkv, eps)
    return qkv_attention(qkv, key_bias, heads)


def ln_qkv_attention_q8(x, ln_scale, ln_bias, w_q, w_scale, b_qkv, key_bias,
                        heads: int, eps: float = 1e-6):
    """Kernel #5's function: as ln_qkv_attention with the int8 payload and
    its per-row scale, computing in x's dtype. Two launches on a CUDA
    tensor: `ln_qkv_q8`, then `qkv_attention` in x's dtype."""
    qkv = ln_qkv_q8(x, ln_scale, ln_bias, w_q, w_scale, b_qkv, eps)
    return qkv_attention(qkv, key_bias, heads)
