"""Attention and MLP entry points with a backend switch (port of
uvltrack_tpu/ops/attention.py).

Backends: "plain" (the JAX package's "xla": composed PyTorch math) and
"cuda" (its "pallas": the hand-written kernels of ops/ln_qkv_attention.py,
ops/ln_qkv_attn_proj.py, ops/fused_attention.py and ops/ln_mlp.py), which is
the default. build_model sets the backend from cfg.TPU.USE_PALLAS_ATTENTION;
force_backend pins it process-wide (chip_smoke.py's plain-vs-kernel A/B),
and force_backend(None) goes back to the backend set_backend chose last.

On the "cuda" backend a CUDA tensor takes the kernels when its sequence
length N is at least min_seq_len(): UVLTRACK_PALLAS_MIN_N, read at call
time, default 128, as pallas_attention.min_seq_len reads it. Every gate
below uses it; CPU tensors take the plain math.

- attention_core (BERT's layers; (B, H, N, D) q/k/v, so N is q.shape[2]):
  kernel #3 for a key-padding bias (B, 1, 1, N) or none; any other bias
  falls back to plain_attention, as the JAX adapter returns None for it.
  BERT runs at N=40, so the kernel engages with UVLTRACK_PALLAS_MIN_N <= 40.
- attention_qkv_core (kernel #2's entry, the fused qkv layout (B, N, 3C)):
  `qkv_attention` for a key-padding bias or none, else plain_attention on
  the reshaped q, k, v (the unclamped softmax of the JAX package's XLA
  branch).
- attention_ln_qkv_core: kernel #1 for bf16 weights, #5 for int8 ones
  (ops/quant.py QuantizedTensor). Under UVLTRACK_FUSED_PREFIX=0 (read at
  call time, default "1") LN + qkv run as the plain `ln_qkv_plain` and the
  attention alone as kernel #2, the JAX package's "step 3" A/B.
  attention_block_core runs #4 or #6 instead when UVLTRACK_FUSED_PROJ=1
  (default off), UVLTRACK_FUSED_PREFIX is not "0", and the qkv and proj
  weights are both fp or both int8, as the JAX package gates them.
- A bias that is not key padding ((B, 1, N, N) and the like) takes the
  generic path in the ViT cores: `ln_qkv_plain`, then attention_qkv_core
  with the full bias, and never #4/#6.
- ln_mlp_core: kernel #7 when UVLTRACK_FUSED_MLP=1 (read at call time,
  default off) for fp weights; int8 weights stay plain, as in the JAX
  package.

Under autograd (grad mode on and an input that needs a gradient) every
entry above takes the kernel through its torch.autograd.Function of
ops/autograd.py (#1, #2, #4, #7: kernel forward, plain recompute
backward), as the JAX package takes its custom VJPs. #3, #5 and #6 have no
VJP there; their wrappers raise under autograd, naming the knob
(UVLTRACK_PALLAS_MIN_N, TPU.WEIGHT_QUANT) that keeps training off them.

Kernel #1 takes bf16 weights, and the fp32 weights of a model at
TPU.COMPUTE_DTYPE=float32 (`ln_qkv[fp32x-fp32w]`, then `qkv_attention[fp32]`),
so an fp32 model runs its attention prefix on the kernels in every block. The
fused projection (#4) and MLP (#7) take bf16 weights only: under
UVLTRACK_FUSED_PROJ=1 / UVLTRACK_FUSED_MLP=1 an fp32 model's launch raises,
naming its knob. The JAX package's VMEM caps (UVLTRACK_FUSED_VMEM_MB, and the 14 MB gate of its fused MLP)
bound a TPU resource that the port's tiled kernels do not have, and are not
ported: under UVLTRACK_FUSED_MLP=1 the port's #7 runs in every ViT block at
N=321/361, where the JAX package, over its cap, runs the kernel's XLA twin
(the same function with the same rounding points).

Tensor parallelism (parallel/tp.py; training): a rank holds H/tp heads of
qkv and K/tp input columns of the projection and fc2. attention_ln_qkv_core
runs its heads as above; attn_proj_partial_core and ln_mlp_partial_core
give the rank's fp32 share of the projection and of the MLP before the
bias, which the ViT block sums over the model group: on the kernels
`proj_residual` on a zero fp32 stream under UVLTRACK_FUSED_PROJ=1 (where
attention_block_core would take #4) and #7 with an fp32 out under
UVLTRACK_FUSED_MLP=1, else their plain versions.

Precision of the int8 path: the q8 kernels compute in x's dtype, so on the
card the fp32 joint blocks run their attention prefix in fp32; the plain
math (the JAX package's XLA fallback) computes in the compute dtype, bf16.
Each side follows its own oracle.

Semantics of the reference blocks: scores = q.k^T * scale + additive key
bias (-1e10 at masked ViT keys, lib/models/backbones/block.py:47-61; BERT
-10000), softmax in fp32, then probs.v.
"""

from __future__ import annotations

import os

import torch

from . import autograd as ag
from . import fused_attention as fa
from . import ln_mlp as lm
from . import ln_qkv_attention as lqa
from . import ln_qkv_attn_proj as lqp
from ..utils.costs import counted
from .build import grad_needed
from .quant import is_quantized, quant_dot

_BACKENDS = ("plain", "cuda")
_CONFIGURED = "cuda"  # set_backend's last choice
_OVERRIDE = None  # force_backend pin: wins over later set_backend calls
_BACKEND = _CONFIGURED  # the backend in effect


def min_seq_len() -> int:
    """Shortest sequence the kernels take (pallas_attention.min_seq_len):
    UVLTRACK_PALLAS_MIN_N, read at call time, default 128, so BERT's
    40-token layers stay plain unless it is lowered."""
    return int(os.environ.get("UVLTRACK_PALLAS_MIN_N", "128"))


def set_backend(name: str) -> None:
    """Select the backend; a force_backend pin wins until it is cleared
    (build_model calls this from each model's cfg)."""
    global _BACKEND, _CONFIGURED
    if name not in _BACKENDS:
        raise ValueError(f"unknown attention backend {name!r}")
    _CONFIGURED = name
    if _OVERRIDE is None:
        _BACKEND = name


def force_backend(name: str | None) -> None:
    """Pin the backend process-wide; None clears the pin and restores the
    backend set_backend chose last."""
    global _BACKEND, _OVERRIDE
    if name is not None and name not in _BACKENDS:
        raise ValueError(f"unknown attention backend {name!r}")
    _OVERRIDE = name
    _BACKEND = name if name is not None else _CONFIGURED


def get_backend() -> str:
    return _BACKEND


def key_padding_bias(key_masked: torch.Tensor, neg: float = -1e10) -> torch.Tensor:
    """(B, N) bool, True = masked key -> (B, 1, 1, N) additive fp32 bias."""
    zero = torch.zeros((), dtype=torch.float32, device=key_masked.device)
    return torch.where(key_masked, neg, zero)[:, None, None, :]


def _key_padding(bias, b: int, n: int, device):
    """The JAX package's key-padding contract: None -> zeros; a (B, 1, 1, N)
    additive bias -> its (B, N) fp32 form; any other shape -> None."""
    if bias is None:
        return torch.zeros((b, n), dtype=torch.float32, device=device)
    if bias.ndim == 4 and bias.shape[1] == 1 and bias.shape[2] == 1:
        return bias[:, 0, 0, :].float().contiguous()
    return None


def fused_prefix() -> bool:
    """UVLTRACK_FUSED_PREFIX, read at call time (default "1"): "0" runs LN +
    qkv plain and the attention alone on kernel #2."""
    return os.environ.get("UVLTRACK_FUSED_PREFIX", "1") != "0"


@counted(fa.attention_work)
def plain_attention(q, k, v, bias=None):
    """Counterpart of xla_attention: q,k,v (B, H, N, D), fp32 logits and
    softmax, probs cast to v's dtype for the product. Returns v.dtype."""
    d = q.shape[-1]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d ** -0.5
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def _on_kernels(t: torch.Tensor, n: int) -> bool:
    """The kernel gate: "cuda" backend, a CUDA tensor, N >= min_seq_len()."""
    return _BACKEND == "cuda" and _on_card(t) and n >= min_seq_len()


def attention_core(q, k, v, bias=None):
    """Counterpart of attention_core: q, k, v (B, H, N, D); bias None or
    additive, broadcastable to (B, H, N, N). Returns (B, H, N, D) in v's
    dtype: kernel #3 past the gate for a key-padding bias, else
    plain_attention. The two differ on a row whose keys are all masked
    (BERT in BBOX mode): the kernel's clamp gives the uniform average of v,
    the plain softmax weighs the keys by their scores, as the JAX package's
    Pallas and XLA paths do."""
    b, _, n, _ = q.shape
    if _on_kernels(q, n):
        key_bias = _key_padding(bias, b, n, q.device)
        if key_bias is not None:
            return fa.fused_attention(q, k, v, key_bias)
    return plain_attention(q, k, v, bias)


def attention_qkv_core(qkv, heads: int, bias=None):
    """Counterpart of attention_qkv_core, kernel #2's entry: qkv is the fused
    projection (B, N, 3*H*D), features [q|k|v] x head x dim. Returns
    (B, N, H*D) in qkv's dtype: `qkv_attention` past the gate for a
    key-padding bias or none, else plain_attention on the reshaped heads."""
    b, n, f = qkv.shape
    d = f // (3 * heads)
    if _on_kernels(qkv, n):
        key_bias = _key_padding(bias, b, n, qkv.device)
        if key_bias is not None:
            if grad_needed(qkv):
                return ag.QkvAttention.apply(qkv.contiguous(), key_bias, heads)
            return lqa.qkv_attention(qkv.contiguous(), key_bias, heads)
    q, k, v = qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    return plain_attention(q, k, v, bias).transpose(1, 2).reshape(b, n, heads * d)


def attention_ln_qkv_core(x, ln_scale, ln_bias, w_qkv, b_qkv, heads: int,
                          bias=None, compute_dtype=None, eps: float = 1e-6):
    """Pre-LN LayerNorm + fused qkv projection + masked attention from the
    residual stream x (B, N, C); w_qkv in Linear layout (3C, C), a tensor or
    a QuantizedTensor. Returns the (B, N, C) attention output before the
    projection."""
    compute_dtype = compute_dtype or x.dtype
    b, n, _ = x.shape
    key_bias = _key_padding(bias, b, n, x.device)
    w = w_qkv.to(compute_dtype)
    on_kernels = _on_kernels(x, n)
    # a generic bias (any shape), or the prefix unfused: LN + qkv plain, then
    # the attention alone (kernel #2 on the kernels, for key padding)
    if key_bias is None or (on_kernels and not fused_prefix()):
        return attention_qkv_core(lqa.ln_qkv_plain(x, ln_scale, ln_bias, w, b_qkv, eps),
                                  heads, bias)
    if on_kernels:
        if is_quantized(w):
            return lqa.ln_qkv_attention_q8(x.contiguous(), ln_scale, ln_bias, w.q, w.scale,
                                           b_qkv, key_bias, heads, eps)
        args = (x.contiguous(), ln_scale, ln_bias, w, b_qkv, key_bias, heads, eps)
        if grad_needed(x, ln_scale, ln_bias, w, b_qkv):
            return ag.LnQkvAttention.apply(*args)
        return lqa.ln_qkv_attention(*args)
    return lqa.ln_qkv_attention_plain(x, ln_scale, ln_bias, w, b_qkv,
                                      key_bias, heads, eps)


def attn_proj_core(attn, w_proj, b_proj, compute_dtype=None):
    """Output projection (pallas_attention._xla_proj): compute-dtype operands,
    fp32 accumulation and bias, result in the compute dtype."""
    w = w_proj.to(compute_dtype or attn.dtype)
    return (quant_dot(attn.to(w.dtype), w) + b_proj.float()).to(w.dtype)


def _fused_proj(x, key_bias) -> bool:
    """The fused attention branch's gate (#4/#6): UVLTRACK_FUSED_PROJ=1 on
    the kernels, a key-padding bias and the prefix fused."""
    return (key_bias is not None and _on_kernels(x, x.shape[1]) and fused_prefix()
            and os.environ.get("UVLTRACK_FUSED_PROJ", "0") == "1")


def attention_block_core(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                         heads: int, bias=None, compute_dtype=None,
                         eps: float = 1e-6):
    """x + proj(attn(qkv(LN(x)))): the first half of VitBlock. With
    UVLTRACK_FUSED_PROJ=1 on the kernels, a key-padding bias and the prefix
    fused, one fused branch (#4 for fp weights, #6 for int8 ones; a mixed
    pair stays composed)."""
    compute_dtype = compute_dtype or x.dtype
    b, n, _ = x.shape
    key_bias = _key_padding(bias, b, n, x.device)
    if _fused_proj(x, key_bias):
        quant_qkv, quant_proj = is_quantized(w_qkv), is_quantized(w_proj)
        if quant_qkv and quant_proj:
            return lqp.ln_qkv_attn_proj_q8(
                x.contiguous(), ln_scale, ln_bias, w_qkv.q, w_qkv.scale, b_qkv,
                w_proj.q, w_proj.scale, b_proj, key_bias, heads, eps)
        if not (quant_qkv or quant_proj):
            w, wp = w_qkv.to(compute_dtype), w_proj.to(compute_dtype)
            args = (x.contiguous(), ln_scale, ln_bias, w, b_qkv, wp, b_proj, key_bias, heads, eps)
            if grad_needed(x, ln_scale, ln_bias, w, b_qkv, wp, b_proj):
                return ag.LnQkvAttnProj.apply(*args)
            return lqp.ln_qkv_attn_proj(*args)
    attn = attention_ln_qkv_core(x, ln_scale, ln_bias, w_qkv, b_qkv, heads,
                                 bias, compute_dtype=compute_dtype, eps=eps)
    return x + attn_proj_core(attn, w_proj, b_proj,
                              compute_dtype=compute_dtype).to(x.dtype)


def attn_proj_partial_core(x, attn, w_proj, bias=None, compute_dtype=None,
                           fused: bool = True):
    """Tensor parallelism: this rank's share of the projection of its heads'
    attention output `attn` (B, N, C/tp), before the bias: (partial (B, N,
    C) fp32, the dtype the caller rounds the summed projection + bias to
    before the residual add). Where attention_block_core would take #4
    (`fused` and its gate), `proj_residual` on a zero fp32 stream, and x's
    dtype (#4's one rounding); else the plain product and the compute dtype
    (attn_proj_core's rounding)."""
    compute_dtype = compute_dtype or x.dtype
    wp = w_proj.to(compute_dtype)
    a = attn.to(wp.dtype)
    if fused and _fused_proj(x, _key_padding(bias, x.shape[0], x.shape[1], x.device)):
        part = ag.ProjPartial.apply(a, wp) if grad_needed(a, wp) else lqp.proj_partial(a, wp)
        return part, x.dtype
    return lqp.proj_partial_plain(a, wp), compute_dtype


def ln_mlp_partial_core(x, ln_scale, ln_bias, w1, b1, w2, compute_dtype=None,
                        eps: float = 1e-6):
    """Tensor parallelism: this rank's share of ln_mlp_core before the bias
    (its F/tp hidden columns), (B, N, C) fp32; kernel #7 with an fp32 out
    under UVLTRACK_FUSED_MLP=1 past the gate, else its plain version."""
    compute_dtype = compute_dtype or x.dtype
    w1, w2 = w1.to(compute_dtype), w2.to(compute_dtype)
    if _on_kernels(x, x.shape[1]) and os.environ.get("UVLTRACK_FUSED_MLP", "0") == "1":
        args = (x.contiguous(), ln_scale, ln_bias, w1, b1, w2, eps)
        if grad_needed(x, ln_scale, ln_bias, w1, b1, w2):
            return ag.LnMlpPartial.apply(*args)
        return lm.ln_mlp_partial(*args)
    return lm.ln_mlp_partial_plain(x, ln_scale, ln_bias, w1, b1, w2, eps)


def ln_mlp_core(x, ln_scale, ln_bias, w1, b1, w2, b2, compute_dtype=None,
                eps: float = 1e-6):
    """Pre-LN LayerNorm + fc1 + exact GELU + fc2: the (B, N, C) MLP output
    before the residual, in the compute dtype; fp or int8 weights. Kernel
    #7 under UVLTRACK_FUSED_MLP=1 for fp weights past the gate, else its
    plain version (pallas_attention._xla_ln_mlp)."""
    compute_dtype = compute_dtype or x.dtype
    w1, w2 = w1.to(compute_dtype), w2.to(compute_dtype)
    if (_on_kernels(x, x.shape[1]) and os.environ.get("UVLTRACK_FUSED_MLP", "0") == "1"
            and not (is_quantized(w1) or is_quantized(w2))):
        args = (x.contiguous(), ln_scale, ln_bias, w1, b1, w2, b2, eps)
        if grad_needed(x, ln_scale, ln_bias, w1, b1, w2, b2):
            return ag.LnMlp.apply(*args)
        return lm.ln_mlp(*args)
    return lm.ln_mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, eps)
