"""Attention entry points with a backend switch (port of
uvltrack_tpu/ops/attention.py).

Backends: "plain" (the JAX package's "xla": composed PyTorch math) and
"cuda" (its "pallas": the hand-written kernels of ops/ln_qkv_attention.py),
which is the default. build_model sets the backend from
cfg.TPU.USE_PALLAS_ATTENTION; force_backend pins it process-wide
(chip_smoke.py's plain-vs-kernel A/B), and force_backend(None) goes back to
the backend set_backend chose last.

On the "cuda" backend, attention_ln_qkv_core takes the kernels for a CUDA
tensor with N >= 128 (the JAX package's min_seq_len gate), and the plain
math otherwise: CPU tensors and BERT's 40-token layers. The kernels take bf16
weights only, so an fp32 model on the card raises there; it runs on the
"plain" backend. The fused proj/MLP/int8 kernels of the JAX package are not
on the tracking path and are not ported yet (ROADMAP.md).

Semantics of the reference blocks: scores = q.k^T * scale + additive key
bias (-1e10 at masked ViT keys, lib/models/backbones/block.py:47-61; BERT
-10000), softmax in fp32, then probs.v.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import ln_qkv_attention as lqa

_BACKENDS = ("plain", "cuda")
_CONFIGURED = "cuda"  # set_backend's last choice
_OVERRIDE = None  # force_backend pin: wins over later set_backend calls
_BACKEND = _CONFIGURED  # the backend in effect
MIN_SEQ_LEN = 128  # pallas_attention.min_seq_len: BERT's N=40 stays plain


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


def _as_key_bias(bias, b: int, n: int, device) -> torch.Tensor:
    """None -> zeros; a (B, 1, 1, N) key-padding bias -> (B, N) fp32."""
    if bias is None:
        return torch.zeros((b, n), dtype=torch.float32, device=device)
    if bias.ndim == 4 and bias.shape[1] == 1 and bias.shape[2] == 1:
        return bias[:, 0, 0, :].float().contiguous()
    raise ValueError(f"only key-padding biases (B,1,1,N) are supported, got "
                     f"{tuple(bias.shape)}")


def plain_attention(q, k, v, bias=None):
    """Counterpart of xla_attention: q,k,v (B, H, N, D), fp32 logits and
    softmax, probs cast to v's dtype for the product. Returns v.dtype."""
    d = q.shape[-1]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d ** -0.5
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def attention_ln_qkv_core(x, ln_scale, ln_bias, w_qkv, b_qkv, heads: int,
                          bias=None, compute_dtype=None, eps: float = 1e-6):
    """Pre-LN LayerNorm + fused qkv projection + masked attention from the
    residual stream x (B, N, C); w_qkv in Linear layout (3C, C). Returns the
    (B, N, C) attention output before the projection."""
    compute_dtype = compute_dtype or x.dtype
    b, n, _ = x.shape
    key_bias = _as_key_bias(bias, b, n, x.device)
    w = w_qkv.to(compute_dtype)
    if _BACKEND == "cuda" and x.is_cuda and n >= MIN_SEQ_LEN:
        return lqa.ln_qkv_attention(x.contiguous(), ln_scale, ln_bias, w,
                                    b_qkv, key_bias, heads, eps)
    return lqa.ln_qkv_attention_plain(x, ln_scale, ln_bias, w, b_qkv,
                                      key_bias, heads, eps)


def attn_proj_core(attn, w_proj, b_proj, compute_dtype=None):
    """Output projection (pallas_attention._xla_proj): compute-dtype operands,
    fp32 accumulation and bias, result in the compute dtype."""
    w = w_proj.to(compute_dtype or attn.dtype)
    return (lqa.dot_f32(attn.to(w.dtype), w) + b_proj.float()).to(w.dtype)


def attention_block_core(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                         heads: int, bias=None, compute_dtype=None,
                         eps: float = 1e-6):
    """x + proj(attn(qkv(LN(x)))): the first half of VitBlock."""
    attn = attention_ln_qkv_core(x, ln_scale, ln_bias, w_qkv, b_qkv, heads,
                                 bias, compute_dtype=compute_dtype, eps=eps)
    return x + attn_proj_core(attn, w_proj, b_proj,
                              compute_dtype=compute_dtype).to(x.dtype)


def ln_mlp_core(x, ln_scale, ln_bias, w1, b1, w2, b2, compute_dtype=None,
                eps: float = 1e-6):
    """Pre-LN LayerNorm + fc1 + exact GELU + fc2 (pallas_attention._xla_ln_mlp):
    the (B, N, C) MLP output before the residual, in the compute dtype."""
    compute_dtype = compute_dtype or x.dtype
    w1, w2 = w1.to(compute_dtype), w2.to(compute_dtype)
    y = lqa.layer_norm_fast_var(x, ln_scale, ln_bias, eps)
    h = F.gelu(lqa.dot_f32(y.to(w1.dtype), w1) + b1.float())
    o = lqa.dot_f32(h.to(w2.dtype), w2)
    return (o + b2.float()).to(w2.dtype)
