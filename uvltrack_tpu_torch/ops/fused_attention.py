"""Masked multi-head attention on head-major q, k, v: the CUDA port of the Pallas
kernel uvltrack_tpu/ops/pallas_attention.py::_attn_kernel (:78, entry
`fused_attention` :96), kernel #3.

The JAX package reaches it only through attention_core (ops/attention.py),
which BERT's layers call (uvltrack_tpu/models/bert.py:85), on the Pallas
backend for N >= min_seq_len() (UVLTRACK_PALLAS_MIN_N, default 128). The
shipped configurations run BERT at N = MAX_QUERY_LEN = 40, so the kernel
engages with UVLTRACK_PALLAS_MIN_N <= 40 or with queries of 128 tokens or
more; the port's attention_core gates it the same way.

    e   = exp(clip(q . k * D^-1/2 + key_bias, -80, 80))    fp32
    out = (v.dtype(e) . v) * (1 / sum_k e)                 fp32 sums, out in v's dtype

The kernel (csrc/attention.cu) is csrc/attention.cuh's bf16 TMA + wgmma
body, which csrc/qkv_attention.cu (kernel #2) shares; its tensor maps take
q, k and v with their (batch, token, head) strides, so BERT's (B, H, N, D)
views of its (B, N, C) products go in without a copy, and it writes (B, N,
H, D), returned as a (B, H, N, D) view. bf16 and D = 64 only, as the other
attention wrappers.

The wrapper checks, launches and counts through ops/build.py; a CPU tensor
takes the plain version, which follows _attn_kernel's rounding points and is
what the CPU tests hold against the Pallas interpreter.
"""

from __future__ import annotations

import torch

from ..utils.costs import counted, nbytes
from . import build, library
from .build import FLOAT, I64, INT, PTR, no_grad_through, require
from .ln_qkv_attention import CLAMP


def attention_work(q, k, v, bias=None):
    """(FLOPs, bytes) of one attention over (B, H, N, D) q, k, v and an
    additive bias (utils/costs.py): kernel #3's, its plain version's and
    ops/attention.py::plain_attention's, so BERT's layers count the same on
    either side of the kernel gate (a key-padding bias is (B, N) fp32 on
    both)."""
    b, h, n, d = q.shape
    return 4 * b * h * n * n * d, nbytes(q, k, v, bias) + nbytes(q) // q.element_size() * v.element_size()


# ----------------------------------------------------------------- plain
@counted(attention_work)
def fused_attention_plain(q, k, v, key_bias):
    """q, k, v (B, H, N, D); key_bias (B, N) fp32 additive -> (B, H, N, D)
    in v's dtype: fp32 scores times D^-1/2, exp(clip(s + bias, +-80)), e cast
    to v's dtype for the fp32-accumulated P.V, division by the fp32 row sum
    last (as a product with its reciprocal)."""
    d = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d ** -0.5
    e = torch.exp((s + key_bias.float()[:, None, None, :]).clamp(-CLAMP, CLAMP))
    o = torch.matmul(e.to(v.dtype).float(), v.float())
    return (o * (1.0 / e.sum(-1, keepdim=True))).to(v.dtype)


# ---------------------------------------------------------------- kernel
@counted(attention_work)
def fused_attention(q, k, v, key_bias):
    """q, k, v (B, H, N, 64) bf16, any strides with a contiguous head dim (the
    same for all three); key_bias (B, N) fp32 -> (B, H, N, 64) bf16, a view
    of a contiguous (B, N, H, 64) tensor."""
    if torch.compiler.is_exporting():
        return library.attention(q, k, v, key_bias).transpose(1, 2)
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, key_bias)
    b, h, n, d = q.shape
    no_grad_through("attention", (q, k, v, key_bias),
                    "kernel #3 has no VJP (nor has the JAX package's): train with "
                    f"UVLTRACK_PALLAS_MIN_N above BERT's sequence length (N={n})")
    require(all(t.dtype == torch.bfloat16 for t in (q, k, v)),
            f"attention: q, k, v must be bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    require(d == 64, f"attention: head dim must be 64, got {d}")
    require(k.shape == q.shape and v.shape == q.shape, "attention: q, k, v shapes differ")
    require(k.stride() == q.stride() and v.stride() == q.stride() and q.stride(3) == 1,
            "attention: q, k, v need one set of strides and a contiguous head dim")
    sb, sh, sn = q.stride(0), q.stride(1), q.stride(2)
    require(sb % 8 == 0 and sh % 8 == 0 and sn % 8 == 0,
            "attention: strides must be multiples of 8 elements (16-byte rows)")
    require(key_bias.dtype == torch.float32 and tuple(key_bias.shape) == (b, n)
            and key_bias.is_contiguous(), "attention: key_bias must be (B, N) fp32")
    for t in (q, k, v, key_bias):
        require(t.is_cuda and t.device == q.device,
                f"attention: all tensors must be on one CUDA device, got {t.device}")
        require(t.data_ptr() % 16 == 0, "attention: tensors must be 16-byte aligned")
    out = torch.empty((b, n, h, d), dtype=torch.bfloat16, device=q.device)
    build.launch("attention", "bf16",
                 [PTR, PTR, PTR, I64, INT, INT, PTR, PTR, INT, INT, INT, INT, FLOAT],
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), sb, sn, sh, key_bias.data_ptr(),
                 out.data_ptr(), b, n, h, d, d ** -0.5, stream_of=q)
    return out.transpose(1, 2)
