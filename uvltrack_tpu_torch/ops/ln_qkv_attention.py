"""Fused LayerNorm + qkv + masked attention: the CUDA port of the Pallas kernel
uvltrack_tpu/ops/pallas_attention.py::_ln_qkv_attn_kernel (:167,
`fused_ln_qkv_attention` :207) and, through its second half, of
`_attn_kernel_qkv` (:119, `fused_attention_qkv` :143).

The TPU kernel is one program per batch element (grid=(B,)) with the (C, 3C)
weight resident in 16 MB of VMEM. At batch 1 that would be one block on one
of the H100's 132 SMs, so the port splits it in two kernels
(csrc/ln_qkv.cu, csrc/qkv_attention.cu; design and bounds in their notes):

- `ln_qkv`: LN (fp32, fast variance clamped at 0) normalized as the A tile
  loads, bf16 tensor-core product against W, fp32 bias, bf16 out (B, N, 3C).
- `qkv_attention`: per (query tile, head, batch) block,
  exp(clip(q.k*D^-1/2 + key_bias, +-80)), fp32 row sums, bf16 P.V, division
  at the end; out (B, N, C) before the output projection.

The cost of the split is one bf16 (N, 3C) round trip (1.66 MB at N=361),
which stays in the 50 MB L2.

Each wrapper checks device, dtype, shape and contiguity, launches on
PyTorch's current stream, raises on a nonzero cudaGetLastError, and counts
its launches in `<wrapper>.launches`. A CPU tensor takes the plain PyTorch
version beside it; a CUDA tensor launches the kernel or raises. The plain
versions compute the same function with the same rounding points and are
what the CPU tests hold against the JAX package.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

CLAMP = 80.0  # exp-safe score range of the kernels (pallas_attention._CLAMP)


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


def dot_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w.T with fp32 accumulation and an fp32 result, for a Linear-layout
    weight w (out, in): the port of quant_dot / preferred_element_type=f32.
    Products of bf16 values are exact in fp32, so upcasting first gives the
    same numbers as a bf16 product that accumulates and returns in fp32."""
    return torch.matmul(a.float(), w.float().t())


def ln_qkv_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, eps: float = 1e-6):
    """Plain version of `ln_qkv` (pallas_attention._xla_ln_qkv)."""
    y = layer_norm_fast_var(x, ln_scale, ln_bias, eps).to(w_qkv.dtype)
    return (dot_f32(y, w_qkv) + b_qkv.float()).to(w_qkv.dtype)


def qkv_attention_plain(qkv, key_bias, heads: int):
    """Plain version of `qkv_attention`: the kernel's clamped, late-divided
    softmax (pallas_attention._attn_kernel_qkv's math)."""
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
    """Plain version of `ln_qkv_attention` (kernel #1's function)."""
    qkv = ln_qkv_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, eps)
    return qkv_attention_plain(qkv, key_bias, heads)


# ---------------------------------------------------------------- kernels
_FNS = {}


def _fn(lib_name: str, sym: str, argtypes):
    key = (lib_name, sym)
    if key not in _FNS:
        lib = build.library(lib_name)
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[key] = (lib, fn)
    return _FNS[key]


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        _require(t.is_cuda and t.device == dev,
                 f"{name}: all tensors must be on one CUDA device, got {t.device}")
        _require(t.is_contiguous(), f"{name}: tensors must be contiguous")
        _require(t.data_ptr() % 16 == 0, f"{name}: tensors must be 16-byte aligned")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ln_qkv(x, ln_scale, ln_bias, w_qkv, b_qkv, eps: float = 1e-6):
    """x (B, N, C) bf16|fp32; ln_scale, ln_bias (C,) fp32; w_qkv (3C, C) bf16
    (Linear layout); b_qkv (3C,) fp32 -> (B, N, 3C) bf16."""
    if x.device.type == "cpu":
        return ln_qkv_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, eps)
    b, n, c = x.shape
    f = 3 * c
    _require(x.dtype in (torch.bfloat16, torch.float32),
             f"ln_qkv: x must be bf16 or fp32, got {x.dtype}")
    _require(w_qkv.dtype == torch.bfloat16, f"ln_qkv: w_qkv must be bf16, got {w_qkv.dtype}")
    _require(all(t.dtype == torch.float32 for t in (ln_scale, ln_bias, b_qkv)),
             "ln_qkv: LN scale/bias and qkv bias must be fp32")
    _require(tuple(w_qkv.shape) == (f, c) and tuple(b_qkv.shape) == (f,)
             and tuple(ln_scale.shape) == (c,) and tuple(ln_bias.shape) == (c,),
             f"ln_qkv: bad shapes for C={c}")
    _require(c % 64 == 0, f"ln_qkv: C must be a multiple of 64, got {c}")
    _check_cuda("ln_qkv", x, ln_scale, ln_bias, w_qkv, b_qkv)
    out = torch.empty((b, n, f), dtype=torch.bfloat16, device=x.device)
    lib, fn = _fn("ln_qkv", "uvl_ln_qkv", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    rc = fn(x.data_ptr(), int(x.dtype == torch.float32), ln_scale.data_ptr(),
            ln_bias.data_ptr(), w_qkv.data_ptr(), b_qkv.data_ptr(),
            out.data_ptr(), b * n, c, f, eps, _stream(x))
    build.check(lib, rc, "ln_qkv")
    ln_qkv.launches += 1
    return out


ln_qkv.launches = 0


def qkv_attention(qkv, key_bias, heads: int):
    """qkv (B, N, 3*H*64) bf16; key_bias (B, N) fp32 additive -> (B, N, H*64)
    bf16."""
    if qkv.device.type == "cpu":
        return qkv_attention_plain(qkv, key_bias, heads)
    b, n, f = qkv.shape
    _require(qkv.dtype == torch.bfloat16, f"qkv_attention: qkv must be bf16, got {qkv.dtype}")
    _require(key_bias.dtype == torch.float32 and tuple(key_bias.shape) == (b, n),
             "qkv_attention: key_bias must be (B, N) fp32")
    _require(f == 3 * heads * 64, f"qkv_attention: head dim must be 64 (F={f}, H={heads})")
    _check_cuda("qkv_attention", qkv, key_bias)
    out = torch.empty((b, n, f // 3), dtype=torch.bfloat16, device=qkv.device)
    lib, fn = _fn("qkv_attention", "uvl_qkv_attention", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p])
    rc = fn(qkv.data_ptr(), key_bias.data_ptr(), out.data_ptr(), b, n, heads,
            64, 64 ** -0.5, _stream(qkv))
    build.check(lib, rc, "qkv_attention")
    qkv_attention.launches += 1
    return out


qkv_attention.launches = 0


def ln_qkv_attention(x, ln_scale, ln_bias, w_qkv, b_qkv, key_bias,
                     heads: int, eps: float = 1e-6):
    """Kernel #1's function: (B, N, C) residual stream -> (B, N, C)
    attention output before the projection. On a CUDA tensor: `ln_qkv`
    then `qkv_attention`, two launches."""
    qkv = ln_qkv(x, ln_scale, ln_bias, w_qkv, b_qkv, eps)
    return qkv_attention(qkv, key_bias, heads)


def launch_counts() -> dict:
    return {"ln_qkv": ln_qkv.launches, "qkv_attention": qkv_attention.launches}


def reset_launch_counts() -> None:
    ln_qkv.launches = 0
    qkv_attention.launches = 0
