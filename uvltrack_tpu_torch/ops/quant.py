"""Weight-only int8 inference (port of uvltrack_tpu/ops/quant.py).

Symmetric per-output-channel int8 of the large matmul and conv weights:

    q[o, ...] = clip(round(w[o, ...] / scale[o]), -127, 127)
    scale[o]  = max(max |w[o, ...]|, 1e-12) / 127

The port keeps PyTorch's layouts, whose output channel is the FIRST axis
(Linear (out, in), Conv2d (O, I, kh, kw)), so the scale is per row. The
recipe and its order are the JAX package's: fp32 amax, fp32 division,
round half to even, clip; quantizing the bf16-cast weight (as
prepare_inference_model does, cast first) gives the JAX payload and scale
bit for bit.

A quantized module holds its weight as two buffers, `weight_q` (int8) and
`weight_scale` (fp32), in place of the `weight` parameter; `weight_of`
reads either form. Buffers are not parameters, so cast_inference_params
never touches them, and they move with the module (.to, .cpu, deepcopy).

The math never makes a dense dequantized weight: quant_dot contracts the
int8 payload (exact in bf16 and fp32) and scales the fp32 result per output
column, the scale lifted out of the contraction. On the card, the int8
attention prefix (and, with UVLTRACK_FUSED_PROJ=1, the projection) runs in
the CUDA kernels of ops/ln_qkv_attention.py and ops/ln_qkv_attn_proj.py; the
MLP, the composed projection and the head's convs are plain products here.
"""

from __future__ import annotations

import re
from typing import Union

import torch
from torch import nn


class QuantizedTensor:
    """int8 payload (out, ...) + fp32 (out,) scale standing in for a weight.
    `dtype` is the compute dtype its consumers contract in (`.to(dtype)`
    changes only that, as astype does in the JAX package)."""

    __slots__ = ("q", "scale", "dtype")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor,
                 dtype: torch.dtype = torch.float32):
        self.q = q          # (out, ...) int8
        self.scale = scale  # (out,) float32
        self.dtype = dtype

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.ndim

    def to(self, dtype: torch.dtype) -> "QuantizedTensor":
        return QuantizedTensor(self.q, self.scale, dtype)

    def materialize(self, dtype: torch.dtype | None = None) -> torch.Tensor:
        """Dense w = q * scale (fp32 product, cast to the compute dtype);
        the hot paths use quant_dot instead."""
        s = self.scale.float().reshape(-1, *([1] * (self.q.ndim - 1)))
        return (self.q.float() * s).to(dtype or self.dtype)


Weight = Union[torch.Tensor, QuantizedTensor]


def is_quantized(w) -> bool:
    return isinstance(w, QuantizedTensor)


def quantize_weight(w: torch.Tensor) -> QuantizedTensor:
    """Symmetric per-output-channel int8 of a weight whose FIRST axis is
    the output channel (quantize_weight of the JAX package on the
    transposed layout)."""
    assert w.ndim >= 2, f"need a weight with an out-channel axis, got {tuple(w.shape)}"
    w32 = w.detach().float()
    amax = w32.abs().amax(dim=tuple(range(1, w.ndim)))
    scale = amax.clamp_min(1e-12) / 127.0
    q = torch.round(w32 / scale.reshape(-1, *([1] * (w.ndim - 1)))).clamp(-127, 127)
    return QuantizedTensor(q.to(torch.int8), scale)


def dot_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w.T with fp32 accumulation and an fp32 result, for a Linear-layout
    weight w (out, in): the port of preferred_element_type=f32. Products of
    bf16 or int8 values are exact in fp32, so upcasting first gives the same
    numbers as a bf16 product that accumulates and returns in fp32. On the
    card the default path's bf16 products take
    ops/ln_qkv_attn_proj.py::dense_f32 (the GEMM core) instead; this upcast
    stays the product of the CPU, of int8 and fp32 weights and of training,
    and the plain version the card's kernel checks read."""
    return torch.matmul(a.float(), w.float().t())


def quant_dot(y: torch.Tensor, w: Weight) -> torch.Tensor:
    """fp32-accumulated y @ w.T for a dense weight or a QuantizedTensor (the
    int8 payload contracted, the fp32 result scaled per output column).
    Returns fp32."""
    if isinstance(w, QuantizedTensor):
        return dot_f32(y, w.q) * w.scale.float()
    return dot_f32(y, w)


# ------------------------------------------------------------ module surgery
def weight_of(module: nn.Module) -> Weight:
    """A Linear's or Conv2d's weight: the `weight` parameter, or the
    QuantizedTensor of its int8 buffers once quantized."""
    q = module._buffers.get("weight_q")
    if q is None:
        return module.weight
    return QuantizedTensor(q, module._buffers["weight_scale"])


def quantize_module(module: nn.Module) -> bool:
    """In place: replace the `weight` parameter by int8 `weight_q` and fp32
    `weight_scale` buffers. A module already quantized is left as it is.
    Returns whether it quantized."""
    if "weight_q" in module._buffers:
        return False
    qt = quantize_weight(module.weight.data)
    del module.weight
    module.register_buffer("weight_q", qt.q)
    module.register_buffer("weight_scale", qt.scale)
    return True


# module names quantized (quantize_vit_params' selection, in the port's
# reference-named tree): the four matmul weights of every ViT block, and the
# 3x3 convs of the head's four towers (stages 0-3; never the final 1x1 at
# index 4, BERT or the patch embedding)
_VIT_LINEAR = re.compile(r"^backbone\.vit\.blocks\.\d+\.(attn\.(qkv|proj)|mlp\.(fc1|fc2))$")
_HEAD_CONV = re.compile(r"^box_head\.conv_[a-z_]+\.[0-3]\.0$")


def quantize_vit_params(model: nn.Module, min_dim: int = 128) -> nn.Module:
    """In place: quantize every ViT-block Linear whose smaller side is at
    least min_dim, and every head tower 3x3 conv with at least min_dim
    output channels (stages 0/1 at the shipped 256-channel head). min_dim
    keeps toy models fp; the tests pass it explicitly. Idempotent."""
    for name, m in model.named_modules():
        if _VIT_LINEAR.match(name):
            big = min(weight_of(m).shape) >= min_dim
        elif _HEAD_CONV.match(name):
            big = weight_of(m).shape[0] >= min_dim
        else:
            continue
        if big:
            quantize_module(m)
    return model


def quantized_modules(model: nn.Module):
    return [(n, m) for n, m in model.named_modules() if "weight_q" in m._buffers]


def count_quantized(model: nn.Module) -> int:
    return len(quantized_modules(model))


def quantized_bytes_saved(model: nn.Module) -> int:
    """Bytes saved per full bf16 weight read (bf16 stream -> int8 payload +
    fp32 scale)."""
    return sum(m.weight_q.numel() - m.weight_scale.numel() * 4
               for _, m in quantized_modules(model))
