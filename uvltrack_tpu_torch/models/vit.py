"""MAE-style ViT pieces of the modality-unified extractor (port of
uvltrack_tpu/models/vit.py): fixed 2D sin-cos position embeddings, the 16x16
patch embedding and the pre-LN transformer block with additive key masking.

Module and parameter names follow the reference ViT (lib/models/backbones/
mae_vit.py: blocks.{i}.norm1 / attn.qkv / attn.proj / norm2 / mlp.fc1 /
mlp.fc2; LayerScale's ls1.gamma / ls2.gamma), so reference-keyed state
dicts load directly. DropPath and LayerScale (off in the shipped configs)
take the composed branch of the block, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.attention import (attention_block_core, attention_ln_qkv_core, attn_proj_core,
                             key_padding_bias, ln_mlp_core)
from ..ops.quant import weight_of


def sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """(M,) positions -> (M, embed_dim) [sin | cos] embedding."""
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_2d(embed_dim: int, grid_size: int) -> np.ndarray:
    """(grid*grid, embed_dim); first half encodes the column index, second
    half the row, tokens row-major (mae_vit.py:52-78)."""
    assert embed_dim % 2 == 0
    rows = np.repeat(np.arange(grid_size, dtype=np.float64), grid_size)
    cols = np.tile(np.arange(grid_size, dtype=np.float64), grid_size)
    return np.concatenate([sincos_1d(embed_dim // 2, cols),
                           sincos_1d(embed_dim // 2, rows)], axis=1)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class LayerScale(nn.Module):
    """Per-channel residual-branch scale (backbones/utils.py:24-31)."""

    def __init__(self, dim: int, init_values: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))


class VitBlock(nn.Module):
    """Pre-LN block: x += proj(attn(LN1 x)); x += mlp(LN2 x). The LN and
    Linear modules hold parameters only; the math is ops/attention.py's, so
    the attention half reaches the CUDA kernels on the "cuda" backend. The
    four Linear weights go as they are held: bf16/fp32 tensors, or int8
    QuantizedTensors after prepare_inference_model (weight_of).

    drop_path > 0 is stochastic depth on both residual branches: forward's
    `keep`, a (2, B) bool mask a sample (one row a branch, drawn by the
    caller from its generator: models/mufe.py), zeroes a sample's branch or
    divides it by 1 - drop_path. init_values enables LayerScale (ls1, ls2).
    Either one needs the branch before the residual add, so the attention
    half then runs composed (attention_ln_qkv_core, attn_proj_core), as the
    JAX VitBlock does."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32, drop_path: float = 0.0,
                 init_values: float | None = None):
        super().__init__()
        self.dtype, self.drop_path = dtype, drop_path
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls1 = LayerScale(dim, init_values) if init_values is not None else None
        self.ls2 = LayerScale(dim, init_values) if init_values is not None else None

    def _branch(self, delta, ls, keep):
        if ls is not None:
            delta = delta * ls.gamma.to(delta.dtype)
        if keep is not None:
            delta = delta * keep.to(delta.dtype)[:, None, None] / (1.0 - self.drop_path)
        return delta

    def forward(self, x: torch.Tensor, key_masked: torch.Tensor | None = None,
                keep: torch.Tensor | None = None):
        bias = key_padding_bias(key_masked) if key_masked is not None else None
        a, ln = self.attn, self.norm1
        if self.ls1 is None and keep is None:
            # proj + residual fusable into the kernel (attention_block_core)
            x = attention_block_core(
                x, ln.weight, ln.bias, weight_of(a.qkv), a.qkv.bias,
                weight_of(a.proj), a.proj.bias, a.num_heads, bias,
                compute_dtype=self.dtype)
        else:
            attn = attention_ln_qkv_core(x, ln.weight, ln.bias, weight_of(a.qkv), a.qkv.bias,
                                         a.num_heads, bias, compute_dtype=self.dtype)
            attn = attn_proj_core(attn, weight_of(a.proj), a.proj.bias, compute_dtype=self.dtype)
            x = x + self._branch(attn.to(x.dtype), self.ls1,
                                 None if keep is None else keep[0])
        m = self.mlp
        mlp_out = ln_mlp_core(x, self.norm2.weight, self.norm2.bias,
                              weight_of(m.fc1), m.fc1.bias, weight_of(m.fc2),
                              m.fc2.bias, compute_dtype=self.dtype)
        return x + self._branch(mlp_out, self.ls2, None if keep is None else keep[1])


class PatchEmbed(nn.Module):
    """16x16 stride-16 conv patch embedding shared by template and search:
    NHWC image in, (B, H/p * W/p, C) row-major tokens out."""

    def __init__(self, embed_dim: int, patch_size: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        # flax Conv(dtype): operands and bias in the compute dtype
        dt = self.dtype
        x = torch.nn.functional.conv2d(img.permute(0, 3, 1, 2).to(dt),
                                       self.proj.weight.to(dt),
                                       stride=self.proj.stride)
        x = x + self.proj.bias.to(dt)[None, :, None, None]
        return x.flatten(2).transpose(1, 2)


VIT_VARIANTS = {
    # embed_dim, depth, num_heads  (mae_vit.py:218-242)
    "base": dict(embed_dim=768, depth=12, num_heads=12),
    "large": dict(embed_dim=1024, depth=24, num_heads=16),
    "huge": dict(embed_dim=1280, depth=32, num_heads=16),
}


def vit_variant_from_path(pretrained_path: str) -> str:
    if "large" in pretrained_path:
        return "large"
    if "huge" in pretrained_path:
        return "huge"
    return "base"
