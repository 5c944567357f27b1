"""MAE-style ViT pieces of the modality-unified extractor (port of
uvltrack_tpu/models/vit.py): fixed 2D sin-cos position embeddings, the 16x16
patch embedding and the pre-LN transformer block with additive key masking.

Module and parameter names follow the reference ViT (lib/models/backbones/
mae_vit.py: blocks.{i}.norm1 / attn.qkv / attn.proj / norm2 / mlp.fc1 /
mlp.fc2), so reference-keyed state dicts load directly. LayerScale and
DropPath are inference-dead in the shipped configs and are not ported.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.attention import attention_block_core, key_padding_bias, ln_mlp_core
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


class VitBlock(nn.Module):
    """Pre-LN block: x += proj(attn(LN1 x)); x += mlp(LN2 x). The LN and
    Linear modules hold parameters only; the math is ops/attention.py's, so
    the attention half reaches the CUDA kernels on the "cuda" backend. The
    four Linear weights go as they are held: bf16/fp32 tensors, or int8
    QuantizedTensors after prepare_inference_model (weight_of)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, key_masked: torch.Tensor | None = None):
        bias = key_padding_bias(key_masked) if key_masked is not None else None
        a = self.attn
        x = attention_block_core(
            x, self.norm1.weight, self.norm1.bias, weight_of(a.qkv), a.qkv.bias,
            weight_of(a.proj), a.proj.bias, a.num_heads, bias,
            compute_dtype=self.dtype)
        m = self.mlp
        return x + ln_mlp_core(x, self.norm2.weight, self.norm2.bias,
                               weight_of(m.fc1), m.fc1.bias, weight_of(m.fc2),
                               m.fc2.bias, compute_dtype=self.dtype)


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
