"""BERT text encoder pieces (port of uvltrack_tpu/models/bert.py): word +
position + type embeddings with LayerNorm(eps=1e-12), post-LN encoder layers
with exact-GELU intermediate, and the additive (1-mask)*-10000 attention bias
(lib/models/backbones/bert_backbone.py:740-751). The self-attention goes
through ops/attention.py::attention_core, as the JAX package's BertLayer
does, so with UVLTRACK_PALLAS_MIN_N <= 40 on the card it runs kernel #3.

Module names follow the reference BERT (embeddings.*, encoder.layer.{i}.
attention.self.{query,key,value}, attention.output.{dense,LayerNorm},
intermediate.dense, output.{dense,LayerNorm}).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..ops.attention import attention_core
from ..ops.ln_qkv_attention import layer_norm_fast_var


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2

    @staticmethod
    def base() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def large() -> "BertConfig":
        return BertConfig(hidden_size=1024, num_layers=24, num_heads=16,
                          intermediate_size=4096)


def bert_config_from_type(type_str: str) -> BertConfig:
    return BertConfig.large() if "large" in type_str else BertConfig.base()


def flax_layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """flax nn.LayerNorm(dtype=fp32) as the JAX package runs it: fp32 fast
    variance clamped at 0. Returns fp32."""
    return layer_norm_fast_var(x, ln.weight, ln.bias, ln.eps)


def dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax nn.Dense(dtype=...): input, kernel and bias cast to the compute
    dtype; the product and the bias add each round to it."""
    return torch.matmul(x.to(dtype), lin.weight.to(dtype).t()) + lin.bias.to(dtype)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=1e-12)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        seq = input_ids.shape[1]
        ids = input_ids.long()
        words = self.word_embeddings.weight.to(dt)[ids]
        pos = self.position_embeddings.weight.to(dt)[:seq][None]
        types = self.token_type_embeddings.weight.to(dt)[torch.zeros_like(ids)]
        return flax_layer_norm(words + pos + types, self.LayerNorm)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.query = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.key = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.value = nn.Linear(cfg.hidden_size, cfg.hidden_size)


class BertDenseNorm(nn.Module):
    """Reference `*.output` container: dense + post-LN LayerNorm."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        self.LayerNorm = nn.LayerNorm(d_out, eps=1e-12)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = BertDenseNorm(cfg.hidden_size, cfg.hidden_size)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)


class BertLayer(nn.Module):
    """Post-LN BERT encoder layer taking an additive (B, 1, 1, N) bias."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertDenseNorm(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor | None) -> torch.Tensor:
        c, dt = self.cfg, self.dtype
        b, n, _ = x.shape
        h, d = c.num_heads, c.hidden_size // c.num_heads
        sa = self.attention.self

        def heads(t):
            return t.reshape(b, n, h, d).transpose(1, 2)

        q, k, v = (heads(dense(x, lin, dt)) for lin in (sa.query, sa.key, sa.value))
        ctx = attention_core(q, k, v, attn_bias)
        ctx = ctx.transpose(1, 2).reshape(b, n, c.hidden_size)
        ao = self.attention.output
        x = flax_layer_norm(dense(ctx, ao.dense, dt) + x, ao.LayerNorm)
        y = torch.nn.functional.gelu(dense(x, self.intermediate.dense, dt))
        out = self.output
        return flax_layer_norm(dense(y, out.dense, dt) + x, out.LayerNorm)


def bert_attention_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """(B, N) {0,1} mask -> (B, 1, 1, N) additive bias: 0 keep, -10000 drop."""
    return ((1.0 - attention_mask.float()) * -10000.0)[:, None, None, :]
