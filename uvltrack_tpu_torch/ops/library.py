"""The kernels as PyTorch custom ops (`torch.library.custom_op`, namespace
"uvltrack"), so that `torch.export` can trace a program through them.

A kernel launches through ctypes on a tensor's data_ptr, which a FakeTensor
(what export traces with) does not have. So while a program is being
exported (`torch.compiler.is_exporting()`), each launching wrapper of ops/
calls its op here instead: under export the op's fake implementation gives
the output's shape and dtype, and the exported graph holds the op
(`uvltrack::ln_qkv` and so on) where the kernel runs. When the exported
program runs, each op calls its wrapper again with real tensors: the kernel
on a CUDA tensor, the plain version on a CPU one. Outside export the
wrappers keep their direct ctypes route: the eager step and the CUDA graphs
never pass through the dispatcher.

| op                      | wrapper                                   | output              |
|-------------------------|-------------------------------------------|---------------------|
| uvltrack::ln_qkv        | ln_qkv_attention.ln_qkv (bf16 / fp32 W)   | (B, N, 3C), W dtype |
| uvltrack::ln_qkv_q8     | ln_qkv_attention.ln_qkv_q8                | (B, N, 3C), x dtype |
| uvltrack::qkv_attention | ln_qkv_attention.qkv_attention            | (B, N, C), qkv's    |
| uvltrack::proj_residual | ln_qkv_attn_proj.proj_residual            | like x              |
| uvltrack::attention     | fused_attention.fused_attention (B,N,H,D) | bf16                |
| uvltrack::ln_mlp        | ln_mlp.ln_mlp                             | (B, N, C) bf16      |

Import this module before `torch.export.load` of a program that holds
these ops (cli/export.py does; the wrappers' modules import it).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

OPS = ("ln_qkv", "ln_qkv_q8", "qkv_attention", "proj_residual", "attention", "ln_mlp")


@torch.library.custom_op("uvltrack::ln_qkv", mutates_args=())
def ln_qkv(x: Tensor, ln_scale: Tensor, ln_bias: Tensor, w_qkv: Tensor, b_qkv: Tensor,
           eps: float) -> Tensor:
    from . import ln_qkv_attention as lqa
    return lqa.ln_qkv(x, ln_scale, ln_bias, w_qkv, b_qkv, eps)


@ln_qkv.register_fake
def _(x, ln_scale, ln_bias, w_qkv, b_qkv, eps):
    return x.new_empty((*x.shape[:-1], w_qkv.shape[0]), dtype=w_qkv.dtype)


@torch.library.custom_op("uvltrack::ln_qkv_q8", mutates_args=())
def ln_qkv_q8(x: Tensor, ln_scale: Tensor, ln_bias: Tensor, w_q: Tensor, w_scale: Tensor,
              b_qkv: Tensor, eps: float) -> Tensor:
    from . import ln_qkv_attention as lqa
    return lqa.ln_qkv_q8(x, ln_scale, ln_bias, w_q, w_scale, b_qkv, eps)


@ln_qkv_q8.register_fake
def _(x, ln_scale, ln_bias, w_q, w_scale, b_qkv, eps):
    return x.new_empty((*x.shape[:-1], w_q.shape[0]))


@torch.library.custom_op("uvltrack::qkv_attention", mutates_args=())
def qkv_attention(qkv: Tensor, key_bias: Tensor, heads: int) -> Tensor:
    from . import ln_qkv_attention as lqa
    return lqa.qkv_attention(qkv, key_bias, heads)


@qkv_attention.register_fake
def _(qkv, key_bias, heads):
    return qkv.new_empty((*qkv.shape[:-1], qkv.shape[-1] // 3))


@torch.library.custom_op("uvltrack::proj_residual", mutates_args=())
def proj_residual(x: Tensor, attn: Tensor, w_proj: Tensor, b_proj: Tensor,
                  wp_scale: Optional[Tensor]) -> Tensor:
    from . import ln_qkv_attn_proj as lqp
    return lqp.proj_residual(x, attn, w_proj, b_proj, wp_scale)


@proj_residual.register_fake
def _(x, attn, w_proj, b_proj, wp_scale):
    return torch.empty_like(x)


@torch.library.custom_op("uvltrack::attention", mutates_args=())
def attention(q: Tensor, k: Tensor, v: Tensor, key_bias: Tensor) -> Tensor:
    """Kernel #3 with its output as the kernel writes it, (B, N, H, D)."""
    from . import fused_attention as fa
    return fa.fused_attention(q, k, v, key_bias).transpose(1, 2).contiguous()


@attention.register_fake
def _(q, k, v, key_bias):
    b, h, n, d = q.shape
    return q.new_empty((b, n, h, d), dtype=v.dtype)


@torch.library.custom_op("uvltrack::ln_mlp", mutates_args=())
def ln_mlp(x: Tensor, ln_scale: Tensor, ln_bias: Tensor, w1: Tensor, b1: Tensor, w2: Tensor,
           b2: Tensor, eps: float) -> Tensor:
    from . import ln_mlp as lm
    return lm.ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, eps)


@ln_mlp.register_fake
def _(x, ln_scale, ln_bias, w1, b1, w2, b2, eps):
    return x.new_empty(x.shape, dtype=w2.dtype)


def op_counts(graph_module) -> dict:
    """{op name: calls} of the uvltrack ops in an exported program's graph
    (an ExportedProgram, or its graph_module)."""
    gm = getattr(graph_module, "graph_module", graph_module)
    counts = {}
    for node in gm.graph.nodes:
        target = getattr(node.target, "name", lambda: "")
        name = target() if callable(target) else ""
        if node.op == "call_function" and name.startswith("uvltrack::"):
            key = name.split("::", 1)[1].split(".")[0]
            counts[key] = counts.get(key, 0) + 1
    return counts
