"""The kernels under autograd: one torch.autograd.Function for each custom
VJP of the JAX package (uvltrack_tpu/ops/pallas_attention.py).

| Function       | forward (kernels)               | backward recomputes    | cast to | JAX VJP  |
|----------------|---------------------------------|------------------------|---------|----------|
| LnQkvAttention | #1: `ln_qkv` + `qkv_attention`  | ln_qkv_attention_plain | w_qkv   | :260-288 |
| QkvAttention   | #2: `qkv_attention`             | qkv_attention_plain    | qkv     | :659-679 |
| LnQkvAttnProj  | #4: #1's pair + `proj_residual` | ln_qkv_attn_proj_plain | x       | :379-405 |
| LnMlp          | #7: `ln_fc1_gelu` + `fc2_bias`  | ln_mlp_plain           | w2      | :616-634 |

("cast to": the input whose dtype the cotangent is cast to.)

The forward is the kernel wrapper (a CPU tensor takes its plain version) and
saves its inputs only: no attention probabilities and no (N, 4C) MLP hidden
tensor are kept. The backward is the JAX package's recompute: the plain
version, which has the kernel's clamped softmax and rounding points, runs
again under autograd from the saved inputs, and torch.autograd.grad of it
against the cotangent, cast as the JAX backward casts it, gives the
gradients. No backward kernel exists in the JAX package either: each of its
backwards is an XLA recompute of the kernel's twin.

ops/attention.py calls these whenever autograd is on and an input needs a
gradient. Kernels #3 (BERT's attention) and #5/#6 (int8 weights) have no
VJP in the JAX package; their wrappers raise under autograd instead of
returning a tensor cut from the graph (ops/build.py::no_grad_through).
"""

from __future__ import annotations

import torch

from . import ln_mlp as lm
from . import ln_qkv_attention as lqa
from . import ln_qkv_attn_proj as lqp


def _recompute(ctx, g, plain, cast_to: int):
    """Gradients of plain(*saved, *ctx.static) against g cast to the dtype of
    saved input `cast_to`: one per saved input, None where none is needed."""
    saved = ctx.saved_tensors
    leaves = [t.detach().requires_grad_(need) for t, need in zip(saved, ctx.needs_input_grad)]
    wanted = [t for t in leaves if t.requires_grad]
    with torch.enable_grad():
        out = plain(*leaves, *ctx.static)
    grads = iter(torch.autograd.grad(out, wanted, g.to(saved[cast_to].dtype),
                                     allow_unused=True))
    return (tuple(next(grads) if t.requires_grad else None for t in leaves)
            + (None,) * len(ctx.static))


class LnQkvAttention(torch.autograd.Function):
    """Kernel #1 (ln_qkv_attention_trainable): (x, ln_scale, ln_bias, w_qkv,
    b_qkv, key_bias, heads, eps) -> the (B, N, C) attention output."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w_qkv, b_qkv, key_bias, heads, eps):
        ctx.save_for_backward(x, ln_scale, ln_bias, w_qkv, b_qkv, key_bias)
        ctx.static = (heads, eps)
        return lqa.ln_qkv_attention(x, ln_scale, ln_bias, w_qkv, b_qkv, key_bias, heads, eps)

    @staticmethod
    def backward(ctx, g):
        return _recompute(ctx, g, lqa.ln_qkv_attention_plain, cast_to=3)


class QkvAttention(torch.autograd.Function):
    """Kernel #2 (_qkv_attention_trainable): (qkv, key_bias, heads) -> the
    (B, N, C) attention output."""

    @staticmethod
    def forward(ctx, qkv, key_bias, heads):
        ctx.save_for_backward(qkv, key_bias)
        ctx.static = (heads,)
        return lqa.qkv_attention(qkv, key_bias, heads)

    @staticmethod
    def backward(ctx, g):
        return _recompute(ctx, g, lqa.qkv_attention_plain, cast_to=0)


class LnQkvAttnProj(torch.autograd.Function):
    """Kernel #4 (ln_qkv_attn_proj_trainable): (x, ln_scale, ln_bias, w_qkv,
    b_qkv, w_proj, b_proj, key_bias, heads, eps) -> x + proj, in x's dtype."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, key_bias, heads, eps):
        ctx.save_for_backward(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, key_bias)
        ctx.static = (heads, eps)
        return lqp.ln_qkv_attn_proj(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                                    key_bias, heads, eps)

    @staticmethod
    def backward(ctx, g):
        return _recompute(ctx, g, lqp.ln_qkv_attn_proj_plain, cast_to=0)


class LnMlp(torch.autograd.Function):
    """Kernel #7 (ln_mlp_trainable): (x, ln_scale, ln_bias, w1, b1, w2, b2,
    eps) -> the MLP output before the residual, in w2's dtype."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2, eps):
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2, b2)
        ctx.static = (eps,)
        return lm.ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, eps)

    @staticmethod
    def backward(ctx, g):
        return _recompute(ctx, g, lm.ln_mlp_plain, cast_to=5)
