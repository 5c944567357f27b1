"""Fused LayerNorm + fc1 + exact GELU + fc2, the MLP half of a ViT block before
the residual add: the CUDA port of the Pallas kernel
uvltrack_tpu/ops/pallas_attention.py::_ln_mlp_kernel (:551, entry
`fused_ln_mlp` :577), kernel #7.

    y   = w1.dtype( LN(x) )                   fp32 LN, fast variance clamped at 0
    h   = w2.dtype( gelu( y . W1^T + b1 ) )   fp32 accumulation, erf GELU in fp32
    out = w2.dtype( h . W2^T + b2 )           fp32 accumulation

The JAX package takes the kernel in ln_mlp_core only under
UVLTRACK_FUSED_MLP=1, for fp weights, at N >= min_seq_len() and under a 14 MB
VMEM estimate, which at ViT-B width is 17.2 MB at N=361 and 16.3 MB at
N=321: on a TPU the kernel never engages at the tracker's shapes, and the
JAX package runs its XLA twin `_xla_ln_mlp` (:601), which has the kernel's
rounding points. The port drops the VMEM cap (it bounds a TPU resource its
tiled kernels do not have), so under UVLTRACK_FUSED_MLP=1 its kernel runs in
all 12 blocks at N=321/361, computing the function the JAX package computes
there through the twin.

On the card this is two launches of csrc/ln_mlp.cu on the TMA + wgmma
core of csrc/gemm_sm90.cuh (one `ln_mlp` call counted by ops/build.py):
`ln_fc1_gelu` writes the (M, 4C) hidden tensor in bf16 to device memory,
since a 64-row tile of it would overflow a block's shared memory, and
`fc2_bias` reads it back with its K split over a cluster of four blocks,
reduced in a fixed order, so its output repeats bit for bit (design in the
sources' notes). Three instantiations: bf16 x (blocks 0-5) and fp32 x (the
fp32 joint stream, blocks 6-11), both with bf16 weights and a bf16 hidden
tensor and output; and fp32 x with fp32 weights (TPU.COMPUTE_DTYPE=float32,
as `_xla_ln_mlp` with fp32 weights, :601-613), whose hidden tensor and
output are fp32 and whose weights go to the kernels as their hi/lo bf16
planes (ops/hilo.py), three passes a product. The output is in w2's dtype.

A CPU tensor takes the plain version, which is also the plain backend's
MLP (ops/attention.py::ln_mlp_core) and takes int8 QuantizedTensor weights
through quant_dot.

Under tensor parallelism (parallel/tp.py) a rank holds F/tp of fc1's output
columns and of fc2's input rows, and `ln_mlp_partial` computes its share of
fc2 before the bias: h_r . W2_r^T in fp32 (bf16 weights: `fc2_bias` with an
fp32 out and a zero b2, the instantiations tagged `-fp32o`). The caller sums
the shares over the model group, adds b2 and rounds once to w2's dtype, so
the bias is added once and the product rounds where the single-device
kernel rounds it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.costs import counted, nbytes
from . import build, hilo, library
from .build import FLOAT, INT, PTR, check_cuda, no_grad_through, require
from .ln_qkv_attention import LN_MAX_C, layer_norm_fast_var
from .quant import quant_dot

STAGES = {"ln_fc1_gelu": 1, "fc2_bias": 2, "pair": 3}  # uvl_ln_mlp's launch mask


# ----------------------------------------------------------------- plain
def ln_fc1_gelu_plain(x, ln_scale, ln_bias, w1, b1, eps: float = 1e-6):
    """The first launch's function: gelu(w1.dtype(LN(x)) . W1^T + b1) in
    fp32, returned in fp32 (the caller rounds it to w2's dtype)."""
    y = layer_norm_fast_var(x, ln_scale, ln_bias, eps).to(w1.dtype)
    return F.gelu(quant_dot(y, w1) + b1.float())


def fc2_bias_plain(h, w2, b2):
    """The second launch's function: w2.dtype(h . W2^T + b2)."""
    return (quant_dot(h.to(w2.dtype), w2) + b2.float()).to(w2.dtype)


def ln_mlp_work(x, ln_scale, ln_bias, w1, b1, w2, b2, eps=1e-6):
    """(FLOPs, bytes) of kernel #7's function (utils/costs.py), the kernel's
    and the plain version's: fc1 and fc2, the (M, F) hidden tensor written
    and read once in w2's dtype."""
    c, f = x.shape[-1], w1.shape[0]
    m = x.numel() // c
    return (4 * m * c * f, nbytes(x, ln_scale, ln_bias, w1, b1, w2, b2)
            + (2 * m * f + m * c) * w2.dtype.itemsize)


@counted(ln_mlp_work)
def ln_mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float = 1e-6):
    """Kernel #7's function (pallas_attention._xla_ln_mlp): x (B, N, C);
    w1 (F, C), w2 (C, F) in Linear layout, dense or QuantizedTensor ->
    (B, N, C) in w2's dtype."""
    return fc2_bias_plain(ln_fc1_gelu_plain(x, ln_scale, ln_bias, w1, b1, eps), w2, b2)


def ln_mlp_partial_plain(x, ln_scale, ln_bias, w1, b1, w2, eps: float = 1e-6):
    """A tensor-parallel rank's share of kernel #7's function before the
    bias: ln_fc1_gelu in w2's dtype, times its W2 columns, in fp32."""
    return quant_dot(ln_fc1_gelu_plain(x, ln_scale, ln_bias, w1, b1, eps).to(w2.dtype), w2)


# ---------------------------------------------------------------- kernel
def launch_ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, hidden, out, eps: float = 1e-6,
                  stages: str = "pair"):
    """Launch csrc/ln_mlp.cu into the caller's hidden (M, F) and out
    (B, N, C), both in w2's dtype (out fp32 with bf16 weights: fc2_bias's
    fp32 output, tagged `-fp32o`): stages "pair" (both launches, the
    kernel's function), or "ln_fc1_gelu" / "fc2_bias" alone (chip_smoke.py
    times each launch). Counts one `ln_mlp` launch per call."""
    b, n, c = x.shape
    f = w1.shape[0]
    require(x.dtype in (torch.bfloat16, torch.float32),
            f"ln_mlp: x must be bf16 or fp32, got {x.dtype}")
    require(w1.dtype == w2.dtype and w1.dtype in (torch.bfloat16, torch.float32),
            f"ln_mlp: w1, w2 must be both bf16 or both fp32, got {w1.dtype}, {w2.dtype}")
    w32 = w1.dtype == torch.float32
    require(not w32 or x.dtype == torch.float32,
            f"ln_mlp: fp32 w1, w2 (fp32 compute) need an fp32 x, got {x.dtype}")
    require(all(t.dtype == torch.float32 for t in (ln_scale, ln_bias, b1, b2)),
            "ln_mlp: LN scale/bias and the biases must be fp32")
    require(tuple(w1.shape) == (f, c) and tuple(w2.shape) == (c, f)
            and tuple(b1.shape) == (f,) and tuple(b2.shape) == (c,)
            and tuple(ln_scale.shape) == (c,) and tuple(ln_bias.shape) == (c,),
            f"ln_mlp: bad shapes for C={c}, F={f}")
    require(c % 64 == 0 and c <= LN_MAX_C and f % 256 == 0,
            f"ln_mlp: C must be a multiple of 64 up to {LN_MAX_C} and F of 256 (fc2's K "
            f"split four ways in 64-deep tiles), got C={c}, F={f}")
    out32 = out.dtype == torch.float32 and not w32  # a tensor-parallel partial
    require(hidden.dtype == w2.dtype and tuple(hidden.shape) == (b * n, f)
            and out.dtype in (w2.dtype, torch.float32) and tuple(out.shape) == (b, n, c),
            f"ln_mlp: hidden must be (B*N, F) in {w2.dtype} and out (B, N, C) in it or fp32")
    no_grad_through("ln_mlp", (x, ln_scale, ln_bias, w1, b1, w2, b2),
                    "call it through ops/autograd.py (LnMlp)")
    check_cuda("ln_mlp", x, ln_scale, ln_bias, w1, b1, w2, b2, hidden, out)
    # fp32 weights go to the kernels as their cached hi/lo planes
    p1, p2 = (hilo.planes(w1), hilo.planes(w2)) if w32 else (w1, w2)
    build.launch("ln_mlp", f"{build.dtype_tag(x)}x-{build.dtype_tag(w1)}w"
                 + ("-fp32o" if out32 else ""),
                 [PTR, INT, PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, PTR, PTR, INT, INT, INT,
                  FLOAT, INT],
                 x.data_ptr(), int(x.dtype == torch.float32), ln_scale.data_ptr(),
                 ln_bias.data_ptr(), p1.data_ptr(), b1.data_ptr(), p2.data_ptr(),
                 b2.data_ptr(), int(w32), int(out32), hidden.data_ptr(), out.data_ptr(), b * n,
                 c, f, eps, STAGES[stages], stream_of=x)
    return out


@counted(ln_mlp_work)
def ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float = 1e-6):
    """x (B, N, C) bf16|fp32; ln_scale, ln_bias (C,) fp32; w1 (F, C), w2 (C, F)
    both bf16, or both fp32 with an fp32 x (Linear layout); b1 (F,), b2 (C,)
    fp32 -> (B, N, C) in w2's dtype, the MLP output before the residual. Two
    kernel launches on a CUDA tensor."""
    if torch.compiler.is_exporting():
        return library.ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, eps)
    if x.device.type == "cpu":
        return ln_mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, eps)
    b, n, c = x.shape
    hidden = torch.empty((b * n, w1.shape[0]), dtype=w2.dtype, device=x.device)
    out = torch.empty((b, n, c), dtype=w2.dtype, device=x.device)
    return launch_ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, hidden, out, eps)


@counted(ln_mlp_work)
def ln_mlp_partial(x, ln_scale, ln_bias, w1, b1, w2, eps: float = 1e-6):
    """A tensor-parallel rank's share of kernel #7's function before the
    bias: x (B, N, C); w1 (F/tp, C), w2 (C, F/tp) -> (B, N, C) fp32. Both
    launches on a CUDA tensor, fc2_bias with a zero b2 and an fp32 out."""
    if x.device.type == "cpu":
        return ln_mlp_partial_plain(x, ln_scale, ln_bias, w1, b1, w2, eps)
    b, n, c = x.shape
    hidden = torch.empty((b * n, w1.shape[0]), dtype=w2.dtype, device=x.device)
    out = torch.empty((b, n, c), dtype=torch.float32, device=x.device)
    zero = torch.zeros((c,), dtype=torch.float32, device=x.device)
    return launch_ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, zero, hidden, out, eps)
