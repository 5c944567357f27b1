"""Fused LayerNorm + qkv + masked attention: the CUDA port of the Pallas kernels
uvltrack_tpu/ops/pallas_attention.py::_ln_qkv_attn_kernel (:167,
`fused_ln_qkv_attention` :207), its int8-weight variant
_ln_qkv_attn_kernel_q8 (:433, `fused_ln_qkv_attention_q8` :459) and, through
their second half, `_attn_kernel_qkv` (:119, `fused_attention_qkv` :143).

The TPU kernels are one program per batch element (grid=(B,)) with the
(C, 3C) weight resident in VMEM. At batch 1 that would be one block on one
of the H100's 132 SMs, so the port splits each in two kernels
(csrc/ln_qkv.cu, csrc/qkv_attention.cu; design and bounds in their notes):

- `ln_qkv` / `ln_qkv_q8`: LN (fp32, fast variance clamped at 0), tensor-core
  product against W, fp32 epilogue (`acc + b`, or `acc * scale + b` for the
  int8 payload), out (B, N, 3C). Both weight types run on the TMA + wgmma
  core of csrc/gemm_sm90.cuh, on one of two bodies by the rows M = B*N
  (LARGE_M_ROWS): below it the 64-row LN body (the 64 normalized rows of a
  block in shared memory once, so C <= 1024; an int8 W streams as bytes and
  is converted to bf16 in shared memory); at or above it, the B.N rows of a
  lockstep or training step, the rows normalized once into a scratch, an
  int8 W converted to bf16 once a call, and the persistent large-M body
  (instantiations counted under the same tags; build.body_counts() counts
  the launches of each body apart, as `-64` and `-lm`).
- `qkv_attention`: the TMA + wgmma attention body of csrc/attention.cuh,
  one block per (64-row query tile, head, batch element), the keys split
  over a cluster of up to 3 blocks: exp(clip(q.k*D^-1/2 + key_bias, +-80)),
  fp32 row sums, P.V, division at the end; out (B, N, C) before the output
  projection. In fp32 every product runs as three bf16 hi/lo passes. At B.N
  rows where the split rule splits the keys (takes_attn_batch) the same
  function runs on the header's batch body (uvl_qkv_attention_batch): one
  block a query tile holds all its keys, summed in the split's ranges and
  added in its order, so its bits are the split launch's
  (build.body_counts() counts the two bodies apart, as `-64` and `-lm`).

Compute dtype, as in the Pallas kernels: kernel #1 computes in the weight's
dtype: bf16 for a bf16 weight, whatever x is; fp32 for the fp32 weight of a
model at TPU.COMPUTE_DTYPE=float32, whose stream is fp32 in every block (its
product runs as three bf16 hi/lo passes, no TF32, against the weight's hi and
lo planes, split once and cached by ops/hilo.py). The int8 kernel (#5)
computes in x's dtype: bf16 in the visual blocks, fp32 in the joint blocks,
where nothing is rounded to bf16 (normalized rows, qkv, scores, e, P.V and
the output all stay fp32). So `ln_qkv` has five instantiations (x bf16/fp32
x weight bf16/int8, and fp32x-fp32w) and `qkv_attention` two (bf16, fp32).

Each wrapper checks device, dtype, shape and contiguity, launches on
PyTorch's current stream, raises on a nonzero cudaGetLastError, and counts
its launches per kernel and instantiation (all through ops/build.py: read
them with build.launch_counts() and build.instantiation_counts()). A CPU
tensor takes the plain PyTorch version beside it; a CUDA tensor launches
the kernel or raises. The plain versions compute the same function with the same rounding
points and are what the CPU tests hold against the Pallas interpreter.
"""

from __future__ import annotations

import torch

from ..utils.costs import counted, nbytes
from . import build, hilo, library
from .build import FLOAT, INT, PTR, check_cuda, no_grad_through, require
from .quant import QuantizedTensor, dot_f32, quant_dot

CLAMP = 80.0  # exp-safe score range of the kernels (pallas_attention._CLAMP)
# widest C the LN products take (both weight types): 64 normalized rows of C
# bf16 (or hi/lo halves of half the row) sit in shared memory beside the TMA
# ring (csrc/gemm_sm90.cuh MAX_C; at C=1024 the fc1 launch uses 205,880 of a
# block's 232,448 bytes)
LN_MAX_C = 1024
# csrc/ln_qkv.cu's w_kind by the weight's dtype
W_KIND = {torch.bfloat16: 0, torch.int8: 1, torch.float32: 2}
# rows M = B*N from which `ln_qkv` / `ln_qkv_q8` with a bf16 or int8 weight
# run on the large-M body (uvl_ln_qkv_large_m); fewer rows (the tracking
# step's B=1: 321/361) keep the 64-row LN body (uvl_ln_qkv) and its single
# launch. An fp32 weight runs ln_hilo_kernel at every M. Measured with
# tools/gemm_ab.py --qkv at M in {321, 361, 642, 722, ..., 5,776} (PERF.md,
# section 6, rows 1m and 5m): the large-M body's device time is the lower at
# every M, 2.2-2.9x at B=2 and 2.5-3.3x from B=4, and 1.4x at B=1 (9.2 against
# 12.8 us); B >= 2 takes the large-M body, and B=1 keeps the 64-row body and
# its bits for now: the large-M body is two launches there (three with int8)
# in place of one, which the eager step pays in host time (PERF.md, section 7).
# Kernel #7 (`ln_mlp`, bf16 W) takes the same threshold: tools/gemm_ab.py
# --mlp puts its crossover between B=1 (the 64-row pair 27.5-28.0 us against
# 34.1-34.4) and B=2 (39.6-40.1 against 53.3-54.5; PERF.md row 7m).
# `proj_residual` has its own (ln_qkv_attn_proj.LARGE_M_ROWS)
LARGE_M_ROWS = 512
# (b, h) pairs B*H from which `qkv_attention` runs on the batch body
# (uvl_qkv_attention_batch) wherever the split rule would split the keys
# (attn_split > 1: B-S4, B-S8, a tp rank's heads at B=16); fewer pairs (B=1:
# 12 or 16) and the shapes the rule keeps whole (B-TRAIN, L-S8: the same
# grid either way) keep the split entry (uvl_qkv_attention). Both give the
# same bits. Measured with tools/gemm_ab.py --attn (PERF.md, section 6,
# rows 2m and 5bm): where the rule splits from 48 pairs on (B=4 at 12 heads,
# B=3 at 16) the batch body takes 0.73-0.80 of the split launch's device
# time in bf16 and 0.73-0.87 in fp32; at B=1 (12 and 16 pairs, split 3 at
# N=321/361) it is 1.2x slower, and where the rule keeps the keys whole the
# two are the same grid. Read at each call; 0 puts every shape on the batch
# body (chip_smoke.py and tools/gemm_ab.py time both bodies at one shape).
ATTN_BATCH_PAIRS = 48
# the int8 launches' answer under autograd: kernels #5/#6 have no VJP
INT8_NO_GRAD = ("weight-only int8 (TPU.WEIGHT_QUANT) is inference-only, as in the JAX "
                "package: train with TPU.WEIGHT_QUANT unset")


# ------------------------------------------------------------- work
# A kernel and its plain version count the same work (utils/costs.py): the
# products' FLOPs, each input read once and each output written once.
def _rows(x):
    return x.numel() // x.shape[-1], x.shape[-1]


def ln_qkv_work(x, ln_scale, ln_bias, w_qkv, b_qkv, eps=1e-6):
    (m, c), f = _rows(x), w_qkv.shape[0]
    return 2 * m * c * f, nbytes(x, ln_scale, ln_bias, w_qkv, b_qkv) + m * f * w_qkv.dtype.itemsize


def ln_qkv_q8_work(x, ln_scale, ln_bias, w_q, w_scale, b_qkv, eps=1e-6):
    (m, c), f = _rows(x), w_q.shape[0]
    return 2 * m * c * f, nbytes(x, ln_scale, ln_bias, w_q, w_scale, b_qkv) + m * f * x.dtype.itemsize


def qkv_attention_work(qkv, key_bias, heads):
    b, n, f = qkv.shape
    return 4 * b * n * n * f // 3, nbytes(qkv, key_bias) + nbytes(qkv) // 3


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


@counted(ln_qkv_work)
def ln_qkv_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, eps: float = 1e-6):
    """Plain version of `ln_qkv` (pallas_attention._xla_ln_qkv): the
    normalized rows and the result in w_qkv's dtype, which for a
    QuantizedTensor is its compute dtype."""
    y = layer_norm_fast_var(x, ln_scale, ln_bias, eps).to(w_qkv.dtype)
    return (quant_dot(y, w_qkv) + b_qkv.float()).to(w_qkv.dtype)


@counted(ln_qkv_q8_work)
def ln_qkv_q8_plain(x, ln_scale, ln_bias, w_q, w_scale, b_qkv, eps: float = 1e-6):
    """Plain version of `ln_qkv_q8`: the q8 kernel's prefix
    (_ln_qkv_attn_kernel_q8 :441-453), computing in x's dtype."""
    return ln_qkv_plain(x, ln_scale, ln_bias, QuantizedTensor(w_q, w_scale, x.dtype),
                        b_qkv, eps)


def ln_rows_plain(x, ln_scale, ln_bias, eps: float = 1e-6, split: bool = False):
    """Plain version of ln_rows_kernel, the large-M entry's first launch:
    x's rows normalized once, (M, C) bf16 (#1's rounding point, and #5's at
    a bf16 x); split (an fp32 x with an int8 W, whose product stays fp32):
    the fp32 rows as their hi and lo bf16 halves side by side, (M, 2C), hi =
    bf16(y), lo = bf16(y - hi)."""
    y = layer_norm_fast_var(x, ln_scale, ln_bias, eps).reshape(-1, x.shape[-1])
    hi = y.to(torch.bfloat16)
    if not split:
        return hi
    return torch.cat([hi, (y - hi.float()).to(torch.bfloat16)], dim=-1)


def ln_qkv_large_m_plain(normed, w, w_scale, b_qkv, out_dtype):
    """Plain version of the large-M body's product (kind LN_BIAS) on
    ln_rows_plain's rows: out (M, F) = out_dtype(A . W^T (* s) + b), fp32
    accumulation; W (F, C) bf16, or an int8 payload (its bf16 conversion,
    i8_to_bf16_kernel, is exact) with its per-row scale s; split rows (2C
    wide) contract hi + lo, as the body's hi.W + lo.W passes do."""
    c = w.shape[1]
    a = normed if normed.shape[1] == c else normed[:, :c].float() + normed[:, c:].float()
    acc = dot_f32(a, w)
    if w_scale is not None:
        acc = acc * w_scale.float()
    return (acc + b_qkv.float()).to(out_dtype)


@counted(qkv_attention_work)
def qkv_attention_plain(qkv, key_bias, heads: int):
    """Plain version of `qkv_attention`: the kernel's clamped, late-divided
    softmax (pallas_attention._attn_kernel_qkv's math), e cast to qkv's
    dtype for P.V (a no-op in fp32)."""
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
    """Plain version of `ln_qkv_attention` (kernel #1's function; with a
    QuantizedTensor, the JAX package's XLA fallback for int8 weights)."""
    qkv = ln_qkv_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, eps)
    return qkv_attention_plain(qkv, key_bias, heads)


def ln_qkv_attention_q8_plain(x, ln_scale, ln_bias, w_q, w_scale, b_qkv, key_bias,
                              heads: int, eps: float = 1e-6):
    """Plain version of `ln_qkv_attention_q8` (kernel #5's function)."""
    qkv = ln_qkv_q8_plain(x, ln_scale, ln_bias, w_q, w_scale, b_qkv, eps)
    return qkv_attention_plain(qkv, key_bias, heads)


# ---------------------------------------------------------------- kernels
def takes_large_m(rows: int, w_dtype: torch.dtype, rows_from: int | None = None) -> bool:
    """Whether a launch at `rows` rows with a weight of w_dtype runs on the
    large-M body: from rows_from rows (`proj_residual`'s own threshold), or
    by default from LARGE_M_ROWS (`ln_qkv` / `ln_qkv_q8`, `ln_mlp`); never
    for an fp32 weight. Both thresholds are read at each call: chip_smoke.py
    and tools/gemm_ab.py set them to time both bodies at one shape."""
    return w_dtype != torch.float32 and rows >= (LARGE_M_ROWS if rows_from is None
                                                 else rows_from)


def attn_split(b: int, n: int, heads: int, fp32: bool = False) -> int:
    """The cluster split csrc/attention.cuh's choose_split gives the split
    body at (B, N, H): a cost in key tiles a block, waves of two blocks on
    each of 132 SMs times the tiles a block, plus 3 tiles (bf16) or 2 (fp32)
    for a split over a cluster; the smaller split on a tie, at most 3."""
    tiles = -(-n // 64)
    blocks, slots, split_cost = tiles * heads * b, 2 * 132, 2 if fp32 else 3
    best, best_cost = 1, 0
    for split in range(1, min(3, tiles) + 1):
        waves = -(-blocks * split // slots)
        cost = waves * -(-tiles // split) + (split_cost if split > 1 else 0)
        if split == 1 or cost < best_cost:
            best, best_cost = split, cost
    return best


def takes_attn_batch(b: int, n: int, heads: int, fp32: bool = False) -> bool:
    """Whether `qkv_attention` at (B, N, H) runs on the batch body: from
    ATTN_BATCH_PAIRS (b, h) pairs where the split rule splits the keys, or
    everywhere when ATTN_BATCH_PAIRS is 0 (read at each call)."""
    return ATTN_BATCH_PAIRS == 0 or (b * heads >= ATTN_BATCH_PAIRS
                                     and attn_split(b, n, heads, fp32) > 1)


def _launch_ln_qkv(x, ln_scale, ln_bias, w, w_scale, b_qkv, eps, out_dtype):
    """W (F, C): F = 3C, or a tensor-parallel rank's 3C/tp rows (its heads'
    q, k and v; parallel/tp.py). The body by takes_large_m."""
    b, n, c = x.shape
    f = w.shape[0]
    require(x.dtype in (torch.bfloat16, torch.float32),
            f"ln_qkv: x must be bf16 or fp32, got {x.dtype}")
    require(all(t.dtype == torch.float32 for t in (ln_scale, ln_bias, b_qkv)),
            "ln_qkv: LN scale/bias and qkv bias must be fp32")
    require(tuple(w.shape) == (f, c) and f % 8 == 0 and tuple(b_qkv.shape) == (f,)
            and tuple(ln_scale.shape) == (c,) and tuple(ln_bias.shape) == (c,),
            f"ln_qkv: bad shapes for C={c}, F={f} (F a multiple of 8)")
    require(c % 64 == 0, f"ln_qkv: C must be a multiple of 64, got {c}")
    tensors = (x, ln_scale, ln_bias, w, b_qkv) + ((w_scale,) if w_scale is not None else ())
    no_grad_through("ln_qkv", tensors, INT8_NO_GRAD if w_scale is not None else
                    "call it through ops/autograd.py (LnQkvAttention, LnQkvAttnProj)")
    check_cuda("ln_qkv", *tensors)
    tag = f"{build.dtype_tag(x)}x-{build.dtype_tag(w)}w"
    x32 = int(x.dtype == torch.float32)
    scale = w_scale.data_ptr() if w_scale is not None else None
    out = torch.empty((b, n, f), dtype=out_dtype, device=x.device)
    if takes_large_m(b * n, w.dtype):
        # the rows normalized once (an fp32 x with an int8 W: hi | lo bf16
        # halves, (M, 2C)) and an int8 W converted to bf16 once: scratch of
        # this call, from the CUDA graph's pool under capture, so a graph's
        # replays reuse its addresses
        split = w_scale is not None and x32
        normed = torch.empty((b * n, 2 * c if split else c), dtype=torch.bfloat16,
                             device=x.device)
        w16 = (torch.empty((f, c), dtype=torch.bfloat16, device=x.device)
               if w_scale is not None else None)
        build.launch("ln_qkv", tag,
                     [PTR, INT, PTR, PTR, PTR, INT, PTR, PTR, PTR, PTR, PTR, INT, INT, INT,
                      FLOAT],
                     x.data_ptr(), x32, ln_scale.data_ptr(), ln_bias.data_ptr(), w.data_ptr(),
                     W_KIND[w.dtype], scale, b_qkv.data_ptr(), normed.data_ptr(),
                     None if w16 is None else w16.data_ptr(), out.data_ptr(), b * n, c, f, eps,
                     stream_of=x, entry="uvl_ln_qkv_large_m", body="lm")
        return out
    # an fp32 weight goes to the kernel as its cached hi/lo planes
    w32 = w.dtype == torch.float32
    build.launch("ln_qkv", tag,
                 [PTR, INT, PTR, PTR, PTR, INT, PTR, PTR, PTR, INT, INT, INT, FLOAT],
                 x.data_ptr(), x32, ln_scale.data_ptr(), ln_bias.data_ptr(),
                 (hilo.planes(w) if w32 else w).data_ptr(), W_KIND[w.dtype], scale,
                 b_qkv.data_ptr(), out.data_ptr(), b * n, c, f, eps, stream_of=x,
                 body="" if w32 else "64")
    return out


@counted(ln_qkv_work)
def ln_qkv(x, ln_scale, ln_bias, w_qkv, b_qkv, eps: float = 1e-6):
    """x (B, N, C) bf16|fp32; ln_scale, ln_bias (C,) fp32; w_qkv (F, C) bf16,
    or fp32 with an fp32 x (Linear layout; F = 3C, 3C/tp under tensor
    parallelism); b_qkv (F,) fp32 -> (B, N, F) in w_qkv's dtype (kernel
    #1's prefix). The body by the rows (takes_large_m)."""
    if torch.compiler.is_exporting():
        return library.ln_qkv(x, ln_scale, ln_bias, w_qkv, b_qkv, eps)
    if x.device.type == "cpu":
        return ln_qkv_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, eps)
    require(w_qkv.dtype in (torch.bfloat16, torch.float32),
            f"ln_qkv: w_qkv must be bf16 or fp32, got {w_qkv.dtype}")
    require(w_qkv.dtype == torch.bfloat16 or x.dtype == torch.float32,
            f"ln_qkv: an fp32 w_qkv (fp32 compute) needs an fp32 x, got {x.dtype}")
    require(x.shape[-1] <= LN_MAX_C, f"ln_qkv: C must be at most {LN_MAX_C} (the LN block of 64 "
            f"rows in shared memory), got {x.shape[-1]}")
    return _launch_ln_qkv(x, ln_scale, ln_bias, w_qkv, None, b_qkv, eps, w_qkv.dtype)


@counted(ln_qkv_q8_work)
def ln_qkv_q8(x, ln_scale, ln_bias, w_q, w_scale, b_qkv, eps: float = 1e-6):
    """x (B, N, C) bf16|fp32; w_q (3C, C) int8 payload; w_scale (3C,) fp32
    per-row scale -> (B, N, 3C) in x's dtype (kernel #5's prefix); the body
    as ln_qkv's."""
    if torch.compiler.is_exporting():
        return library.ln_qkv_q8(x, ln_scale, ln_bias, w_q, w_scale, b_qkv, eps)
    if x.device.type == "cpu":
        return ln_qkv_q8_plain(x, ln_scale, ln_bias, w_q, w_scale, b_qkv, eps)
    require(w_q.dtype == torch.int8, f"ln_qkv_q8: w_q must be int8, got {w_q.dtype}")
    require(w_scale.dtype == torch.float32 and tuple(w_scale.shape) == (w_q.shape[0],),
            "ln_qkv_q8: w_scale must be (3C,) fp32")
    require(x.shape[-1] <= LN_MAX_C, f"ln_qkv_q8: C must be at most {LN_MAX_C} (the LN block of "
            f"64 rows in shared memory), got {x.shape[-1]}")
    return _launch_ln_qkv(x, ln_scale, ln_bias, w_q, w_scale, b_qkv, eps, x.dtype)


@counted(qkv_attention_work)
def qkv_attention(qkv, key_bias, heads: int):
    """qkv (B, N, 3*H*64) bf16|fp32; key_bias (B, N) fp32 additive ->
    (B, N, H*64) in qkv's dtype. The body by takes_attn_batch."""
    if torch.compiler.is_exporting():
        return library.qkv_attention(qkv, key_bias, heads)
    if qkv.device.type == "cpu":
        return qkv_attention_plain(qkv, key_bias, heads)
    b, n, f = qkv.shape
    require(qkv.dtype in (torch.bfloat16, torch.float32),
            f"qkv_attention: qkv must be bf16 or fp32, got {qkv.dtype}")
    require(key_bias.dtype == torch.float32 and tuple(key_bias.shape) == (b, n),
            "qkv_attention: key_bias must be (B, N) fp32")
    require(f == 3 * heads * 64, f"qkv_attention: head dim must be 64 (F={f}, H={heads})")
    no_grad_through("qkv_attention", (qkv, key_bias),
                    "call it through ops/autograd.py (QkvAttention, LnQkvAttention)")
    check_cuda("qkv_attention", qkv, key_bias)
    out = torch.empty((b, n, f // 3), dtype=qkv.dtype, device=qkv.device)
    batch = takes_attn_batch(b, n, heads, qkv.dtype == torch.float32)
    build.launch("qkv_attention", build.dtype_tag(qkv),
                 [PTR, INT, PTR, PTR, INT, INT, INT, INT, FLOAT],
                 qkv.data_ptr(), int(qkv.dtype == torch.float32), key_bias.data_ptr(),
                 out.data_ptr(), b, n, heads, 64, 64 ** -0.5, stream_of=qkv,
                 entry="uvl_qkv_attention_batch" if batch else "",
                 body="lm" if batch else "64")
    return out


def ln_qkv_attention(x, ln_scale, ln_bias, w_qkv, b_qkv, key_bias,
                     heads: int, eps: float = 1e-6):
    """Kernel #1's function: (B, N, C) residual stream -> (B, N, C)
    attention output before the projection, in w_qkv's dtype. On a CUDA
    tensor: `ln_qkv` then `qkv_attention`, two launches."""
    qkv = ln_qkv(x, ln_scale, ln_bias, w_qkv, b_qkv, eps)
    return qkv_attention(qkv, key_bias, heads)


def ln_qkv_attention_q8(x, ln_scale, ln_bias, w_q, w_scale, b_qkv, key_bias,
                        heads: int, eps: float = 1e-6):
    """Kernel #5's function: as ln_qkv_attention with the int8 payload and
    its per-row scale, computing in x's dtype. Two launches on a CUDA
    tensor: `ln_qkv_q8`, then `qkv_attention` in x's dtype."""
    qkv = ln_qkv_q8(x, ln_scale, ln_bias, w_q, w_scale, b_qkv, eps)
    return qkv_attention(qkv, key_bias, heads)
