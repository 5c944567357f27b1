#!/usr/bin/env python3
"""Drive the PyTorch port (uvltrack_tpu_torch) end to end on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--frames 64]

Phases, one JSON line each:
  1. env      -- card, count, power limit; the nvcc build of every kernel
                 under uvltrack_tpu_torch/csrc (command, seconds, ptxas lines).
  2. kernel   -- each CUDA kernel (and the pair as the fused LN+qkv+attention
                 op) against its plain PyTorch version on the card in bf16 at
                 N in {48, 321, 361, 681} under flag-0 / flag-2 / open key
                 masks, qkv_attention called twice (bitwise equal: the keys'
                 cluster split is summed in rank order); CUDA-event times
                 (a kernel that fails under CUDA-graph capture fails the
                 run) of kernel, plain version and the
                 PyTorch library yardstick at the main path's two shapes
                 (N=321 with a bf16 stream, N=361 with an fp32 stream).
     q8_kernel -- the same for the int8 and fused-projection instantiations
                 (ln_qkv with an int8 payload, fp32 qkv_attention,
                 proj_residual, each proj_residual and fp32 qkv_attention
                 call twice: bitwise equal) and the compositions #4, #5
                 and #6: bf16 compute under the KERNEL_* rule, fp32
                 compute under F32_*.
     fused_kernel -- kernel #3 (`attention`, BERT's attention) at N in {40,
                 48, 128, 321, 361, 681} under BERT-padding / all-masked / open /
                 ViT flag-0 masks, and kernel #7 (`ln_mlp`, both launches
                 and each alone) at N in {48, 321, 361, 681} with bf16 and
                 fp32 x, against their plain versions, and fc2_bias and
                 attention twice (bitwise equal); times at N=40/128 and
                 at the MLP's main-path shapes. ln_qkv's library yardstick is
                 F.layer_norm + F.linear (dequantized W for int8).
  3. track    -- UVLTrack-B (experiments/uvltrack/baseline_base.yaml, full
                 width, seeded random weights) tracks a synthetic 720p
                 sequence in BBOX, NLBBOX, then NL mode (initialized from
                 the sentence by the grounding forward, compared kernel vs
                 plain: the same argmax cell or a near-tie, the box within
                 1% of the letterbox side): FPS at batch 1, p50/p90 frame
                 latency, peak memory, launch counts (12 per backbone
                 forward, none of kernels #3/#7 with their knobs unset),
                 prompt re-mines; the same sequence on the "plain" backend;
                 the per-frame kernel-vs-plain box difference from a shared
                 state (paired_ab); each layer's time (layer_times, with the
                 grounding forward in NL mode) and the card's busy share
                 from torch.profiler (device_profile). Then BBOX and NLBBOX
                 with TPU.WEIGHT_QUANT=int8 (B-BBOX-Q8, B-NLBBOX-Q8), the
                 launches counted per instantiation.
     fused_prefix_off -- UVLTRACK_FUSED_PREFIX=0, BBOX, 16 frames: LN + qkv
                 plain and 12 qkv_attention launches per forward, no ln_qkv.
     fused_proj, fused_mlp -- UVLTRACK_FUSED_PROJ=1 / UVLTRACK_FUSED_MLP=1
                 on the bf16 and the int8 model, BBOX, 16 frames: 12
                 proj_residual / ln_mlp launches per forward (none of
                 ln_mlp with int8 weights), kernel vs plain through
                 paired_ab.
     bert_kernel -- UVLTRACK_PALLAS_MIN_N=32, NL mode: 18 attention launches
                 per initialize (6 BERT layers in the grounding forward, the
                 prompt init and encode_text), none per frame; the
                 grounding box and paired_ab kernel vs plain.
     q8_drift -- the int8 tracker against the bf16 one, each frame stepped
                 from the bf16 tracker's state: per-frame IoU and the share
                 of frames on the same cell (reported, not gated: the
                 weights are random).
  4. reference -- one step's model outputs on the card against the same
                 weights and inputs on the CPU (cpu_reference), for the bf16
                 and the int8 model, and the grounding forward's (bf16).
Then the {"kernels": [...]} line, the nvidia-smi name/power-limit line and,
last, {"ok": true, "device": {...}}. Any failure raises: no ok line, exit 1.
Without a CUDA card, or outside a checkout, it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
# H100 SXM peaks (NVIDIA data sheet; dense bf16 tensor-core rate, HBM3 rate)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
TPU_KERNEL = "uvltrack_tpu/ops/pallas_attention.py"
# bf16 tolerance, kernel vs plain: the same rounding points, sums in another
# order, so one bf16 rounding step (2^-8 relative) may differ:
# |kernel - plain| <= atol + KERNEL_RTOL*|plain|, with an absolute term of
# about two bf16 steps at each output's scale: qkv is about 1 to 8, the
# attention output about 0.1 (the softmax spreads over a hundred keys and
# more), so a few wrongly masked keys cannot hide under it
KERNEL_ATOL = {"ln_qkv": 2e-2, "qkv_attention": 6e-3, "ln_qkv_attention": 6e-3,
               # kernel #3: attention outputs, as qkv_attention; kernel #7: the
               # GELU hidden tensor (|h| up to about 4) as qkv, the MLP output
               # (|out| about 0.5) two bf16 steps at 0.5
               "attention": 6e-3, "ln_fc1_gelu": 2e-2, "fc2_bias": 6e-3, "ln_mlp": 6e-3}
KERNEL_RTOL = 2e-2
# kernel-vs-plain tracking A/B (paired_ab): boxes from the same cell within
# 1% of the search crop's side (a few bf16 steps of a crop-normalized box
# coordinate; a sixth of a 1/16 cell); cells that differ only on near-ties
AB_BOX_REL, AB_TIE = 1e-2, 0.05
# card (kernels, bf16) against the same port on the CPU (plain versions, bf16)
REF_ATOL, REF_RTOL = 3e-2, 3e-2
# bf16-compute instantiations of the int8 / fused-projection kernels: the
# KERNEL_* rule, with the absolute term of their outputs' scale (the
# post-residual stream, |out| about 1 to 4, takes ln_qkv's 2e-2; the
# projection alone, out of proj_residual on a zero stream, |proj| about 0.1
# on average and below 0.4 for 99% of elements, takes two bf16 steps at
# 0.25-0.5, the relative term covering its few larger values)
Q8_KERNEL_ATOL = {"ln_qkv": KERNEL_ATOL["ln_qkv"], "qkv_attention": KERNEL_ATOL["qkv_attention"],
                  "proj_residual": 2e-2, "proj": 2e-3}
# fp32-compute instantiations against their fp32 plain versions: fp32 sums in
# another order, and the hi/lo bf16 passes keep 2^-17 of each operand:
# |kernel - plain| <= F32_ATOL + F32_RTOL*|plain|
F32_ATOL, F32_RTOL = 2e-4, 2e-4


MLP_N = (48, 321, 361, 681)  # kernel #7's check shapes
ATTN_N = (40, 48, 128, 321, 361, 681)  # kernel #3's: BERT's N, 128 and the ViT's

TIMER = ("CUDA events, L2-warm: *ms = mean of 200 back-to-back eager calls after 20 "
         "warm-up (host time included where it exceeds the device's); *device_ms = a "
         "CUDA graph of 20 calls replayed 10 times (device time per call)")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (L2-warm)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_CAPTURE_STREAM = []  # one stream for every capture: cuBLAS keeps a workspace per stream


def graph_time_ms(fn, calls: int = 20, replays: int = 10):
    """Mean device time of fn(): `calls` back-to-back calls captured in one
    CUDA graph, replayed `replays` times between two events (L2-warm). The
    eager timing above includes the host's time per call (Python wrapper,
    ctypes, allocator) wherever that exceeds the device's; the replay leaves
    it out. Returns None, with the reason, if fn cannot be captured."""
    import torch

    if not _CAPTURE_STREAM:
        _CAPTURE_STREAM.append(torch.cuda.Stream())
    side = _CAPTURE_STREAM[0]
    try:
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up off the default stream, as PyTorch advises
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(calls):
                fn()
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (replays * calls), None
    except RuntimeError as e:
        torch.cuda.synchronize()
        return None, str(e)[:200]


def timings(kern, plain, lib) -> dict:
    """A kernel's, its plain version's and the library yardstick's times:
    eager (cuda_time_ms: ms, plain_ms, library_ms) and device
    (graph_time_ms: device_ms, plain_device_ms, library_device_ms). A kernel
    that cannot be captured in a CUDA graph fails the run (the device times
    and the step's future graph need it); the plain version's and the
    library call's capture errors are reported."""
    out = {"ms": cuda_time_ms(kern), "plain_ms": cuda_time_ms(plain),
           "library_ms": cuda_time_ms(lib) if lib else None}
    for key, fn in (("device_ms", kern), ("plain_device_ms", plain),
                    ("library_device_ms", lib)):
        out[key], why = graph_time_ms(fn) if fn else (None, None)
        if why and key == "device_ms":
            raise AssertionError(f"the kernel failed under CUDA-graph capture: {why}")
        if why:
            out[f"{key}_error"] = why
    return out


def bound(flops: float, nbytes: float):
    """(bound ms, what binds) for `flops` of bf16 tensor-core operations and
    `nbytes` moved. An fp32-accurate product is counted as the bf16 passes
    the card needs for it at the least: two for fp32 x bf16-exact operands
    (bf16 or int8 weights: hi/lo halves of the fp32 side), three for
    fp32 x fp32 (hi.hi + hi.lo + lo.hi); the callers multiply."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


# ------------------------------------------------------------------ phase 2
def key_mask(n: int, kind: str, rng):
    """flag0: the trailing 40 (text) keys masked, as BBOX mode masks the
    text; flag2: only trailing text padding masked; open: nothing."""
    import numpy as np

    m = np.zeros((1, n), bool)
    if kind == "flag0":
        m[:, -min(40, n // 2):] = True
    elif kind == "flag2":
        m[:, -min(int(rng.integers(5, 35)), n // 2):] = True
    return m


def kernel_phase(dev, seed: int):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from uvltrack_tpu_torch.ops import ln_qkv_attention as lqa

    c, heads = 768, 12
    rng = np.random.default_rng(seed)

    def case(n, kind, x_dtype):
        x = torch.from_numpy(rng.normal(size=(1, n, c)).astype(np.float32)).to(dev, x_dtype)
        g = torch.from_numpy((1 + 0.1 * rng.normal(size=c)).astype(np.float32)).to(dev)
        be = torch.from_numpy((0.1 * rng.normal(size=c)).astype(np.float32)).to(dev)
        w = torch.from_numpy((rng.normal(size=(3 * c, c)) / np.sqrt(c)).astype(np.float32))
        w = w.to(dev, torch.bfloat16)
        wb = torch.from_numpy((0.02 * rng.normal(size=3 * c)).astype(np.float32)).to(dev)
        kb = torch.from_numpy(np.where(key_mask(n, kind, rng), -1e10, 0.0)
                              .astype(np.float32)).to(dev)
        return x, g, be, w, wb, kb

    def err(name, a, b):
        a, b = a.float(), b.float()
        ok = bool(((a - b).abs() <= KERNEL_ATOL[name] + KERNEL_RTOL * b.abs()).all())
        return float((a - b).abs().max()), ok

    worst = {"ln_qkv": 0.0, "qkv_attention": 0.0, "ln_qkv_attention": 0.0}
    for n in (48, 321, 361, 681):
        for kind in ("flag0", "flag2", "open"):
            for x_dtype in (torch.bfloat16, torch.float32):
                x, g, be, w, wb, kb = case(n, kind, x_dtype)
                qkv = lqa.ln_qkv(x, g, be, w, wb)
                out = lqa.qkv_attention(qkv, kb, heads)
                again = lqa.qkv_attention(qkv, kb, heads)
                torch.cuda.synchronize()
                # the keys' cluster split summed in rank order: the same bits
                if not torch.equal(out, again):
                    raise AssertionError(f"qkv_attention N={n} mask={kind}: a second call "
                                         "differs (not bitwise repeatable)")
                checks = {
                    "ln_qkv": err("ln_qkv", qkv, lqa.ln_qkv_plain(x, g, be, w, wb)),
                    "qkv_attention": err("qkv_attention", out,
                                         lqa.qkv_attention_plain(qkv, kb, heads)),
                    "ln_qkv_attention": err("ln_qkv_attention", out, lqa.ln_qkv_attention_plain(
                        x, g, be, w, wb, kb, heads)),
                }
                for name, (e, ok) in checks.items():
                    if not ok:
                        raise AssertionError(f"{name} N={n} mask={kind} x={x_dtype}: "
                                             f"max abs err {e} over tolerance")
                    worst[name] = max(worst[name], e)
    emit({"phase": "kernel_check", "shapes_N": [48, 321, 361, 681],
          "masks": ["flag0", "flag2", "open"], "x_dtypes": ["bf16", "fp32"],
          "qkv_attention_repeatable": "bitwise, two calls at every check",
          "tolerance": {k: f"|kernel-plain| <= {a} + {KERNEL_RTOL}*|plain|"
                        for k, a in KERNEL_ATOL.items()},
          "max_abs_err": worst})

    def timed(n, kind, x_dtype):
        """{name: {ms, plain_ms, library_ms, bound_ms, bound_by}} at one shape.
        library_ms: one PyTorch call computing the same function where there
        is one (SDPA for the attention); for the LN+qkv half there is none,
        and its yardstick is F.layer_norm + F.linear (two calls), the
        composition's LN + linear + SDPA (three calls)."""
        x, g, be, w, wb, kb = case(n, kind, x_dtype)
        qkv = lqa.ln_qkv(x, g, be, w, wb)
        mask = kb.to(torch.bfloat16)[:, None, None, :]
        wb16 = wb.to(torch.bfloat16)

        def sdpa(t):
            q, k, v = t.view(1, n, 3, heads, 64).permute(2, 0, 3, 1, 4).unbind(0)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

        def library_fused():
            y = F.layer_norm(x.float(), (c,), g, be, 1e-6).to(torch.bfloat16)
            return sdpa(F.linear(y, w, wb16))

        f, xb = 3 * c, x.element_size()
        params = f * c * 2 + f * 4 + 2 * c * 4  # W bf16, qkv bias, LN scale/bias
        work = {  # (operations, bytes): each input read once, each output written once
            "ln_qkv": (2 * n * c * f, n * c * xb + params + n * f * 2),
            "qkv_attention": (4 * heads * n * n * 64, n * f * 2 + n * 4 + n * c * 2),
            "ln_qkv_attention": (2 * n * c * f + 4 * heads * n * n * 64,
                                 n * c * xb + params + n * 4 + n * c * 2),
        }
        def library_ln_qkv():
            y = F.layer_norm(x.float(), (c,), g, be, 1e-6).to(torch.bfloat16)
            return F.linear(y, w, wb16)

        fns = {
            "ln_qkv": (lambda: lqa.ln_qkv(x, g, be, w, wb),
                       lambda: lqa.ln_qkv_plain(x, g, be, w, wb), library_ln_qkv),
            "qkv_attention": (lambda: lqa.qkv_attention(qkv, kb, heads),
                              lambda: lqa.qkv_attention_plain(qkv, kb, heads),
                              lambda: sdpa(qkv)),
            "ln_qkv_attention": (
                lambda: lqa.ln_qkv_attention(x, g, be, w, wb, kb, heads),
                lambda: lqa.ln_qkv_attention_plain(x, g, be, w, wb, kb, heads),
                library_fused),
        }
        out = {}
        for name, (kern, plain, lib) in fns.items():
            b_ms, b_by = bound(*work[name])
            out[name] = {**timings(kern, plain, lib), "bound_ms": b_ms, "bound_by": b_by}
        return out

    # the main path's two shapes: blocks 0-5 (visual, N=321, bf16 stream,
    # nothing masked in BBOX mode) and blocks 6-11 (joint, N=361, fp32
    # stream, flag-0 mask on the 40 text keys)
    times = {"N321_bf16x_open": timed(321, "open", torch.bfloat16),
             "N361_fp32x_flag0": timed(361, "flag0", torch.float32)}
    emit({"phase": "kernel_times", "timer": TIMER, "times": times})
    return worst, times["N361_fp32x_flag0"]


def q8_kernel_phase(dev, seed: int):
    """Every int8 and fused-projection instantiation against its plain
    version on the card, over the grid of kernel_phase, then CUDA-event
    times at the main path's two shapes. Returns ({name: worst error},
    {shape: {name: times}})."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from uvltrack_tpu_torch.ops import ln_qkv_attention as lqa
    from uvltrack_tpu_torch.ops import ln_qkv_attn_proj as lqp
    from uvltrack_tpu_torch.ops import quant

    c, heads, f = 768, 12, 3 * 768
    rng = np.random.default_rng(seed + 1)

    def case(n, kind, x_dtype):
        def arr(a):
            return torch.from_numpy(a.astype(np.float32)).to(dev)

        x = arr(rng.normal(size=(1, n, c))).to(x_dtype)
        g, be = arr(1 + 0.1 * rng.normal(size=c)), arr(0.1 * rng.normal(size=c))
        w = arr(rng.normal(size=(f, c)) / np.sqrt(c)).to(torch.bfloat16)
        wp = arr(rng.normal(size=(c, c)) / np.sqrt(c)).to(torch.bfloat16)
        wb, bp = arr(0.02 * rng.normal(size=f)), arr(0.02 * rng.normal(size=c))
        kb = arr(np.where(key_mask(n, kind, rng), -1e10, 0.0))
        # the model's path: int8 payloads quantized from the bf16 weights
        return x, g, be, w, wb, wp, bp, kb, quant.quantize_weight(w), quant.quantize_weight(wp)

    def checks(x, g, be, w, wb, wp, bp, kb, wq, wpq):
        """{name: (kernel fn, plain fn, tolerance key or None for fp32)}"""
        xt = "fp32" if x.dtype == torch.float32 else "bf16"
        f32 = xt == "fp32"
        qkv = lqa.ln_qkv_q8(x, g, be, wq.q, wq.scale, wb)
        attn = lqa.qkv_attention(qkv, kb, heads)
        a16 = attn.to(torch.bfloat16)
        out = {
            f"ln_qkv[{xt}x-int8w]": (
                lambda: lqa.ln_qkv_q8(x, g, be, wq.q, wq.scale, wb),
                lambda: lqa.ln_qkv_q8_plain(x, g, be, wq.q, wq.scale, wb),
                None if f32 else "ln_qkv"),
            f"proj_residual[{xt}x-{xt}a-int8w]": (
                lambda: lqp.proj_residual(x, attn, wpq.q, bp, wpq.scale),
                lambda: lqp.proj_residual_plain(x, attn, wpq, bp),
                None if f32 else "proj_residual"),
            # bf16 A and Wp: exact products, so an fp32 x is fp32-accurate
            f"proj_residual[{xt}x-bf16a-bf16w]": (
                lambda: lqp.proj_residual(x, a16, wp, bp),
                lambda: lqp.proj_residual_plain(x, a16, wp, bp),
                None if f32 else "proj_residual"),
            f"#5 ln_qkv_attention_q8[{xt}x]": (
                lambda: lqa.ln_qkv_attention_q8(x, g, be, wq.q, wq.scale, wb, kb, heads),
                lambda: lqa.ln_qkv_attention_q8_plain(x, g, be, wq.q, wq.scale, wb, kb, heads),
                None if f32 else "qkv_attention"),
            f"#6 ln_qkv_attn_proj_q8[{xt}x]": (
                lambda: lqp.ln_qkv_attn_proj_q8(x, g, be, wq.q, wq.scale, wb, wpq.q, wpq.scale,
                                                bp, kb, heads),
                lambda: lqp.ln_qkv_attn_proj_q8_plain(x, g, be, wq.q, wq.scale, wb, wpq.q,
                                                      wpq.scale, bp, kb, heads),
                None if f32 else "proj_residual"),
            # #4 computes in bf16 whatever x is
            f"#4 ln_qkv_attn_proj[{xt}x]": (
                lambda: lqp.ln_qkv_attn_proj(x, g, be, w, wb, wp, bp, kb, heads),
                lambda: lqp.ln_qkv_attn_proj_plain(x, g, be, w, wb, wp, bp, kb, heads),
                "proj_residual"),
        }
        if f32:
            out["qkv_attention[fp32]"] = (lambda: lqa.qkv_attention(qkv, kb, heads),
                                          lambda: lqa.qkv_attention_plain(qkv, kb, heads), None)
        return out

    def proj_only(x, g, be, w, wb, wp, bp, kb, wq, wpq):
        """Each proj_residual instantiation on a zero residual stream, where
        out = cast_x(A . Wp^T (* scale) + b_proj) exactly: the epilogue held at
        the projection's own scale, which the post-residual checks above
        cannot resolve in bf16 (the residual add rounds at |x|'s scale)."""
        xt = "fp32" if x.dtype == torch.float32 else "bf16"
        tol_key = None if xt == "fp32" else "proj"
        z = torch.zeros_like(x)
        attn = lqa.qkv_attention(lqa.ln_qkv_q8(x, g, be, wq.q, wq.scale, wb), kb, heads)
        a16 = attn.to(torch.bfloat16)
        return {
            f"proj_residual[{xt}x-{xt}a-int8w] proj only": (
                lambda: lqp.proj_residual(z, attn, wpq.q, bp, wpq.scale),
                lambda: lqp.proj_residual_plain(z, attn, wpq, bp), tol_key),
            f"proj_residual[{xt}x-bf16a-bf16w] proj only": (
                lambda: lqp.proj_residual(z, a16, wp, bp),
                lambda: lqp.proj_residual_plain(z, a16, wp, bp), tol_key),
        }

    def err(tol_key, a, b):
        a, b = a.float(), b.float()
        if tol_key is None:
            ok = ((a - b).abs() <= F32_ATOL + F32_RTOL * b.abs()).all()
        else:
            ok = ((a - b).abs() <= Q8_KERNEL_ATOL[tol_key] + KERNEL_RTOL * b.abs()).all()
        return float((a - b).abs().max()), bool(ok)

    worst, proj_abs_max = {}, 0.0
    for n in (48, 321, 361, 681):
        for kind in ("flag0", "flag2", "open"):
            for x_dtype in (torch.bfloat16, torch.float32):
                args = case(n, kind, x_dtype)
                for name, (kern, plain, tol_key) in {**checks(*args),
                                                     **proj_only(*args)}.items():
                    got = kern()
                    torch.cuda.synchronize()
                    want = plain()
                    if got.dtype != want.dtype or got.shape != want.shape:
                        raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} vs plain "
                                             f"{want.dtype}{tuple(want.shape)}")
                    e, ok = err(tol_key, got, want)
                    if not ok:
                        raise AssertionError(f"{name} N={n} mask={kind}: max abs err {e} "
                                             "over tolerance")
                    worst[name] = max(worst.get(name, 0.0), e)
                    # split-K (split keys) summed in rank order: a second call gives
                    # the same bits
                    if name.startswith(("proj_residual", "qkv_attention")) and \
                            not torch.equal(got, kern()):
                        raise AssertionError(f"{name} N={n} mask={kind}: a second call "
                                             "differs (not bitwise repeatable)")
                    if name.endswith("proj only"):
                        proj_abs_max = max(proj_abs_max, float(want.float().abs().max()))
    emit({"phase": "q8_kernel_check", "shapes_N": [48, 321, 361, 681],
          "masks": ["flag0", "flag2", "open"], "x_dtypes": ["bf16", "fp32"],
          "proj_only_abs_max": proj_abs_max,
          "proj_residual_repeatable": "bitwise, two calls of every proj_residual check",
          "qkv_attention_fp32_repeatable": "bitwise, two calls of every qkv_attention[fp32] check",
          "tolerance": {"bf16 compute": {k: f"|kernel-plain| <= {a} + {KERNEL_RTOL}*|plain|"
                                         for k, a in Q8_KERNEL_ATOL.items()},
                        "fp32 compute": f"|kernel-plain| <= {F32_ATOL} + {F32_RTOL}*|plain|"},
          "max_abs_err": worst})

    def work(name, n, xb):
        """(bf16-pass operations, bytes): each input read once, each output
        written once; fp32-accurate products counted in bf16 passes (bound)."""
        f32 = xb == 4
        ln_params = 2 * c * 4 + f * 4  # LN scale/bias, qkv bias
        pre = (2 * n * c * f * (2 if f32 else 1),
               n * c * xb + f * c + f * 4 + ln_params)  # + int8 W and its scale
        att = (4 * heads * n * n * 64 * (3 if f32 else 1), n * 4)  # + key bias
        prj_q8 = (2 * n * c * c * (2 if f32 else 1), c * c + c * 4 + c * 4)
        prj16 = (2 * n * c * c, c * c * 2 + c * 4)
        if name.startswith("ln_qkv["):
            return pre[0], pre[1] + n * f * xb
        if name == "qkv_attention[fp32]":
            return att[0], n * f * 4 + att[1] + n * c * 4
        if name.startswith("proj_residual") and name.endswith("int8w]"):
            return prj_q8[0], prj_q8[1] + 3 * n * c * xb  # x, A in x's dtype, out
        if name.startswith("proj_residual"):
            return prj16[0], prj16[1] + 2 * n * c * xb + n * c * 2  # x, out; bf16 A
        if name.startswith("#5"):
            return pre[0] + att[0], pre[1] + att[1] + n * c * xb
        if name.startswith("#6"):
            return pre[0] + att[0] + prj_q8[0], pre[1] + att[1] + prj_q8[1] + n * c * xb
        # #4: bf16 weights, bf16 compute
        return (2 * n * c * f + 4 * heads * n * n * 64 + 2 * n * c * c,
                n * c * xb + f * c * 2 + ln_params + n * 4 + prj16[1] + n * c * xb)

    def library(name, x, g, be, w, wb, wp, bp, kb, wq, wpq):
        """One PyTorch call computing the same function where there is one
        (SDPA for the fp32 attention); else the nearest composition of
        library calls, named in `library` (dense weights dequantized before
        the timing)."""
        n = x.shape[1]
        mask = kb.to(x.dtype)[:, None, None, :]
        wpd = wpq.materialize(x.dtype)

        def sdpa(t):
            q, k, v = t.view(1, n, 3, heads, 64).permute(2, 0, 3, 1, 4).unbind(0)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask.to(t.dtype))

        qkv = lqa.ln_qkv_q8(x, g, be, wq.q, wq.scale, wb)
        attn = lqa.qkv_attention(qkv, kb, heads)
        wqd = wq.materialize(x.dtype)
        if name == "qkv_attention[fp32]":
            return lambda: sdpa(qkv), "SDPA"
        if name.startswith("proj_residual") and name.endswith("int8w]"):
            return lambda: torch.add(x, F.linear(attn, wpd, bp.to(x.dtype))), \
                "F.linear + add, 2 calls"
        if name.startswith("proj_residual"):
            a16 = attn.to(torch.bfloat16)
            return lambda: torch.add(x, F.linear(a16, wp, bp.to(torch.bfloat16))), \
                "F.linear + add, 2 calls"

        def ln(dt):
            return F.layer_norm(x.float(), (c,), g, be, 1e-6).to(dt)

        if name.startswith("ln_qkv["):
            return lambda: F.linear(ln(x.dtype), wqd, wb.to(x.dtype)), \
                "F.layer_norm + F.linear (dequantized W), 2 calls"
        if name.startswith("#5"):
            return lambda: sdpa(F.linear(ln(x.dtype), wqd, wb.to(x.dtype))), \
                "LN + linear + SDPA, 3 calls"
        if name.startswith("#6"):
            return lambda: torch.add(x, F.linear(sdpa(F.linear(ln(x.dtype), wqd, wb.to(x.dtype)))
                                                 .transpose(1, 2).reshape(1, n, c), wpd,
                                                 bp.to(x.dtype))), \
                "LN + linear + SDPA + linear + add, 5 calls"
        if name.startswith("#4"):
            b16 = torch.bfloat16
            return lambda: torch.add(x, F.linear(sdpa(F.linear(ln(b16), w, wb.to(b16)))
                                                 .transpose(1, 2).reshape(1, n, c), wp,
                                                 bp.to(b16))), \
                "LN + linear + SDPA + linear + add, 5 calls"
        return None, "none (no one call)"

    def timed(n, kind, x_dtype):
        args = case(n, kind, x_dtype)
        xb = args[0].element_size()
        out = {}
        for name, (kern, plain, _) in checks(*args).items():
            lib, lib_what = library(name, *args)
            b_ms, b_by = bound(*work(name, n, xb))
            out[name] = {**timings(kern, plain, lib), "library": lib_what,
                         "bound_ms": b_ms, "bound_by": b_by}
        return out

    times = {"N321_bf16x_open": timed(321, "open", torch.bfloat16),
             "N361_fp32x_flag0": timed(361, "flag0", torch.float32)}
    emit({"phase": "q8_kernel_times", "timer": TIMER, "times": times})
    return worst, times


def fused_kernel_phase(dev, seed: int):
    """Kernel #3 (`attention`, BERT's layout: three (1, N, 768) products
    viewed as (1, 12, N, 64)) and kernel #7 (`ln_mlp`, ViT-B's MLP, C=768,
    F=3072: the pair and each launch alone) against their plain versions on
    the card, then CUDA-event times: #3 at N=40 (BERT's length) and N=128,
    #7 at the main path's two shapes. Returns ({name: worst error},
    {shape: {name: times}})."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from uvltrack_tpu_torch.ops import fused_attention as fa
    from uvltrack_tpu_torch.ops import ln_mlp as lm

    c, heads, f = 768, 12, 3072
    rng = np.random.default_rng(seed + 2)

    def arr(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    def attn_case(n, kind):
        """bert: trailing text padding at -10000; all: every key at -10000
        (BBOX mode's empty text); open: nothing; flag0: the ViT's -1e10 on
        the trailing 40 keys."""
        q, k, v = (arr(rng.normal(size=(1, n, c))).to(torch.bfloat16)
                   .view(1, n, heads, 64).transpose(1, 2) for _ in range(3))
        kb = np.zeros((1, n), np.float32)
        if kind == "bert":
            kb[:, int(rng.integers(5, n)):] = -10000.0
        elif kind == "all":
            kb[:] = -10000.0
        elif kind == "flag0":
            kb = np.where(key_mask(n, "flag0", rng), -1e10, 0.0)
        return q, k, v, arr(kb)

    def mlp_case(n, x_dtype):
        x = arr(rng.normal(size=(1, n, c))).to(x_dtype)
        g, be = arr(1 + 0.1 * rng.normal(size=c)), arr(0.1 * rng.normal(size=c))
        w1 = arr(rng.normal(size=(f, c)) / np.sqrt(c)).to(torch.bfloat16)
        w2 = arr(rng.normal(size=(c, f)) / np.sqrt(f)).to(torch.bfloat16)
        b1, b2 = arr(0.02 * rng.normal(size=f)), arr(0.02 * rng.normal(size=c))
        return x, g, be, w1, b1, w2, b2

    worst = {}

    def check(name, got, want, what):
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{name} {what}: {got.dtype}{tuple(got.shape)} vs plain "
                                 f"{want.dtype}{tuple(want.shape)}")
        a, b = got.float(), want.float()
        e = float((a - b).abs().max())
        if not bool(((a - b).abs() <= KERNEL_ATOL[name] + KERNEL_RTOL * b.abs()).all()):
            raise AssertionError(f"{name} {what}: max abs err {e} over tolerance")
        worst[name] = max(worst.get(name, 0.0), e)

    for n in ATTN_N:
        for kind in ("bert", "all", "open", "flag0"):
            q, k, v, kb = attn_case(n, kind)
            out = fa.fused_attention(q, k, v, kb)
            again = fa.fused_attention(q, k, v, kb)
            torch.cuda.synchronize()
            check("attention", out, fa.fused_attention_plain(q, k, v, kb), f"N={n} mask={kind}")
            if not torch.equal(out, again):
                raise AssertionError(f"attention N={n} mask={kind}: a second call differs")
    for n in MLP_N:
        for x_dtype in (torch.bfloat16, torch.float32):
            x, g, be, w1, b1, w2, b2 = mlp_case(n, x_dtype)
            hidden = torch.empty((n, f), dtype=torch.bfloat16, device=dev)
            out = torch.empty((1, n, c), dtype=torch.bfloat16, device=dev)
            lm.launch_ln_mlp(x, g, be, w1, b1, w2, b2, hidden, out)
            again = torch.empty_like(out)
            lm.launch_ln_mlp(x, g, be, w1, b1, w2, b2, hidden, again, stages="fc2_bias")
            torch.cuda.synchronize()
            what = f"N={n} x={x_dtype}"
            check("ln_fc1_gelu", hidden,
                  lm.ln_fc1_gelu_plain(x, g, be, w1, b1).to(torch.bfloat16).view(n, f), what)
            check("fc2_bias", out, lm.fc2_bias_plain(hidden.view(1, n, f), w2, b2), what)
            check("ln_mlp", out, lm.ln_mlp_plain(x, g, be, w1, b1, w2, b2), what)
            # split-K over a cluster, reduced in rank order: bit for bit again
            if not torch.equal(out, again):
                raise AssertionError(f"fc2_bias {what}: a second call differs "
                                     f"(max {float((out.float() - again.float()).abs().max())})")
    emit({"phase": "fused_kernel_check", "attention_N": list(ATTN_N),
          "attention_masks": ["bert", "all", "open", "flag0"], "ln_mlp_N": list(MLP_N),
          "fc2_bias_repeatable": "bitwise, two calls at every ln_mlp shape",
          "attention_repeatable": "bitwise, two calls at every attention check",
          "x_dtypes": ["bf16", "fp32"],
          "tolerance": {k: f"|kernel-plain| <= {KERNEL_ATOL[k]} + {KERNEL_RTOL}*|plain|"
                        for k in worst},
          "max_abs_err": worst})

    def row(kern, plain, lib, lib_what, work):
        b_ms, b_by = bound(*work)
        return {**timings(kern, plain, lib), "library": lib_what,
                "bound_ms": b_ms, "bound_by": b_by}

    def attn_times(n):
        q, k, v, kb = attn_case(n, "bert")
        mask = kb.to(torch.bfloat16)[:, None, None, :]
        work = (4 * heads * n * n * 64, 3 * n * c * 2 + n * 4 + n * c * 2)
        return {"attention[bf16]": row(
            lambda: fa.fused_attention(q, k, v, kb), lambda: fa.fused_attention_plain(q, k, v, kb),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), "SDPA", work)}

    def mlp_times(n, x_dtype):
        x, g, be, w1, b1, w2, b2 = mlp_case(n, x_dtype)
        tag = f"ln_mlp[{'fp32' if x_dtype == torch.float32 else 'bf16'}x-bf16w]"
        hidden = torch.empty((n, f), dtype=torch.bfloat16, device=dev)
        out = torch.empty((1, n, c), dtype=torch.bfloat16, device=dev)
        h3 = hidden.view(1, n, f)
        b16 = torch.bfloat16
        xb, vecs = x.element_size(), (f + 3 * c) * 4  # b1, b2, LN scale/bias

        def fc1_lib():
            y = F.layer_norm(x.float(), (c,), g, be, 1e-6).to(b16)
            return F.gelu(F.linear(y, w1, b1.to(b16)))

        def launch(stages):
            return lambda: lm.launch_ln_mlp(x, g, be, w1, b1, w2, b2, hidden, out,
                                            stages=stages)

        return {
            tag: row(launch("pair"), lambda: lm.ln_mlp_plain(x, g, be, w1, b1, w2, b2),
                     lambda: F.linear(fc1_lib(), w2, b2.to(b16)),
                     "F.layer_norm + F.linear + F.gelu + F.linear, 4 calls",
                     (4 * n * c * f, n * c * xb + 2 * c * f * 2 + vecs + n * c * 2)),
            f"{tag} ln_fc1_gelu": row(
                launch("ln_fc1_gelu"), lambda: lm.ln_fc1_gelu_plain(x, g, be, w1, b1).to(b16),
                fc1_lib, "F.layer_norm + F.linear + F.gelu, 3 calls",
                (2 * n * c * f, n * c * xb + c * f * 2 + (f + 2 * c) * 4 + n * f * 2)),
            f"{tag} fc2_bias": row(
                launch("fc2_bias"), lambda: lm.fc2_bias_plain(h3, w2, b2),
                lambda: F.linear(h3, w2, b2.to(b16)), "F.linear",
                (2 * n * f * c, n * f * 2 + c * f * 2 + c * 4 + n * c * 2)),
        }

    times = {"N40_bert": attn_times(40), "N128_bert": attn_times(128),
             "N321_bf16x": mlp_times(321, torch.bfloat16),
             "N361_fp32x": mlp_times(361, torch.float32)}
    emit({"phase": "fused_kernel_times", "timer": TIMER, "times": times})
    return worst, times


# ------------------------------------------------------------------ phase 3
def frame_work(model, nt: int) -> dict:
    """Operations and weight bytes of one tracked frame, from the shapes:
    the 12 blocks (qkv, attention, projection, MLP), the patch embedding and
    the head's conv towers (3x3 stages and the final 1x1), and the weights
    the step reads (blocks, patch embedding, towers) at their stored width."""
    import torch

    bb, head = model.backbone, model.box_head
    c = bb.embed_dim
    n_vis = 1 + bb.num_patches_z + bb.num_patches_x
    flops, kernel1 = 0, 0
    for i in range(bb.depth):
        n = n_vis + nt if i in bb.fusion_layers else n_vis
        qkv_attn = 6 * n * c * c + 4 * n * n * c
        kernel1 += qkv_attn
        flops += qkv_attn + 18 * n * c * c  # + proj (2NC^2) + MLP (16NC^2)
    flops += 2 * (bb.num_patches_z + bb.num_patches_x) * c * 3 * 16 * 16
    cells = head.feat_sz ** 2
    towers = [head.conv_cls, head.conv_offset, head.conv_bbox, head.conv_bbox_grounding]
    for tower in towers:
        for m in tower.modules():
            if isinstance(m, torch.nn.Conv2d):
                kh, kw = m.kernel_size
                flops += 2 * cells * m.in_channels * kh * kw * m.out_channels
    used = [bb.vit.blocks, bb.vit.patch_embed, *towers]
    wbytes = sum(p.numel() * p.element_size() for mod in used for p in mod.parameters())
    # int8 payloads and their scales (weight-only int8) are buffers
    wbytes += sum(b.numel() * b.element_size() for mod in used
                  for name, b in mod.named_buffers() if name.endswith(("weight_q", "weight_scale")))
    return {"frame_gflops": flops / 1e9, "kernel1_gflops": kernel1 / 1e9,
            "frame_weight_bytes": wbytes,
            "frame_bound_ms": bound(flops, wbytes)[0], "frame_bound_by": bound(flops, wbytes)[1]}


def synthetic_sequence(n_frames: int, seed: int, h: int = 720, w: int = 1280):
    """A textured background and a textured 96x64 target moving on a
    Lissajous path; returns (frames, ground-truth xywh boxes)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, size=(h // 16 + 1, w // 16 + 1, 3)).astype(np.uint8)
    bg = np.repeat(np.repeat(coarse, 16, 0), 16, 1)[:h, :w]
    bg = (bg // 2 + rng.integers(0, 128, size=(h, w, 3), dtype=np.uint8))
    tw, th = 96, 64
    target = rng.integers(0, 256, size=(th // 8, tw // 8, 3)).astype(np.uint8)
    target = np.repeat(np.repeat(target, 8, 0), 8, 1)
    frames, boxes = [], []
    for t in range(n_frames + 1):
        cx = w / 2 + 0.3 * w * np.sin(2 * np.pi * t / 90)
        cy = h / 2 + 0.25 * h * np.sin(2 * np.pi * t / 70)
        x0, y0 = int(cx - tw / 2), int(cy - th / 2)
        f = bg.copy()
        f[y0:y0 + th, x0:x0 + tw] = target
        frames.append(f)
        boxes.append([float(x0), float(y0), float(tw), float(th)])
    return frames, boxes


def write_vocab(path: Path, words, seed: int) -> None:
    """A tiny WordPiece vocab made from the seed (no vocab file ships)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    filler = ["".join(rng.choice(list("abcdefghij"), 5)) for _ in range(64)]
    toks = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + sorted(set(words)) + filler
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(dict.fromkeys(toks)) + "\n")


def paired_ab(tracker, frames, info):
    """Kernel path against the plain ("composed") path on every frame from
    the same state: each frame is stepped on the plain backend, the state is
    put back, and the frame is stepped on the kernel backend, whose state
    goes on. A free-running A/B drifts apart after the first argmax that
    falls the other way on a near-flat random-weight response map, so the
    per-frame comparison is made from a shared state.

    Tolerance (bf16 noise; the kernel and plain versions round at the same
    points, in another summation order): where both pick the same cell, the
    boxes agree within AB_BOX_REL of the search crop's side (the head
    regresses boxes in crop-normalized units; one cell is 1/16 of the side);
    where they pick different cells, each path's pick scores within AB_TIE
    of the other's maximum in both merged maps (a near-tie, which bf16 noise
    may break either way)."""
    import math

    import numpy as np

    from uvltrack_tpu_torch.ops import attention

    attention.force_backend("cuda")
    tracker.initialize(frames[0], info)
    same, flips, box_px, box_rel = 0, 0, [], []
    for f in frames[1:]:
        st = tracker.state
        _, _, bw, bh = st.box.tolist()
        crop = math.ceil(math.sqrt(bw * bh) * tracker.search_factor)
        attention.force_backend("plain")
        p = tracker.track_debug(f)
        tracker.state = st
        attention.force_backend("cuda")
        k = tracker.track_debug(f)
        mp, mk = p["merged_map"].ravel(), k["merged_map"].ravel()
        ip, ik = int(mp.argmax()), int(mk.argmax())
        d = float(np.abs(np.subtract(p["target_bbox"], k["target_bbox"])).max())
        if ip == ik:
            same += 1
            box_px.append(d)
            box_rel.append(d / crop)
            if d > AB_BOX_REL * crop:
                raise AssertionError(f"same cell, boxes {d} px apart on a {crop} px crop "
                                     f"(> {AB_BOX_REL} of its side)")
        else:
            flips += 1
            if mk[ip] < (1 - AB_TIE) * mk[ik] or mp[ik] < (1 - AB_TIE) * mp[ip]:
                raise AssertionError(f"argmax flip that is not a near-tie: plain "
                                     f"{mp[ip]:.4g}/{mp[ik]:.4g} kernel {mk[ik]:.4g}/{mk[ip]:.4g}")
    attention.force_backend(None)
    return {"frames": len(frames) - 1, "same_cell": same, "near_tie_flips": flips,
            "box_diff_px_max_same_cell": max(box_px, default=0.0),
            "box_diff_px_mean_same_cell": float(np.mean(box_px)) if box_px else 0.0,
            "box_diff_crop_frac_max_same_cell": max(box_rel, default=0.0),
            "box_diff_crop_frac_mean_same_cell": float(np.mean(box_rel)) if box_rel else 0.0,
            "tolerance": f"same cell: <= {AB_BOX_REL} of the crop side; other cell: "
                         f"within {AB_TIE:.0%} of the max in both maps"}


def grounding_ab(tracker, frame):
    """The grounding forward of one frame on the plain, then the kernel
    backend (the tracker's sentence tokenized already): the argmax cell of
    cls x contrastive score (convert2bbox's pick) must agree, or be a
    near-tie within AB_TIE in both maps, and on the same cell the boxes
    (cxcywh normalized to the letterbox side) within AB_BOX_REL of it."""
    import torch

    from uvltrack_tpu_torch.ops import attention

    outs = {}
    for backend in ("plain", "cuda"):
        attention.force_backend(backend)
        o = tracker.grounding_forward(tracker._frame(frame))
        merged = (o["cls_score_test"].float() * torch.softmax(o["cont_score"].float(), -1)[..., 0])
        outs[backend] = (merged[0].cpu(), o["pred_boxes"][0, 0].float().cpu())
    attention.force_backend(None)
    (mp, bp), (mk, bk) = outs["plain"], outs["cuda"]
    ip, ik = int(mp.argmax()), int(mk.argmax())
    d = float((bp - bk).abs().max())
    if ip == ik and d > AB_BOX_REL:
        raise AssertionError(f"grounding: same cell, boxes {d} apart (> {AB_BOX_REL} of the side)")
    if ip != ik and (mk[ip] < (1 - AB_TIE) * mk[ik] or mp[ik] < (1 - AB_TIE) * mp[ip]):
        raise AssertionError(f"grounding: argmax flip that is not a near-tie: plain "
                             f"{float(mp[ip]):.4g}/{float(mp[ik]):.4g} kernel "
                             f"{float(mk[ik]):.4g}/{float(mk[ip]):.4g}")
    return {"same_cell": ip == ik, "box_diff_side_frac": d, "box_kernel": bk.tolist(),
            "box_plain": bp.tolist()}


def track_phase(mode: str, model, cfg, frames, boxes, tokenizer, language,
                expect=None, label: str = ""):
    """One cell: `expect` gives the launches per backbone forward of each
    kernel instantiation, when the caller checks them (build.instantiation_counts).
    NL mode initializes with two backbone forwards (grounding, prompt init)
    and first compares the grounding forward kernel vs plain."""
    import numpy as np
    import torch

    from uvltrack_tpu_torch.ops import attention
    from uvltrack_tpu_torch.ops import build
    from uvltrack_tpu_torch.track.tracker import Tracker

    cfg.TEST.MODE = mode
    tracker = Tracker(cfg, model, tokenizer=tokenizer)
    info = {"init_bbox": boxes[0], "language": language}

    def run(backend: str):
        attention.force_backend(backend)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tracker.initialize(frames[0], info)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        lat, out = [], []
        for f in frames[1:]:
            t = time.perf_counter()
            r = tracker.track(f)  # reads the box back: ends in a synchronize
            lat.append(time.perf_counter() - t)
            out.append(r["target_bbox"] + [r["score"]])
        attention.force_backend(None)
        return np.asarray(out), np.asarray(lat), init_s, tracker.remines

    run("cuda")  # warm-up: cuDNN/cuBLAS handles, allocator, first launches
    run("plain")
    # in turns, plain / kernel / kernel / plain: one card, one call
    plain, plat, _, plain_remines = run("plain")
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()  # every model on the card, this one's included
    build.reset_launch_counts()
    res, lat, init_s, remines = run("cuda")
    counts = build.launch_counts()
    inst = build.instantiation_counts()
    # initialize's backbone passes (NL: grounding + prompt init) + one per frame
    forwards = len(frames) + (mode == "NL")
    peak = torch.cuda.max_memory_allocated()
    _, lat2, _, _ = run("cuda")
    _, plat2, _, _ = run("plain")
    lat, plat = np.concatenate([lat, lat2]), np.concatenate([plat, plat2])
    if build.launch_counts() != {k: 2 * v for k, v in counts.items()}:
        raise AssertionError("the plain backend launched a kernel")
    # kernels #3 and #7 (attention, ln_mlp) stay off with their knobs unset
    if counts != dict(dict.fromkeys(build.SOURCES, 0), ln_qkv=12 * forwards,
                      qkv_attention=12 * forwards):
        raise AssertionError(f"launches {counts} != 12 x {forwards} backbone forwards")
    if expect is not None and inst != {k: v * forwards for k, v in expect.items()}:
        raise AssertionError(f"launches {inst} != {expect} x {forwards} backbone forwards")
    if not np.isfinite(res).all() or res.shape != (len(frames) - 1, 5):
        raise AssertionError("non-finite or misshapen tracker output")
    if remines < len(res) // int(cfg.TEST.UPDATE_INTERVAL):
        raise AssertionError(f"only {remines} prompt re-mines")
    ground = grounding_ab(tracker, frames[0]) if mode == "NL" else None
    ab = paired_ab(tracker, frames, info)
    attention.force_backend("cuda")
    layers = layer_times(tracker, frames)
    busy = device_profile(tracker, frames, info)
    attention.force_backend(None)
    emit({"phase": f"track_{mode}{label}", "frames": len(res),
          "frame_hw": list(frames[0].shape[:2]),
          "timer": "host clock per track() call, ending in the box read-back; two runs "
                   "of the sequence per backend, in turns plain/kernel/kernel/plain",
          "tracked_fps": len(lat) / float(lat.sum()),
          "latency_ms_p50": float(np.percentile(lat, 50) * 1e3),
          "latency_ms_p90": float(np.percentile(lat, 90) * 1e3),
          "init_s": init_s, "peak_mem_bytes": int(peak), "resident_at_start_bytes": int(resident),
          "launches": counts, "launches_by_instantiation": inst,
          "backbone_forwards": forwards,
          "remines": remines, "plain_remines": plain_remines,
          "plain_fps": len(plat) / float(plat.sum()),
          "plain_latency_ms_p50": float(np.percentile(plat, 50) * 1e3),
          "plain_latency_ms_p90": float(np.percentile(plat, 90) * 1e3),
          "ab_per_frame": ab, **({"grounding_ab": ground} if ground else {}),
          "free_running_box_diff_px_max": float(np.abs(res[:, :4] - plain[:, :4]).max()),
          "score_range": [float(res[:, 4].min()), float(res[:, 4].max())],
          "layer_ms": layers, "device_profile": busy})
    return inst


def reference_phase(model, cfg, frames, boxes, label: str = "", tokenizer=None,
                    language=None):
    """Model outputs on the card (kernel backend, bf16) against the same
    weights and inputs on the CPU, where every wrapper takes its plain
    version, the path that the CPU tests hold against the JAX package: one
    tracking step (forward_test_cached) or, given a tokenizer and a sentence,
    the grounding forward of the first frame (UVLTrack.forward under flag
    1). Tolerance: bf16 summation-order noise through 12 blocks and the
    head, |card - cpu| <= REF_ATOL + REF_RTOL*|cpu| (the CPU tests' bf16
    parity bound)."""
    import copy

    import torch

    from uvltrack_tpu_torch.ops import attention
    from uvltrack_tpu_torch.ops import build
    from uvltrack_tpu_torch.track.pipeline import sample_target_device
    from uvltrack_tpu_torch.track.tracker import Tracker

    grounding = tokenizer is not None
    cfg.TEST.MODE = "NL" if grounding else "BBOX"
    t = Tracker(cfg, model, tokenizer=tokenizer)
    attention.force_backend("cuda")
    keys = ("cls_score_test", "bbox_map", "cont_score")
    if grounding:
        t.text_ids, t.text_mask = t._tokenize(language)
        args = t.grounding_inputs(t._frame(frames[0]))
        keys += ("pred_boxes",)

        def fwd(m, *a):
            return m(*a)
    else:
        t.initialize(frames[0], {"init_bbox": boxes[0]})
        search, _ = sample_target_device(t._frame(frames[1]), t.state.box, t.search_factor,
                                         t.search_size)
        args = (t.template, search, t.txt, t.text_mask, t.state.prompt, t.flag)

        def fwd(m, *a):
            return m.forward_test_cached(*a)
    before = build.launch_counts()
    with torch.no_grad():
        card = fwd(model, *args)
        launched = build.launch_counts() != before
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cpu = fwd(copy.deepcopy(model).cpu(), *(a.cpu() for a in args))
        cpu_s = time.perf_counter() - t0
    attention.force_backend(None)
    if not launched:
        raise AssertionError("the card's reference step launched no kernel")
    errs = {}
    for k in keys:
        a, b = card[k].float().cpu(), cpu[k].float()
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{k}: non-finite or shape {tuple(a.shape)} != {tuple(b.shape)}")
        errs[k] = float((a - b).abs().max())
        if not bool(((a - b).abs() <= REF_ATOL + REF_RTOL * b.abs()).all()):
            raise AssertionError(f"{k}: card and CPU differ by {errs[k]} (over tolerance)")

    def cell(o):
        merged = o["cls_score_test"].float().cpu() * torch.softmax(
            o["cont_score"].float().cpu(), -1)[..., 0]
        return int(merged.argmax())

    emit({"phase": f"cpu_reference{label}",
          "what": ("UVLTrack.forward, the NL grounding forward of frame 0" if grounding
                   else "forward_test_cached, one BBOX step") + ", full width",
          "max_abs_err": errs, "same_argmax_cell": cell(card) == cell(cpu),
          "tolerance": f"|card-cpu| <= {REF_ATOL} + {REF_RTOL}*|cpu|", "cpu_s": cpu_s})


def layer_times(tracker, frames, iters: int = 30):
    """CUDA-event time of each layer of one tracking step, called back to
    back on the kernel backend at the step's own inputs: crop (search
    crop/resize/normalize), backbone (forward_cached_text: patch embed and
    12 blocks), head (MABH test path), remine (forward_prompt); step is a
    whole Tracker.step (the parts plus decode and state update); in NL
    mode, grounding is the initialization's grounding forward. Where the
    host cannot keep the card fed, these include the gaps between kernels,
    so the parts need not add up to the step."""
    import torch

    from uvltrack_tpu_torch.core.box_ops import box_cxcywh_to_xywh
    from uvltrack_tpu_torch.core.geometry import anno2mask
    from uvltrack_tpu_torch.track.pipeline import sample_target_device

    t, m = tracker, tracker.model
    frame = t._frame(frames[1])
    st = t.state
    ctx = anno2mask(box_cxcywh_to_xywh(torch.tensor([[0.5, 0.5, 0.2, 0.2]], device=t.device)),
                    t.map_size)
    with torch.no_grad():
        search, _ = sample_target_device(frame, st.box, t.search_factor, t.search_size)
        feats = m.backbone.forward_cached_text(t.template, search, t.txt, t.text_mask, t.flag)
        out = {
            "crop": cuda_time_ms(lambda: sample_target_device(
                frame, st.box, t.search_factor, t.search_size), iters, 3),
            "backbone": cuda_time_ms(lambda: m.backbone.forward_cached_text(
                t.template, search, t.txt, t.text_mask, t.flag), iters, 3),
            "head": cuda_time_ms(lambda: m.box_head(feats, st.prompt), iters, 3),
            "remine": cuda_time_ms(lambda: m.forward_prompt(feats, t.template_mask, ctx),
                                   iters, 3),
        }

        def step():
            t.state = st
            t.step(frame)

        out["step"] = cuda_time_ms(step, iters, 3)
        if t.cfg.TEST.MODE == "NL":  # letterbox + UVLTrack.forward, once per sequence
            first = t._frame(frames[0])
            out["grounding"] = cuda_time_ms(lambda: t.grounding_forward(first), iters, 3)
    t.state = st
    return out


def device_profile(tracker, frames, info, n: int = 16):
    """torch.profiler over n tracked frames on the kernel backend: the card's
    busy share (summed kernel and copy time over the host-clock window) and
    the kernels that take most of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tracker.initialize(frames[0], info)
    tracker.track(frames[1])
    n = len(frames[2:2 + n])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in frames[2:2 + n]:
            tracker.track(f)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return float(e.self_device_time_total)

    # the device's own events (kernels, copies, memsets); the CPU ops that
    # launched them carry the same time again and are left out
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    total = sum(dev_us(e) for e in evs)
    if total == 0:
        return {"frames": n, "device_time": "not measured (the profiler saw no device time)"}
    top = sorted(evs, key=dev_us, reverse=True)[:12]
    return {"frames": n, "wall_ms_per_frame": wall_us / n / 1e3,
            "device_ms_per_frame": total / n / 1e3, "busy_share": total / wall_us,
            "device_ops_per_frame": sum(e.count for e in evs) / n,
            "top": [{"name": e.key[:90], "calls_per_frame": e.count / n,
                     "ms_per_frame": dev_us(e) / n / 1e3} for e in top]}


def knob_phase(name: str, knob: str, value: str, model, cfg, frames, boxes, expect,
               mode: str = "BBOX", tokenizer=None, language=None, expect_init=None):
    """One environment knob of ops/attention.py set (read at call time):
    `mode` over len(frames)-1 frames on the kernel backend, its launches per
    instantiation checked -- `expect` per backbone forward of a tracked
    frame, `expect_init` per initialize (default: `expect` per backbone
    forward of it) -- and host-clock FPS, then (NL: the grounding forward
    and) the kernel-vs-plain paired_ab and a profiler window. Returns the
    launches of the counted initialize and frames."""
    import numpy as np
    import torch

    from uvltrack_tpu_torch.ops import attention
    from uvltrack_tpu_torch.ops import build
    from uvltrack_tpu_torch.track.tracker import Tracker

    cfg.TEST.MODE = mode
    tracker = Tracker(cfg, model, tokenizer=tokenizer)
    info = {"init_bbox": boxes[0], "language": language}
    init_forwards = 1 + (mode == "NL")
    expect_init = expect_init or {k: v * init_forwards for k, v in expect.items()}
    os.environ[knob] = value
    try:
        attention.force_backend("cuda")
        tracker.initialize(frames[0], info)  # warm-up
        torch.cuda.synchronize()
        build.reset_launch_counts()
        tracker.initialize(frames[0], info)
        init_inst = build.instantiation_counts()
        build.reset_launch_counts()
        lat = []
        for f in frames[1:]:
            t = time.perf_counter()
            tracker.track(f)
            lat.append(time.perf_counter() - t)
        inst = build.instantiation_counts()
        attention.force_backend(None)
        if init_inst != expect_init:
            raise AssertionError(f"{name}: initialize launched {init_inst} != {expect_init}")
        if inst != {k: v * len(lat) for k, v in expect.items()}:
            raise AssertionError(f"{name}: {len(lat)} frames launched {inst} != {expect} "
                                 f"x {len(lat)}")
        ground = grounding_ab(tracker, frames[0]) if mode == "NL" else None
        ab = paired_ab(tracker, frames, info)
        attention.force_backend("cuda")
        busy = device_profile(tracker, frames, info)
    finally:
        del os.environ[knob]
        attention.force_backend(None)
    lat = np.asarray(lat)
    emit({"phase": name, "knob": f"{knob}={value}", "mode": mode, "frames": len(lat),
          "launches_per_initialize": init_inst, "launches_over_frames": inst,
          "tracked_fps": len(lat) / float(lat.sum()),
          "latency_ms_p50": float(np.percentile(lat, 50) * 1e3), "ab_per_frame": ab,
          **({"grounding_ab": ground} if ground else {}), "device_profile": busy})
    return {k: init_inst.get(k, 0) + inst.get(k, 0) for k in {*init_inst, *inst}}


def drift_phase(model_fp, cfg_fp, model_q8, cfg_q8, frames, boxes):
    """The int8 tracker against the bf16 one on the kernel backend, each
    frame stepped by both from the bf16 tracker's state (prompt, box, best
    features), which then goes on: per-frame IoU of the two boxes and the
    share of frames whose merged maps peak on the same cell. Reported, not
    gated: with random weights the maps are near-flat and int8 noise may
    move the peak."""
    import numpy as np

    from uvltrack_tpu_torch.ops import attention
    from uvltrack_tpu_torch.track.tracker import Tracker

    cfg_fp.TEST.MODE = cfg_q8.TEST.MODE = "BBOX"
    tf, tq = Tracker(cfg_fp, model_fp), Tracker(cfg_q8, model_q8)
    info = {"init_bbox": boxes[0]}
    attention.force_backend("cuda")
    try:
        tf.initialize(frames[0], info)
        tq.initialize(frames[0], info)
        ious, same = [], 0
        for f in frames[1:]:
            st = tf.state
            a = tf.track_debug(f)
            tq.state = st
            b = tq.track_debug(f)
            ious.append(box_iou(a["target_bbox"], b["target_bbox"]))
            same += int(a["merged_map"].argmax() == b["merged_map"].argmax())
    finally:
        attention.force_backend(None)
    ious = np.asarray(ious)
    emit({"phase": "q8_drift", "frames": len(ious), "same_cell_share": same / len(ious),
          "iou_mean": float(ious.mean()), "iou_min": float(ious.min()),
          "iou_p10": float(np.percentile(ious, 10)),
          "frames_iou_below_0.7": int((ious < 0.7).sum())})


def box_iou(a, b) -> float:
    """IoU of two [x, y, w, h] boxes."""
    iw = max(0.0, min(a[0] + a[2], b[0] + b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[1] + a[3], b[1] + b[3]) - max(a[1], b[1]))
    inter = iw * ih
    return inter / (a[2] * a[3] + b[2] * b[3] - inter)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=64)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "uvltrack_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout holding uvltrack_tpu_torch/", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    # fp32 comparisons must not run convolutions in TF32 (cuDNN's default)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    emit({"phase": "env", "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    from uvltrack_tpu_torch.ops import build

    t0 = time.perf_counter()
    recs = build.build()
    emit({"phase": "build", "seconds_wall": time.perf_counter() - t0,
          "kernels": {n: {"cmd": " ".join(r.cmd), "seconds": r.seconds,
                          "cached": r.cached, "ptxas": r.ptxas}
                      for n, r in recs.items()}})

    worst, times = kernel_phase(dev, args.seed)
    q8_worst, q8_times = q8_kernel_phase(dev, args.seed)
    fused_worst, fused_times = fused_kernel_phase(dev, args.seed)

    from uvltrack_tpu_torch.config import load_cfg
    from uvltrack_tpu_torch.core.tokenizer import BertTokenizer
    from uvltrack_tpu_torch.models.uvltrack import build_model, prepare_inference_model
    from uvltrack_tpu_torch.ops import quant

    def config(weight_quant: str = ""):
        cfg = load_cfg(str(REPO / "experiments/uvltrack/baseline_base.yaml"))
        # random weights score far below a trained model's 0.5 gate; opening it
        # makes the score-gated re-mine run on its schedule (frames 20, 40, 60)
        cfg.TEST.THRESHOLD = -1.0
        cfg.TPU.WEIGHT_QUANT = weight_quant
        return cfg

    cfg = config()
    nt = int(cfg.MODEL.BACKBONE.LANGUAGE.BERT.MAX_QUERY_LEN)
    t0 = time.perf_counter()
    model = prepare_inference_model(cfg, build_model(cfg, device=dev, seed=args.seed))
    emit({"phase": "model", "config": "experiments/uvltrack/baseline_base.yaml",
          "params": sum(p.numel() for p in model.parameters()),
          "build_s": time.perf_counter() - t0, **frame_work(model, nt)})
    frames, boxes = synthetic_sequence(args.frames, args.seed)
    language = "the red checkered box moving left"
    vocab = REPO / "build" / "chip_smoke" / "vocab.txt"
    write_vocab(vocab, language.split(), args.seed)
    # launches per instantiation over every path run (each counted from 0)
    launches = {}

    def add(inst):
        for k, v in inst.items():
            launches[k] = launches.get(k, 0) + v

    per_fwd_fp = {"ln_qkv[bf16x-bf16w]": 6, "ln_qkv[fp32x-bf16w]": 6, "qkv_attention[bf16]": 12}
    for mode in ("BBOX", "NLBBOX", "NL"):
        add(track_phase(mode, model, cfg, frames, boxes, BertTokenizer(str(vocab)), language,
                        expect=per_fwd_fp))
    reference_phase(model, cfg, frames, boxes)
    reference_phase(model, cfg, frames, boxes, label="_grounding",
                    tokenizer=BertTokenizer(str(vocab)), language=language)

    # weight-only int8: the same cells, the same seed
    cfg_q8 = config("int8")
    t0 = time.perf_counter()
    model_q8 = prepare_inference_model(cfg_q8, build_model(cfg_q8, device=dev, seed=args.seed))
    emit({"phase": "model_q8", "config": "experiments/uvltrack/baseline_base.yaml, "
          "TPU.WEIGHT_QUANT=int8", "quantized_tensors": quant.count_quantized(model_q8),
          "bytes_saved_per_bf16_read": quant.quantized_bytes_saved(model_q8),
          "build_s": time.perf_counter() - t0, **frame_work(model_q8, nt)})
    if quant.count_quantized(model_q8) != 56:
        raise AssertionError(f"{quant.count_quantized(model_q8)} tensors quantized, not 56")
    per_fwd_q8 = {"ln_qkv[bf16x-int8w]": 6, "ln_qkv[fp32x-int8w]": 6,
                  "qkv_attention[bf16]": 6, "qkv_attention[fp32]": 6}
    for mode in ("BBOX", "NLBBOX"):
        add(track_phase(mode, model_q8, cfg_q8, frames, boxes, BertTokenizer(str(vocab)),
                        language, expect=per_fwd_q8, label="_q8"))
    fused = frames[:17]
    add(knob_phase("fused_proj_bf16", "UVLTRACK_FUSED_PROJ", "1", model, cfg, fused, boxes,
                   dict(per_fwd_fp, **{"proj_residual[bf16x-bf16a-bf16w]": 6,
                                       "proj_residual[fp32x-bf16a-bf16w]": 6})))
    add(knob_phase("fused_proj_q8", "UVLTRACK_FUSED_PROJ", "1", model_q8, cfg_q8, fused, boxes,
                   dict(per_fwd_q8, **{"proj_residual[bf16x-bf16a-int8w]": 6,
                                       "proj_residual[fp32x-fp32a-int8w]": 6})))
    # LN + qkv plain, the attention alone on kernel #2 (qkv_attention) in
    # every block: the JAX package's "step 3" A/B
    add(knob_phase("fused_prefix_off", "UVLTRACK_FUSED_PREFIX", "0", model, cfg, fused, boxes,
                   {"qkv_attention[bf16]": 12}))
    # kernel #7 in every block of the bf16 model; int8 weights stay plain
    add(knob_phase("fused_mlp_bf16", "UVLTRACK_FUSED_MLP", "1", model, cfg, fused, boxes,
                   dict(per_fwd_fp, **{"ln_mlp[bf16x-bf16w]": 6, "ln_mlp[fp32x-bf16w]": 6})))
    add(knob_phase("fused_mlp_q8", "UVLTRACK_FUSED_MLP", "1", model_q8, cfg_q8, fused, boxes,
                   per_fwd_q8))
    # kernel #3 in BERT's 40-token layers: 6 layers each in the grounding
    # forward, the prompt init and encode_text; the frames run no BERT
    add(knob_phase("bert_kernel", "UVLTRACK_PALLAS_MIN_N", "32", model, cfg, fused, boxes,
                   per_fwd_fp, mode="NL", tokenizer=BertTokenizer(str(vocab)), language=language,
                   expect_init=dict({k: 2 * v for k, v in per_fwd_fp.items()},
                                    **{"attention[bf16]": 18})))
    drift_phase(model, cfg, model_q8, cfg_q8, frames, boxes)
    reference_phase(model_q8, cfg_q8, frames, boxes, label="_q8")

    src = "uvltrack_tpu_torch/csrc"
    n321, n361 = q8_times["N321_bf16x_open"], q8_times["N361_fp32x_flag0"]
    # (name, source, TPU kernel line, launches, worst error, times at the
    # instantiation's main-path shape)
    rows = [
        ("ln_qkv", f"{src}/ln_qkv.cu", 167,
         launches.get("ln_qkv[bf16x-bf16w]", 0) + launches.get("ln_qkv[fp32x-bf16w]", 0),
         worst["ln_qkv"], times["ln_qkv"]),
        ("qkv_attention", f"{src}/qkv_attention.cu", 119,
         launches.get("qkv_attention[bf16]", 0), worst["qkv_attention"], times["qkv_attention"]),
    ]
    for name, line, shape in (("ln_qkv[bf16x-int8w]", 433, n321),
                              ("ln_qkv[fp32x-int8w]", 433, n361),
                              ("qkv_attention[fp32]", 433, n361),
                              ("proj_residual[bf16x-bf16a-bf16w]", 291, n321),
                              ("proj_residual[fp32x-bf16a-bf16w]", 291, n361),
                              ("proj_residual[bf16x-bf16a-int8w]", 489, n321),
                              ("proj_residual[fp32x-fp32a-int8w]", 489, n361)):
        source = f"{src}/{name.split('[')[0]}.cu"
        t = {k: v for k, v in shape[name].items() if k != "library"}
        rows.append((name, source, line, launches.get(name, 0), q8_worst[name], t))
    # kernel #3 at BERT's N=40, kernel #7 at the ViT's two shapes
    for name, line, shape, err in (("attention[bf16]", 78, "N40_bert", "attention"),
                                   ("ln_mlp[bf16x-bf16w]", 551, "N321_bf16x", "ln_mlp"),
                                   ("ln_mlp[fp32x-bf16w]", 551, "N361_fp32x", "ln_mlp")):
        t = {k: v for k, v in fused_times[shape][name].items() if k != "library"}
        rows.append((name, f"{src}/{name.split('[')[0]}.cu", line, launches.get(name, 0),
                     fused_worst[err], t))
    kernels = [{"name": name, "route": "cuda", "source": source,
                "replaces": f"{TPU_KERNEL}:{line}", "launches": n, "max_abs_err": err, **t}
               for name, source, line, n, err, t in rows]
    idle = [k["name"] for k in kernels if k["launches"] == 0]
    if idle:
        raise AssertionError(f"kernels never launched on their paths: {idle}")
    emit({"phase": "composition", "name": "ln_qkv_attention (ln_qkv + qkv_attention)",
          "replaces": f"{TPU_KERNEL}:167", "max_abs_err": worst["ln_qkv_attention"],
          **times["ln_qkv_attention"], "library": "F.layer_norm + F.linear + SDPA"})
    for num, line in (("#5", 433), ("#4", 291), ("#6", 489)):
        for shape in (n321, n361):
            for name, t in shape.items():
                if name.startswith(num):
                    emit({"phase": "composition", "name": name,
                          "replaces": f"{TPU_KERNEL}:{line}", "max_abs_err": q8_worst[name],
                          **t})
    # kernel #7's two launches, each alone, and kernel #3 at N=128
    for shape, name in (("N321_bf16x", "ln_mlp[bf16x-bf16w] ln_fc1_gelu"),
                        ("N321_bf16x", "ln_mlp[bf16x-bf16w] fc2_bias"),
                        ("N361_fp32x", "ln_mlp[fp32x-bf16w] ln_fc1_gelu"),
                        ("N361_fp32x", "ln_mlp[fp32x-bf16w] fc2_bias"),
                        ("N128_bert", "attention[bf16]")):
        emit({"phase": "per_launch", "shape": shape, "name": name,
              "max_abs_err": fused_worst[name.split()[-1] if " " in name else "attention"],
              **fused_times[shape][name]})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
