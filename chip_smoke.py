#!/usr/bin/env python3
"""Drive the PyTorch port (uvltrack_tpu_torch) end to end on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--frames 64]

Phases, one JSON line each:
  1. env      -- card, count, power limit; the nvcc build of every kernel
                 under uvltrack_tpu_torch/csrc (command, seconds, ptxas lines).
  2. kernel   -- each CUDA kernel (and the pair as the fused LN+qkv+attention
                 op) against its plain PyTorch version on the card in bf16 at
                 N in {48, 321, 361, 681} under flag-0 / flag-2 / open key
                 masks; CUDA-event times of kernel, plain version and the
                 PyTorch library yardstick at the main path's two shapes
                 (N=321 with a bf16 stream, N=361 with an fp32 stream).
  3. track    -- UVLTrack-B (experiments/uvltrack/baseline_base.yaml, full
                 width, seeded random weights) tracks a synthetic 720p
                 sequence in BBOX, then NLBBOX mode: FPS at batch 1, p50/p90
                 frame latency, peak memory, launch counts (must be 12 per
                 backbone forward), prompt re-mines; the same sequence on
                 the "plain" backend; the per-frame kernel-vs-plain box
                 difference from a shared state (paired_ab); each layer's
                 time (layer_times) and the card's busy share from
                 torch.profiler (device_profile).
  4. reference -- one step's model outputs on the card against the same
                 weights and inputs on the CPU (cpu_reference).
Then the {"kernels": [...]} line, the nvidia-smi name/power-limit line and,
last, {"ok": true, "device": {...}}. Any failure raises: no ok line, exit 1.
Without a CUDA card, or outside a checkout, it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
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
KERNEL_ATOL = {"ln_qkv": 2e-2, "qkv_attention": 6e-3, "ln_qkv_attention": 6e-3}
KERNEL_RTOL = 2e-2
# kernel-vs-plain tracking A/B (paired_ab): boxes from the same cell within
# 1% of the search crop's side (a few bf16 steps of a crop-normalized box
# coordinate; a sixth of a 1/16 cell); cells that differ only on near-ties
AB_BOX_REL, AB_TIE = 1e-2, 0.05
# card (kernels, bf16) against the same port on the CPU (plain versions, bf16)
REF_ATOL, REF_RTOL = 3e-2, 3e-2


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


def bound(flops: float, nbytes: float):
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
                torch.cuda.synchronize()
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
          "tolerance": {k: f"|kernel-plain| <= {a} + {KERNEL_RTOL}*|plain|"
                        for k, a in KERNEL_ATOL.items()},
          "max_abs_err": worst})

    def timed(n, kind, x_dtype):
        """{name: {ms, plain_ms, library_ms, bound_ms, bound_by}} at one shape.
        library_ms: one PyTorch call computing the same function where there
        is one (SDPA for the attention); for the LN+qkv half there is none,
        and the composition's yardstick is LN + linear + SDPA (three calls)."""
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
        fns = {
            "ln_qkv": (lambda: lqa.ln_qkv(x, g, be, w, wb),
                       lambda: lqa.ln_qkv_plain(x, g, be, w, wb), None),
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
            out[name] = {"ms": cuda_time_ms(kern), "plain_ms": cuda_time_ms(plain),
                         "library_ms": cuda_time_ms(lib) if lib else None,
                         "bound_ms": b_ms, "bound_by": b_by}
        return out

    # the main path's two shapes: blocks 0-5 (visual, N=321, bf16 stream,
    # nothing masked in BBOX mode) and blocks 6-11 (joint, N=361, fp32
    # stream, flag-0 mask on the 40 text keys)
    times = {"N321_bf16x_open": timed(321, "open", torch.bfloat16),
             "N361_fp32x_flag0": timed(361, "flag0", torch.float32)}
    emit({"phase": "kernel_times", "timer": "CUDA events, mean of 200 back-to-back "
          "launches after 20 warm-up (L2-warm)", "times": times})
    return worst, times["N361_fp32x_flag0"]


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
                flops += 2 * cells * m.weight[0].numel() * m.out_channels
    used = [bb.vit.blocks, bb.vit.patch_embed, *towers]
    wbytes = sum(p.numel() * p.element_size() for mod in used for p in mod.parameters())
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


def track_phase(mode: str, model, cfg, frames, boxes, tokenizer, language):
    import numpy as np
    import torch

    from uvltrack_tpu_torch.ops import attention
    from uvltrack_tpu_torch.ops import ln_qkv_attention as lqa
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
    lqa.reset_launch_counts()
    res, lat, init_s, remines = run("cuda")
    counts = lqa.launch_counts()
    forwards = len(frames)  # initialize's backbone pass + one per tracked frame
    peak = torch.cuda.max_memory_allocated()
    _, lat2, _, _ = run("cuda")
    _, plat2, _, _ = run("plain")
    lat, plat = np.concatenate([lat, lat2]), np.concatenate([plat, plat2])
    if lqa.launch_counts() != {k: 2 * v for k, v in counts.items()}:
        raise AssertionError("the plain backend launched a kernel")
    if counts != {"ln_qkv": 12 * forwards, "qkv_attention": 12 * forwards}:
        raise AssertionError(f"launches {counts} != 12 x {forwards} backbone forwards")
    if not np.isfinite(res).all() or res.shape != (len(frames) - 1, 5):
        raise AssertionError("non-finite or misshapen tracker output")
    if remines < len(res) // int(cfg.TEST.UPDATE_INTERVAL):
        raise AssertionError(f"only {remines} prompt re-mines")
    ab = paired_ab(tracker, frames, info)
    attention.force_backend("cuda")
    layers = layer_times(tracker, frames)
    busy = device_profile(tracker, frames, info)
    attention.force_backend(None)
    emit({"phase": f"track_{mode}", "frames": len(res), "frame_hw": list(frames[0].shape[:2]),
          "timer": "host clock per track() call, ending in the box read-back; two runs "
                   "of the sequence per backend, in turns plain/kernel/kernel/plain",
          "tracked_fps": len(lat) / float(lat.sum()),
          "latency_ms_p50": float(np.percentile(lat, 50) * 1e3),
          "latency_ms_p90": float(np.percentile(lat, 90) * 1e3),
          "init_s": init_s, "peak_mem_bytes": int(peak),
          "launches": counts, "backbone_forwards": forwards,
          "remines": remines, "plain_remines": plain_remines,
          "plain_fps": len(plat) / float(plat.sum()),
          "plain_latency_ms_p50": float(np.percentile(plat, 50) * 1e3),
          "plain_latency_ms_p90": float(np.percentile(plat, 90) * 1e3),
          "ab_per_frame": ab,
          "free_running_box_diff_px_max": float(np.abs(res[:, :4] - plain[:, :4]).max()),
          "score_range": [float(res[:, 4].min()), float(res[:, 4].max())],
          "layer_ms": layers, "device_profile": busy})
    return counts


def reference_phase(model, cfg, frames, boxes):
    """One tracking step's model outputs on the card (kernel backend, bf16)
    against the same weights and inputs on the CPU, where every wrapper takes
    its plain version, the path that the CPU tests hold against the JAX
    package. Tolerance: bf16 summation-order noise through 12 blocks and the
    head, |card - cpu| <= REF_ATOL + REF_RTOL*|cpu| (the CPU tests' bf16
    parity bound)."""
    import copy

    import torch

    from uvltrack_tpu_torch.ops import attention
    from uvltrack_tpu_torch.ops import ln_qkv_attention as lqa
    from uvltrack_tpu_torch.track.pipeline import sample_target_device
    from uvltrack_tpu_torch.track.tracker import Tracker

    cfg.TEST.MODE = "BBOX"
    t = Tracker(cfg, model)
    attention.force_backend("cuda")
    t.initialize(frames[0], {"init_bbox": boxes[0]})
    search, _ = sample_target_device(t._frame(frames[1]), t.state.box, t.search_factor,
                                     t.search_size)
    args = (t.template, search, t.txt, t.text_mask, t.state.prompt, t.flag)
    keys = ("cls_score_test", "bbox_map", "cont_score")
    before = lqa.launch_counts()
    with torch.no_grad():
        card = model.forward_test_cached(*args)
        launched = lqa.launch_counts() != before
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cpu = copy.deepcopy(model).cpu().forward_test_cached(*(a.cpu() for a in args))
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

    emit({"phase": "cpu_reference", "what": "forward_test_cached, one BBOX step, full width",
          "max_abs_err": errs, "same_argmax_cell": cell(card) == cell(cpu),
          "tolerance": f"|card-cpu| <= {REF_ATOL} + {REF_RTOL}*|cpu|", "cpu_s": cpu_s})


def layer_times(tracker, frames, iters: int = 30):
    """CUDA-event time of each layer of one tracking step, called back to
    back on the kernel backend at the step's own inputs: crop (search
    crop/resize/normalize), backbone (forward_cached_text: patch embed and
    12 blocks), head (MABH test path), remine (forward_prompt); step is a
    whole Tracker.step (the parts plus decode and state update). Where the
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

    from uvltrack_tpu_torch.config import load_cfg
    from uvltrack_tpu_torch.core.tokenizer import BertTokenizer
    from uvltrack_tpu_torch.models.uvltrack import build_model, prepare_inference_model

    cfg = load_cfg(str(REPO / "experiments/uvltrack/baseline_base.yaml"))
    # random weights score far below a trained model's 0.5 gate; opening it
    # makes the score-gated re-mine run on its schedule (frames 20, 40, 60)
    cfg.TEST.THRESHOLD = -1.0
    t0 = time.perf_counter()
    model = prepare_inference_model(cfg, build_model(cfg, device=dev, seed=args.seed))
    emit({"phase": "model", "config": "experiments/uvltrack/baseline_base.yaml",
          "params": sum(p.numel() for p in model.parameters()),
          "build_s": time.perf_counter() - t0,
          **frame_work(model, int(cfg.MODEL.BACKBONE.LANGUAGE.BERT.MAX_QUERY_LEN))})
    frames, boxes = synthetic_sequence(args.frames, args.seed)
    language = "the red checkered box moving left"
    vocab = REPO / "build" / "chip_smoke" / "vocab.txt"
    write_vocab(vocab, language.split(), args.seed)
    launches = {"ln_qkv": 0, "qkv_attention": 0}
    for mode in ("BBOX", "NLBBOX"):
        counts = track_phase(mode, model, cfg, frames, boxes, BertTokenizer(str(vocab)),
                             language)
        for k in launches:
            launches[k] += counts[k]
    reference_phase(model, cfg, frames, boxes)

    sources = {"ln_qkv": ("uvltrack_tpu_torch/csrc/ln_qkv.cu", f"{TPU_KERNEL}:167"),
               "qkv_attention": ("uvltrack_tpu_torch/csrc/qkv_attention.cu",
                                 f"{TPU_KERNEL}:119")}
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": launches[name], "max_abs_err": worst[name], **times[name]}
               for name, (src, replaces) in sources.items()]
    emit({"phase": "composition", "name": "ln_qkv_attention (ln_qkv + qkv_attention)",
          "replaces": f"{TPU_KERNEL}:167", "max_abs_err": worst["ln_qkv_attention"],
          **times["ln_qkv_attention"], "library": "F.layer_norm + F.linear + SDPA"})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
