#!/usr/bin/env python3
"""Drive the PyTorch port (uvltrack_tpu_torch) end to end on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--frames 64] [--only GROUP,...]

Phases, one JSON line each:
  1. env      -- card, count, power limit; the nvcc build of every kernel
                 under uvltrack_tpu_torch/csrc (command, seconds, ptxas lines).
  2. kernel   -- each CUDA kernel (and the pair as the fused LN+qkv+attention
                 op) against its plain PyTorch version on the card in bf16 at
                 N in {48, 321, 361, 681} under flag-0 / flag-2 / open key
                 masks, and again at batches 4 and 8 (LOCKSTEP_S, the
                 multistream phase's S, a key mask a row) at the main path's
                 two shapes (every phase 2 check below is repeated there, and
                 every time at batch 8; #3 at N=40), qkv_attention called
                 twice (bitwise equal: the keys'
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
                 sequence in BBOX (64 frames), NLBBOX, then NL mode (32
                 frames each; initialized from
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
                 with TPU.WEIGHT_QUANT=int8 (B-BBOX-Q8, B-NLBBOX-Q8; 32
                 frames), the
                 launches counted per instantiation.
     fused_prefix_off -- UVLTRACK_FUSED_PREFIX=0, BBOX, 8 frames: LN + qkv
                 plain and 12 qkv_attention launches per forward, no ln_qkv.
     fused_proj, fused_mlp -- UVLTRACK_FUSED_PROJ=1 / UVLTRACK_FUSED_MLP=1
                 on the bf16 and the int8 model, BBOX, 8 frames: 12
                 proj_residual / ln_mlp launches per forward (none of
                 ln_mlp with int8 weights), kernel vs plain through
                 paired_ab.
     bert_kernel -- UVLTRACK_PALLAS_MIN_N=32, NL mode: 18 attention launches
                 per initialize (6 BERT layers in the grounding forward, the
                 prompt init and encode_text), none per frame; the
                 grounding box and paired_ab kernel vs plain.
     multistream -- BatchTracker at S = 1, 4 (BBOX and NLBBOX streams, one
                 8 frames shorter, frozen) and 8 (the mix and an NL stream),
                 32 steps, and S=4 with int8 weights, 16 steps; the batched
                 eval runner over the S=4 streams (frames handed over in
                 memory); a StreamPool of 4 slots (opens at rounds 0, 3, 7,
                 a close and a reuse at 12, a stream frozen for 2 rounds),
                 24 rounds. Checked: launches per batched forward and per
                 initialize equal the single-stream counts, re-mines every
                 20 frames; every step from a shared state, each row of the
                 kernel step against the plain step and against a single
                 Tracker stepped from that row (paired_ab's rule); NL
                 streams' grounding against a single Tracker's. Reported:
                 stream-frames/s, step p50/p90, peak memory, and device time,
                 device ops and busy share per step (profile_window).
     q8_drift -- the int8 tracker against the bf16 one, each frame stepped
                 from the bf16 tracker's state: per-frame IoU and the share
                 of frames on the same cell (reported, not gated: the
                 weights are random).
  4. reference -- one step's model outputs on the card against the same
                 weights and inputs on the CPU (cpu_reference), for the bf16
                 and the int8 model, and the grounding forward's (bf16).
  Phases 3 and 4 run the eager step (graphs=False: launches counted per
  forward, per-layer CUDA events); the compiled step follows:
  5. compiled -- CUDA graphs of the step and the re-mine through a shared
                 JitTracker against the eager step, in turns (eager, graph,
                 graph, eager) in B-BBOX, B-NLBBOX, B-NL (64 frames),
                 B-BBOX-Q8, lockstep S4 and S8 (the multistream sequences)
                 and the S=4 pool: FPS / stream-frames/s, step p50/p90, a
                 profiler window each (device ms, ops, busy share), peak
                 memory with the graph pool, capture seconds, track_many at
                 chunk 32 (B-BBOX's chunk of 16 profiled). Gated: every
                 frame (row) from a shared state, the
                 graph step's box and maps against the eager debug step's
                 (paired_ab's rule; the bitwise-equal count reported);
                 re-mines at frames 20/40/60 on both; the launches each
                 graph recorded at capture equal the eager forward's (12 +
                 12, 6+6 per dtype with int8; none in the re-mine); a second
                 Tracker on the JitTracker captures nothing and tracks as a
                 fresh one; UVLTRACK_FUSED_PREFIX=0 set after the capture gets
                 its own graph (12 qkv_attention, no ln_qkv).
  6. serve    -- cli/serve.py's make_server in this process on 127.0.0.1
                 over the compiled step: per-stream (a BBOX and an NLBBOX
                 stream, 32 720p npy frames each, two client threads) and
                 --lockstep 4 (four streams, 24 rounds, one closed and
                 reopened); served boxes equal a direct Tracker / StreamPool
                 on the same JitTracker bit for bit; the --max_streams 429
                 and /close; request p50/p90 and served frames/s.
  7. eval     -- kernels #1, #2 and #5 at UVLTrack-L's width (C=1024, H=16;
                 N=321 bf16 x and N=361 fp32 x at B=1 and 8, 3 masks)
                 against their plain versions, with times (kernel_check_L,
                 q8_kernel_check_L, *_times_L); then the evaluation path:
                 a synthetic OTB99-layout dataset of 8 ragged 720p JPEG
                 sequences (32-48 frames, a sentence each) and a GOT-10k test
                 split (one-row ground truth) in a temporary directory, and
                 uvltrack_tpu_torch.cli.test.main in five runs: B BBOX
                 --chunk 16; B NLBBOX --streams 4; B BBOX --quant int8; L
                 (baseline_large) BBOX; L NLBBOX --streams 8. Each run's
                 result files equal, byte for byte, a direct Tracker /
                 BatchTracker run on the CLI's JitTracker from the same
                 decoded frames; its kernels launched (counts from 0 just
                 before the run); runner FPS, decode ms a frame, step
                 p50/p90 of the direct replay, peak memory, capture seconds.
                 L: 24 + 24 launches a forward (eager and in the graph),
                 kernel vs plain frame by frame (paired_ab), graph vs eager
                 debug step bitwise at B=1 and S=8, a profiler window each,
                 frame_cost. Then cli.analyze (--per_seq --save_file, and
                 the scores) on runs a and d, the server-split message on
                 the GOT-10k split and cli.pack's zip, a file a sequence.
  8. train    -- (a) the four autograd Functions of ops/autograd.py
                 (kernels #1, #2, #4, #7 under autograd) at B=16, C=768,
                 H=12, N=321 bf16 x and N=361 fp32 x, 3 masks: the kernel
                 forward against the plain version (the KERNEL_* rule) and
                 every input's gradient against the plain recompute's (the
                 bitwise count reported). (b) B-TRAIN: UVLTrack-B at full
                 width, batch 8 x 2 search frames, seed-0 init and one
                 synthetic batch, 6 steps on the kernels and 6 on the plain
                 backend in turns: step 1 gated (loss within 1%, grad_norm
                 within TRAIN_NORM_REL or twice the plain backend's move under
                 a 2^-12 input change), losses, step p50, samples/s, peak
                 memory, launches a step (12 + 12, none in the backward), a
                 profiler window of 2 steps. (c) 2 steps each under
                 UVLTRACK_FUSED_PROJ=1, UVLTRACK_FUSED_MLP=1 and
                 UVLTRACK_FUSED_PREFIX=0 (#4, #7, #2 inside the model). (d)
                 TPU.REMAT's gradients bitwise the plain step's from one
                 state; 2 REMAT and 2 TPU.GRAD_ACCUM=2 steps (24 + 24
                 launches a step), peak memory. (e) cli.train.main
                 --synthetic 3 --epochs 2 in a temporary directory, then a
                 resume to epoch 3. ~50 s.
  9. data     -- training on datasets on disk (B-TRAIN-REAL). (a) The
                 config's seven training and four validation datasets as
                 fixture trees from --seed (uvltrack_tpu_torch/tools/
                 data_fixtures.py: 1280x720 JPEG frames, 640x480 COCO and
                 RefCOCOg images) and a GOT-10k LMDB pack written by the
                 port's write_lmdb, read back against the folder and
                 pre-warmed by cli.prewarm. (b) The loader alone
                 (build_train_loader, TRAIN.NUM_WORKER=10), 2 epochs of 8
                 batches in thread and in process mode: samples/s, the task
                 mix against 0.45 / 0.11 / 0.44, os.cpu_count(). (c)
                 cli.train.main --config baseline_base with only the
                 SAMPLE_PER_EPOCH keys cut (8 steps an epoch, 2 batches of
                 VALTRACK and VALVL, VAL's every sequence) and the script's
                 vocab: epochs 1-2, then a resume to 3 under thread and one
                 to 4 under process workers, each of 32 steps so that the
                 loader still draws batches through all but the epoch's
                 last prefetch + 2 steps (a real epoch's steady state),
                 synthetic B-TRAIN steps on the same trainer after each run
                 (in turns): step p50 and the loader wait a step over the
                 loader-active steps and over the tail apart, samples/s,
                 the train loop's rows/s an epoch, peak memory, 12 + 12
                 launches every step, a profiler window of 2 loader-active
                 steps in each long epoch and of 2 synthetic steps (busy
                 share, device ops), validation on all three families
                 every epoch. (d) Step 1 on one real batch from one init,
                 kernels against plain, B-TRAIN's gate.
  10. cli     -- the tool CLIs. (a) the fp32-weight instantiations
                 (TPU.COMPUTE_DTYPE=float32: fp32 weights as their hi/lo bf16
                 planes, three bf16 passes a product): ln_qkv[fp32x-fp32w] and
                 the fp32 attention after it, proj_residual[fp32x-fp32a-fp32w]
                 alone and as kernel #4, ln_mlp[fp32x-fp32w] (the pair and each
                 launch), split_hilo (bitwise its plain version), against their
                 plain versions at B in {1, 8}, N in {321, 361}, C in {768,
                 1024}, 3 masks, two calls bitwise equal; times beside their
                 fp32 library calls and bounds (ln_qkv at both N, the rest at
                 N=361). (b) cli.profile.main on UVLTrack-B: forward on the kernels
                 (a torch.profiler trace read back: the GEMM core's launches in it)
                 and with --xla (the counted FLOPs and bytes equal), forward with
                 --quant int8, the step on both backends, and UVLTrack-L's step; the
                 printed p50/FPS parsed, the launches per forward checked. (c)
                 cli.export.main --check at fp32 compute, plain and under
                 UVLTRACK_FUSED_PROJ=1 and UVLTRACK_FUSED_MLP=1: 12 ln_qkv + 12
                 qkv_attention (+ 12 proj_residual or 12 ln_mlp) ops in the
                 exported graph, the loaded program within 1e-5 of the direct
                 call, those launches a forward and one split_hilo a weight a
                 model. (d) cli.parity.main on a .pth.tar of the seeded model, on
                 the kernels and on the plain backend, fp32 (plain and under each
                 knob) and --quant int8: the dumps key by key within 2e-4 +
                 2e-4*|plain|. (e) cli.demo.main on a
                 48-frame 1280x720 MJPG video: 48 frames out, every box bitwise a
                 direct Tracker's over the same decoded frames. (f) cli.test.main on
                 a trainer checkpoint (ep0001.pt, train/checkpoint.py) over one
                 24-frame OTB99 sequence: its result file byte for byte a direct
                 replay, the tracker's weights the checkpoint's.
  11. parallel -- (a) dp=2 on one card: two processes on cuda:0 over gloo
                 (named in the phase: NCCL refuses two ranks on one GPU), each
                 stepping its half of B-TRAIN's global batch (8 samples x 2
                 search frames; seed 0) with the gradient all_reduce, ZeRO-1 off
                 and on, and 16 samples x 1 search frame (the half-batch
                 rotation exchanged across the ranks), 3 steps each, against the
                 dp=1 step on the same 16 rows in turns (dp=1, dp=2, dp=1): step
                 1 under B-TRAIN's gate, ZeRO-1's parameters against the
                 replicated update of the same gradients (rtol 1e-3 / atol
                 1e-4), each rank's Adam moment bytes, step ms, 12 + 12 launches
                 a step on each rank. (b) cli.train.main --multihost at world
                 size 1 on NCCL (torchrun's environment set for this process):
                 2 synthetic steps and a checkpoint. (c) The stream mesh: two
                 replicas on cuda:0 (make_mesh(devices=[cuda:0, cuda:0]))
                 against the unsharded BatchTracker at S=8 and S=5 (S_pad 6):
                 16 steps from a shared state on the eager debug step
                 (paired_ab's rule, the bitwise rows counted, one forward's
                 launches per replica a step), then 24 steps on the CUDA graphs
                 in turns (step ms, stream-frames/s, busy share; each replica's
                 step graph holds one forward's launches). (d) cli.test.main
                 --multichip --streams 4 over 4 ragged 720p sequences: the
                 result files of --streams 4 without it, byte for byte; the
                 --multichip --lockstep 4 server (make_server on the CLI's mesh)
                 against a direct StreamPool, 12 rounds, bit for bit. On one
                 card the CLIs' mesh of the visible cards has one replica.
--only runs some groups (kernels = phase 2, track = 3-4 but the
multistream ones, multistream, compiled, serve, eval, train, data, cli, parallel) and prints no kernels
line; in a full run the kernels line counts the eval runs' launches, and
the rows of the instantiations on L's path carry their L times ("C1024").
Then the script's total seconds, the {"kernels": [...]} line (each
kernel's times at B=1 and, under "B8", at the lockstep batch; "launches"
counted by the wrappers on the eager paths, "graph_launches" the graphs'
captured calls times their replays, "train_launches" the train group's
B-TRAIN runs (b)-(e), the data group's (c)-(d) and the parallel group's
(a)-(b), both dp=2 ranks included; the fp32-weight rows'
launches come from the cli group's export and parity runs), the
nvidia-smi name/power-limit line and,
last, {"ok": true, "device": {...}}. Any failure raises: no ok line, exit 1.
Without a CUDA card, or outside a checkout, it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
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
# launches per UVLTrack-B backbone forward: bf16 weights (blocks 0-5 on the
# bf16 stream, 6-11 on the fp32 one), int8 weights
PER_FWD_FP = {"ln_qkv[bf16x-bf16w]": 6, "ln_qkv[fp32x-bf16w]": 6, "qkv_attention[bf16]": 12}
PER_FWD_Q8 = {"ln_qkv[bf16x-int8w]": 6, "ln_qkv[fp32x-int8w]": 6, "qkv_attention[bf16]": 6,
              "qkv_attention[fp32]": 6}


MLP_N = (48, 321, 361, 681)  # kernel #7's check shapes
COMPILED_FRAMES = 32  # frames a compiled single-stream cell tracks (a re-mine at 20)
# the instantiations the kernels line's two bf16 rows count
NAMED_BY_BASE = {"ln_qkv": ("ln_qkv[bf16x-bf16w]", "ln_qkv[fp32x-bf16w]"),
                 "qkv_attention": ("qkv_attention[bf16]",)}
GROUPS = ("kernels", "track", "multistream", "compiled", "serve", "eval", "train", "data", "cli",
          "parallel")
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


def key_masks(b: int, n: int, kind: str, rng):
    """(B, N) masks, one key_mask a row (flag2 draws each row's padding)."""
    import numpy as np

    return np.concatenate([key_mask(n, kind, rng) for _ in range(b)])


# the batches of the kernel checks at B > 1: every S > 1 of the multistream
# phase (its S4, S4_q8 and pool cells run at 4, S8 at 8); the timings at B > 1
# are taken at the largest
LOCKSTEP_S = (4, 8)
LOCKSTEP_B = max(LOCKSTEP_S)
GRID_DOC = (f"B=1: N in {{48, 321, 361, 681}} x 3 masks x {{bf16, fp32}} x; B in {LOCKSTEP_S}: "
            "the main path's shapes, N=321 bf16 x and N=361 fp32 x, x 3 masks, a mask a row")


# UVLTrack-L's shapes (experiments/uvltrack/baseline_large.yaml: C=1024, 16
# heads): the main path's two at B=1 and at the batch of L's lockstep run
L_WIDTH, L_HEADS, L_STREAMS = 1024, 16, 8
L_GRID_DOC = (f"C={L_WIDTH} H={L_HEADS}: B in {{1, {L_STREAMS}}} x (N=321 bf16 x, N=361 fp32 x) "
              "x 3 masks, a mask a row")


def l_grid():
    import torch

    return [(b, n, kind, dt) for b in (1, L_STREAMS)
            for n, dt in ((321, torch.bfloat16), (361, torch.float32))
            for kind in ("flag0", "flag2", "open")]


def check_grid():
    """(B, N, mask, x dtype) of every kernel check: the B=1 grid, then the
    main path's two shapes at each lockstep batch."""
    import torch

    masks, dtypes = ("flag0", "flag2", "open"), (torch.bfloat16, torch.float32)
    grid = [(1, n, kind, dt) for n in (48, 321, 361, 681) for kind in masks for dt in dtypes]
    return grid + [(b, n, kind, dt) for b in LOCKSTEP_S
                   for n, dt in ((321, dtypes[0]), (361, dtypes[1])) for kind in masks]


def kernel_phase(dev, seed: int, c: int = 768, heads: int = 12, grid=None, tag: str = ""):
    """Kernels #1/#2 (ln_qkv, qkv_attention and the pair) against their
    plain versions over `grid` (check_grid() by default) at width c with
    `heads` heads, then times at the main path's two shapes, B=1 and
    LOCKSTEP_B. `tag` suffixes the phase names (UVLTrack-L's width: "_L")."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from uvltrack_tpu_torch.ops import ln_qkv_attention as lqa

    rng = np.random.default_rng(seed)

    def case(n, kind, x_dtype, b=1):
        x = torch.from_numpy(rng.normal(size=(b, n, c)).astype(np.float32)).to(dev, x_dtype)
        g = torch.from_numpy((1 + 0.1 * rng.normal(size=c)).astype(np.float32)).to(dev)
        be = torch.from_numpy((0.1 * rng.normal(size=c)).astype(np.float32)).to(dev)
        w = torch.from_numpy((rng.normal(size=(3 * c, c)) / np.sqrt(c)).astype(np.float32))
        w = w.to(dev, torch.bfloat16)
        wb = torch.from_numpy((0.02 * rng.normal(size=3 * c)).astype(np.float32)).to(dev)
        kb = torch.from_numpy(np.where(key_masks(b, n, kind, rng), -1e10, 0.0)
                              .astype(np.float32)).to(dev)
        return x, g, be, w, wb, kb

    def err(name, a, b):
        a, b = a.float(), b.float()
        ok = bool(((a - b).abs() <= KERNEL_ATOL[name] + KERNEL_RTOL * b.abs()).all())
        return float((a - b).abs().max()), ok

    worst = {"ln_qkv": 0.0, "qkv_attention": 0.0, "ln_qkv_attention": 0.0}
    for b, n, kind, x_dtype in grid or check_grid():
        x, g, be, w, wb, kb = case(n, kind, x_dtype, b)
        qkv = lqa.ln_qkv(x, g, be, w, wb)
        out = lqa.qkv_attention(qkv, kb, heads)
        again = lqa.qkv_attention(qkv, kb, heads)
        torch.cuda.synchronize()
        # the keys' cluster split summed in rank order: the same bits
        if not torch.equal(out, again):
            raise AssertionError(f"qkv_attention B={b} N={n} mask={kind}: a second call "
                                 "differs (not bitwise repeatable)")
        checks = {
            "ln_qkv": err("ln_qkv", qkv, lqa.ln_qkv_plain(x, g, be, w, wb)),
            "qkv_attention": err("qkv_attention", out, lqa.qkv_attention_plain(qkv, kb, heads)),
            "ln_qkv_attention": err("ln_qkv_attention", out, lqa.ln_qkv_attention_plain(
                x, g, be, w, wb, kb, heads)),
        }
        for name, (e, ok) in checks.items():
            if not ok:
                raise AssertionError(f"{name} B={b} N={n} mask={kind} x={x_dtype}: "
                                     f"max abs err {e} over tolerance")
            worst[name] = max(worst[name], e)
    emit({"phase": f"kernel_check{tag}", "C": c, "heads": heads,
          "grid": GRID_DOC if grid is None else L_GRID_DOC,
          "qkv_attention_repeatable": "bitwise, two calls at every check",
          "tolerance": {k: f"|kernel-plain| <= {a} + {KERNEL_RTOL}*|plain|"
                        for k, a in KERNEL_ATOL.items()},
          "max_abs_err": worst})

    def timed(n, kind, x_dtype, b=1):
        """{name: {ms, plain_ms, library_ms, bound_ms, bound_by}} at one shape.
        library_ms: one PyTorch call computing the same function where there
        is one (SDPA for the attention); for the LN+qkv half there is none,
        and its yardstick is F.layer_norm + F.linear (two calls), the
        composition's LN + linear + SDPA (three calls)."""
        x, g, be, w, wb, kb = case(n, kind, x_dtype, b)
        qkv = lqa.ln_qkv(x, g, be, w, wb)
        mask = kb.to(torch.bfloat16)[:, None, None, :]
        wb16 = wb.to(torch.bfloat16)

        def sdpa(t):
            q, k, v = t.view(b, n, 3, heads, 64).permute(2, 0, 3, 1, 4).unbind(0)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

        def library_fused():
            y = F.layer_norm(x.float(), (c,), g, be, 1e-6).to(torch.bfloat16)
            return sdpa(F.linear(y, w, wb16))

        f, xb, m = 3 * c, x.element_size(), b * n
        params = f * c * 2 + f * 4 + 2 * c * 4  # W bf16, qkv bias, LN scale/bias
        work = {  # (operations, bytes): each input read once, each output written once
            "ln_qkv": (2 * m * c * f, m * c * xb + params + m * f * 2),
            "qkv_attention": (4 * heads * b * n * n * 64, m * f * 2 + m * 4 + m * c * 2),
            "ln_qkv_attention": (2 * m * c * f + 4 * heads * b * n * n * 64,
                                 m * c * xb + params + m * 4 + m * c * 2),
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
    times = {f"{prefix}N321_bf16x_open": timed(321, "open", torch.bfloat16, b)
             for b, prefix in ((1, ""), (LOCKSTEP_B, f"B{LOCKSTEP_B}_"))}
    times.update({f"{prefix}N361_fp32x_flag0": timed(361, "flag0", torch.float32, b)
                  for b, prefix in ((1, ""), (LOCKSTEP_B, f"B{LOCKSTEP_B}_"))})
    emit({"phase": f"kernel_times{tag}", "C": c, "heads": heads, "timer": TIMER,
          "times": times})
    return worst, times


def q8_kernel_phase(dev, seed: int, c: int = 768, heads: int = 12, grid=None, tag: str = "",
                    names=None):
    """Every int8 and fused-projection instantiation against its plain
    version on the card, over the grid of kernel_phase, then CUDA-event
    times at the main path's two shapes. Returns ({name: worst error},
    {shape: {name: times}}). c, heads, grid and tag as kernel_phase's;
    `names`, prefixes of the instantiations to check (all by default)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from uvltrack_tpu_torch.ops import ln_qkv_attention as lqa
    from uvltrack_tpu_torch.ops import ln_qkv_attn_proj as lqp
    from uvltrack_tpu_torch.ops import quant

    f = 3 * c
    rng = np.random.default_rng(seed + 1)

    def case(n, kind, x_dtype, b=1):
        def arr(a):
            return torch.from_numpy(a.astype(np.float32)).to(dev)

        x = arr(rng.normal(size=(b, n, c))).to(x_dtype)
        g, be = arr(1 + 0.1 * rng.normal(size=c)), arr(0.1 * rng.normal(size=c))
        w = arr(rng.normal(size=(f, c)) / np.sqrt(c)).to(torch.bfloat16)
        wp = arr(rng.normal(size=(c, c)) / np.sqrt(c)).to(torch.bfloat16)
        wb, bp = arr(0.02 * rng.normal(size=f)), arr(0.02 * rng.normal(size=c))
        kb = arr(np.where(key_masks(b, n, kind, rng), -1e10, 0.0))
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
        return {k: v for k, v in out.items() if names is None or k.startswith(names)}

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
        if names is not None and not "proj_residual".startswith(names):
            return {}
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
    for b, n, kind, x_dtype in grid or check_grid():
        args = case(n, kind, x_dtype, b)
        for name, (kern, plain, tol_key) in {**checks(*args), **proj_only(*args)}.items():
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            if got.dtype != want.dtype or got.shape != want.shape:
                raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} vs plain "
                                     f"{want.dtype}{tuple(want.shape)}")
            e, ok = err(tol_key, got, want)
            if not ok:
                raise AssertionError(f"{name} B={b} N={n} mask={kind}: max abs err {e} "
                                     "over tolerance")
            worst[name] = max(worst.get(name, 0.0), e)
            # split-K (split keys) summed in rank order: a second call gives
            # the same bits
            if name.startswith(("proj_residual", "qkv_attention")) and \
                    not torch.equal(got, kern()):
                raise AssertionError(f"{name} B={b} N={n} mask={kind}: a second call "
                                     "differs (not bitwise repeatable)")
            if name.endswith("proj only"):
                proj_abs_max = max(proj_abs_max, float(want.float().abs().max()))
    emit({"phase": f"q8_kernel_check{tag}", "C": c, "heads": heads,
          "grid": GRID_DOC if grid is None else L_GRID_DOC,
          "proj_only_abs_max": proj_abs_max,
          "proj_residual_repeatable": "bitwise, two calls of every proj_residual check",
          "qkv_attention_fp32_repeatable": "bitwise, two calls of every qkv_attention[fp32] check",
          "tolerance": {"bf16 compute": {k: f"|kernel-plain| <= {a} + {KERNEL_RTOL}*|plain|"
                                         for k, a in Q8_KERNEL_ATOL.items()},
                        "fp32 compute": f"|kernel-plain| <= {F32_ATOL} + {F32_RTOL}*|plain|"},
          "max_abs_err": worst})

    def work(name, n, xb, b=1):
        """(bf16-pass operations, bytes): each input read once, each output
        written once; fp32-accurate products counted in bf16 passes (bound).
        The weights are read once for the B*N rows."""
        f32, m = xb == 4, b * n
        ln_params = 2 * c * 4 + f * 4  # LN scale/bias, qkv bias
        pre = (2 * m * c * f * (2 if f32 else 1),
               m * c * xb + f * c + f * 4 + ln_params)  # + int8 W and its scale
        att = (4 * heads * b * n * n * 64 * (3 if f32 else 1), m * 4)  # + key bias
        prj_q8 = (2 * m * c * c * (2 if f32 else 1), c * c + c * 4 + c * 4)
        prj16 = (2 * m * c * c, c * c * 2 + c * 4)
        if name.startswith("ln_qkv["):
            return pre[0], pre[1] + m * f * xb
        if name == "qkv_attention[fp32]":
            return att[0], m * f * 4 + att[1] + m * c * 4
        if name.startswith("proj_residual") and name.endswith("int8w]"):
            return prj_q8[0], prj_q8[1] + 3 * m * c * xb  # x, A in x's dtype, out
        if name.startswith("proj_residual"):
            return prj16[0], prj16[1] + 2 * m * c * xb + m * c * 2  # x, out; bf16 A
        if name.startswith("#5"):
            return pre[0] + att[0], pre[1] + att[1] + m * c * xb
        if name.startswith("#6"):
            return pre[0] + att[0] + prj_q8[0], pre[1] + att[1] + prj_q8[1] + m * c * xb
        # #4: bf16 weights, bf16 compute
        return (2 * m * c * f + 4 * heads * b * n * n * 64 + 2 * m * c * c,
                m * c * xb + f * c * 2 + ln_params + m * 4 + prj16[1] + m * c * xb)

    def library(name, x, g, be, w, wb, wp, bp, kb, wq, wpq):
        """One PyTorch call computing the same function where there is one
        (SDPA for the fp32 attention); else the nearest composition of
        library calls, named in `library` (dense weights dequantized before
        the timing)."""
        b, n = x.shape[0], x.shape[1]
        mask = kb.to(x.dtype)[:, None, None, :]
        wpd = wpq.materialize(x.dtype)

        def sdpa(t):
            q, k, v = t.view(b, n, 3, heads, 64).permute(2, 0, 3, 1, 4).unbind(0)
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
                                                 .transpose(1, 2).reshape(b, n, c), wpd,
                                                 bp.to(x.dtype))), \
                "LN + linear + SDPA + linear + add, 5 calls"
        if name.startswith("#4"):
            b16 = torch.bfloat16
            return lambda: torch.add(x, F.linear(sdpa(F.linear(ln(b16), w, wb.to(b16)))
                                                 .transpose(1, 2).reshape(b, n, c), wp,
                                                 bp.to(b16))), \
                "LN + linear + SDPA + linear + add, 5 calls"
        return None, "none (no one call)"

    def timed(n, kind, x_dtype, b=1):
        args = case(n, kind, x_dtype, b)
        xb = args[0].element_size()
        out = {}
        for name, (kern, plain, _) in checks(*args).items():
            lib, lib_what = library(name, *args)
            b_ms, b_by = bound(*work(name, n, xb, b))
            out[name] = {**timings(kern, plain, lib), "library": lib_what,
                         "bound_ms": b_ms, "bound_by": b_by}
        return out

    times = {}
    for b, prefix in ((1, ""), (LOCKSTEP_B, f"B{LOCKSTEP_B}_")):
        times[f"{prefix}N321_bf16x_open"] = timed(321, "open", torch.bfloat16, b)
        times[f"{prefix}N361_fp32x_flag0"] = timed(361, "flag0", torch.float32, b)
    emit({"phase": f"q8_kernel_times{tag}", "C": c, "heads": heads, "timer": TIMER,
          "times": times})
    return worst, times


def fused_kernel_phase(dev, seed: int):
    """Kernel #3 (`attention`, BERT's layout: three (B, N, 768) products
    viewed as (B, 12, N, 64)) and kernel #7 (`ln_mlp`, ViT-B's MLP, C=768,
    F=3072: the pair and each launch alone) against their plain versions on
    the card, at B=1 and at the lockstep batch, then CUDA-event times: #3 at
    N=40 (BERT's length) and N=128, #7 at the main path's two shapes, each
    at B=1 and #3 at N=40 and #7 at the lockstep batch too. Returns ({name:
    worst error}, {shape: {name: times}})."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from uvltrack_tpu_torch.ops import fused_attention as fa
    from uvltrack_tpu_torch.ops import ln_mlp as lm

    c, heads, f = 768, 12, 3072
    rng = np.random.default_rng(seed + 2)

    def arr(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    def attn_case(n, kind, b=1):
        """bert: trailing text padding at -10000; all: every key at -10000
        (BBOX mode's empty text); open: nothing; flag0: the ViT's -1e10 on
        the trailing 40 keys."""
        q, k, v = (arr(rng.normal(size=(b, n, c))).to(torch.bfloat16)
                   .view(b, n, heads, 64).transpose(1, 2) for _ in range(3))
        kb = np.zeros((b, n), np.float32)
        if kind == "bert":
            for row in kb:
                row[int(rng.integers(5, n)):] = -10000.0
        elif kind == "all":
            kb[:] = -10000.0
        elif kind == "flag0":
            kb = np.where(key_masks(b, n, "flag0", rng), -1e10, 0.0)
        return q, k, v, arr(kb)

    def mlp_case(n, x_dtype, b=1):
        x = arr(rng.normal(size=(b, n, c))).to(x_dtype)
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

    attn_grid = [(1, n) for n in ATTN_N] + [(b, 40) for b in LOCKSTEP_S]
    for b, n in attn_grid:
        for kind in ("bert", "all", "open", "flag0"):
            q, k, v, kb = attn_case(n, kind, b)
            out = fa.fused_attention(q, k, v, kb)
            again = fa.fused_attention(q, k, v, kb)
            torch.cuda.synchronize()
            what = f"B={b} N={n} mask={kind}"
            check("attention", out, fa.fused_attention_plain(q, k, v, kb), what)
            if not torch.equal(out, again):
                raise AssertionError(f"attention {what}: a second call differs")
    mlp_grid = [(1, n, dt) for n in MLP_N for dt in (torch.bfloat16, torch.float32)]
    mlp_grid += [(b, n, dt) for b in LOCKSTEP_S
                 for n, dt in ((321, torch.bfloat16), (361, torch.float32))]
    for b, n, x_dtype in mlp_grid:
        x, g, be, w1, b1, w2, b2 = mlp_case(n, x_dtype, b)
        hidden = torch.empty((b * n, f), dtype=torch.bfloat16, device=dev)
        out = torch.empty((b, n, c), dtype=torch.bfloat16, device=dev)
        lm.launch_ln_mlp(x, g, be, w1, b1, w2, b2, hidden, out)
        again = torch.empty_like(out)
        lm.launch_ln_mlp(x, g, be, w1, b1, w2, b2, hidden, again, stages="fc2_bias")
        torch.cuda.synchronize()
        what = f"B={b} N={n} x={x_dtype}"
        check("ln_fc1_gelu", hidden.view(b, n, f),
              lm.ln_fc1_gelu_plain(x, g, be, w1, b1).to(torch.bfloat16), what)
        check("fc2_bias", out, lm.fc2_bias_plain(hidden.view(b, n, f), w2, b2), what)
        check("ln_mlp", out, lm.ln_mlp_plain(x, g, be, w1, b1, w2, b2), what)
        # split-K over a cluster, reduced in rank order: bit for bit again
        if not torch.equal(out, again):
            raise AssertionError(f"fc2_bias {what}: a second call differs "
                                 f"(max {float((out.float() - again.float()).abs().max())})")
    emit({"phase": "fused_kernel_check", "attention_B_N": attn_grid,
          "attention_masks": ["bert", "all", "open", "flag0"],
          "ln_mlp_B_N_x": [[b, n, str(dt)] for b, n, dt in mlp_grid],
          "fc2_bias_repeatable": "bitwise, two calls at every ln_mlp shape",
          "attention_repeatable": "bitwise, two calls at every attention check",
          "tolerance": {k: f"|kernel-plain| <= {KERNEL_ATOL[k]} + {KERNEL_RTOL}*|plain|"
                        for k in worst},
          "max_abs_err": worst})

    def row(kern, plain, lib, lib_what, work):
        b_ms, b_by = bound(*work)
        return {**timings(kern, plain, lib), "library": lib_what,
                "bound_ms": b_ms, "bound_by": b_by}

    def attn_times(n, b=1):
        q, k, v, kb = attn_case(n, "bert", b)
        mask = kb.to(torch.bfloat16)[:, None, None, :]
        work = (4 * heads * b * n * n * 64, 3 * b * n * c * 2 + b * n * 4 + b * n * c * 2)
        return {"attention[bf16]": row(
            lambda: fa.fused_attention(q, k, v, kb), lambda: fa.fused_attention_plain(q, k, v, kb),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), "SDPA", work)}

    def mlp_times(n, x_dtype, b=1):
        x, g, be, w1, b1, w2, b2 = mlp_case(n, x_dtype, b)
        tag = f"ln_mlp[{'fp32' if x_dtype == torch.float32 else 'bf16'}x-bf16w]"
        m = b * n
        hidden = torch.empty((m, f), dtype=torch.bfloat16, device=dev)
        out = torch.empty((b, n, c), dtype=torch.bfloat16, device=dev)
        h3 = hidden.view(b, n, f)
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
                     (4 * m * c * f, m * c * xb + 2 * c * f * 2 + vecs + m * c * 2)),
            f"{tag} ln_fc1_gelu": row(
                launch("ln_fc1_gelu"), lambda: lm.ln_fc1_gelu_plain(x, g, be, w1, b1).to(b16),
                fc1_lib, "F.layer_norm + F.linear + F.gelu, 3 calls",
                (2 * m * c * f, m * c * xb + c * f * 2 + (f + 2 * c) * 4 + m * f * 2)),
            f"{tag} fc2_bias": row(
                launch("fc2_bias"), lambda: lm.fc2_bias_plain(h3, w2, b2),
                lambda: F.linear(h3, w2, b2.to(b16)), "F.linear",
                (2 * m * f * c, m * f * 2 + c * f * 2 + c * 4 + m * c * 2)),
        }

    lb = f"B{LOCKSTEP_B}_"
    times = {"N40_bert": attn_times(40), "N128_bert": attn_times(128),
             "N321_bf16x": mlp_times(321, torch.bfloat16),
             "N361_fp32x": mlp_times(361, torch.float32),
             f"{lb}N40_bert": attn_times(40, LOCKSTEP_B),
             f"{lb}N321_bf16x": mlp_times(321, torch.bfloat16, LOCKSTEP_B),
             f"{lb}N361_fp32x": mlp_times(361, torch.float32, LOCKSTEP_B)}
    emit({"phase": "fused_kernel_times", "timer": TIMER, "times": times})
    return worst, times


# tensor parallelism's kernel shapes: (label, C, H, tp); a
# rank's blocks run #1/#2 at H/tp heads, #4's projection at K = C/tp and #7 at
# F = 4C/tp, at B-TRAIN's 16 rows
TP_SHAPES = (("B_tp2", 768, 12, 2), ("B_tp4", 768, 12, 4), ("L_tp2", 1024, 16, 2))
# the TP shares' products (proj_partial, fc2 with an fp32 out) are fp32 sums of
# exact products of bf16 values, in another order than the plain version's
TP_PARTIAL_ATOL, TP_PARTIAL_RTOL = F32_ATOL, F32_RTOL
TP_GRID_DOC = ("B=16 (B-TRAIN's rows) x (N=321 bf16 x open, N=361 fp32 x flag0) at each of "
               "TP_SHAPES; times at N=361 fp32 x flag0 (ln_qkv, qkv_attention, the "
               "projection's share, ln_mlp's share) and N=321 bf16 x (ln_mlp's share)")


def tp_kernel_phase(dev, seed: int):
    """Kernels #1/#2, #4's projection and #7 at tensor parallelism's shapes
    (TP_SHAPES: a rank's H/tp heads, K = C/tp, F = 4C/tp) at B=16: ln_qkv,
    qkv_attention, their pair, `proj_residual` on a zero fp32 stream (the
    rank's fp32 share of the projection, ops/ln_qkv_attn_proj.py::
    proj_partial) and `ln_mlp` with an fp32 out (ln_mlp_partial) against
    their plain versions; then times, bound, plain and library call.
    Returns ({name: worst error}, {label: {shape: {name: times}}})."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from uvltrack_tpu_torch.ops import ln_mlp as lm
    from uvltrack_tpu_torch.ops import ln_qkv_attention as lqa
    from uvltrack_tpu_torch.ops import ln_qkv_attn_proj as lqp

    rng = np.random.default_rng(seed + 5)
    b = TRAIN_B
    b16 = torch.bfloat16

    def arr(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    def case(c, tp, n, kind, x_dtype):
        f, k, h = 3 * c // tp, c // tp, 4 * c // tp
        x = arr(rng.normal(size=(b, n, c))).to(x_dtype)
        g, be = arr(1 + 0.1 * rng.normal(size=c)), arr(0.1 * rng.normal(size=c))
        return {"x": x, "g": g, "be": be,
                "w": arr(rng.normal(size=(f, c)) / np.sqrt(c)).to(b16),
                "wb": arr(0.02 * rng.normal(size=f)),
                "kb": arr(np.where(key_masks(b, n, kind, rng), -1e10, 0.0)),
                "attn": arr(0.3 * rng.normal(size=(b, n, k))).to(b16),
                "wp": arr(rng.normal(size=(c, k)) / np.sqrt(k)).to(b16),
                "w1": arr(rng.normal(size=(h, c)) / np.sqrt(c)).to(b16),
                "b1": arr(0.02 * rng.normal(size=h)),
                "w2": arr(rng.normal(size=(c, h)) / np.sqrt(4 * c)).to(b16)}

    worst = {}

    def check(name, got, want, atol, rtol, what):
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{name} {what}: {got.dtype}{tuple(got.shape)} vs plain "
                                 f"{want.dtype}{tuple(want.shape)}")
        a, w = got.float(), want.float()
        e = float((a - w).abs().max())
        if not bool(((a - w).abs() <= atol + rtol * w.abs()).all()):
            raise AssertionError(f"{name} {what}: max abs err {e} over tolerance")
        worst[name] = max(worst.get(name, 0.0), e)

    for label, c, heads, tp in TP_SHAPES:
        hh = heads // tp
        for n, kind, x_dtype in ((321, "open", b16), (361, "flag0", torch.float32)):
            t = case(c, tp, n, kind, x_dtype)
            what = f"{label} N={n} x={x_dtype}"
            qkv = lqa.ln_qkv(t["x"], t["g"], t["be"], t["w"], t["wb"])
            out = lqa.qkv_attention(qkv, t["kb"], hh)
            check("ln_qkv", qkv, lqa.ln_qkv_plain(t["x"], t["g"], t["be"], t["w"], t["wb"]),
                  KERNEL_ATOL["ln_qkv"], KERNEL_RTOL, what)
            check("qkv_attention", out, lqa.qkv_attention_plain(qkv, t["kb"], hh),
                  KERNEL_ATOL["qkv_attention"], KERNEL_RTOL, what)
            check("ln_qkv_attention", out, lqa.ln_qkv_attention_plain(
                t["x"], t["g"], t["be"], t["w"], t["wb"], t["kb"], hh),
                KERNEL_ATOL["ln_qkv_attention"], KERNEL_RTOL, what)
            check("proj_partial", lqp.proj_partial(t["attn"], t["wp"]),
                  lqp.proj_partial_plain(t["attn"], t["wp"]), TP_PARTIAL_ATOL, TP_PARTIAL_RTOL,
                  what)
            args = (t["x"], t["g"], t["be"], t["w1"], t["b1"], t["w2"])
            part = lm.ln_mlp_partial(*args)
            again = lm.ln_mlp_partial(*args)
            torch.cuda.synchronize()
            check("ln_mlp_partial", part, lm.ln_mlp_partial_plain(*args), KERNEL_ATOL["ln_mlp"],
                  KERNEL_RTOL, what)
            if not torch.equal(part, again):
                raise AssertionError(f"ln_mlp_partial {what}: a second call differs")
    emit({"phase": "tp_kernel_check", "shapes": TP_SHAPES, "grid": TP_GRID_DOC,
          "tolerance": {"ln_qkv, qkv_attention, ln_qkv_attention, ln_mlp_partial":
                        "KERNEL_ATOL + KERNEL_RTOL*|plain| (kernel_check's)",
                        "proj_partial": f"|kernel-plain| <= {TP_PARTIAL_ATOL} + "
                                        f"{TP_PARTIAL_RTOL}*|plain|"},
          "ln_mlp_partial_repeatable": "bitwise, two calls at every shape",
          "max_abs_err": worst})

    def row(kern, plain, lib, lib_what, work):
        b_ms, b_by = bound(*work)
        return {**timings(kern, plain, lib), "library": lib_what, "bound_ms": b_ms,
                "bound_by": b_by}

    def timed(c, heads, tp, n, kind, x_dtype, names):
        t = case(c, tp, n, kind, x_dtype)
        hh, m, xb = heads // tp, b * n, t["x"].element_size()
        f, k, h = 3 * c // tp, c // tp, 4 * c // tp
        x, g, be, w, wb, kb = t["x"], t["g"], t["be"], t["w"], t["wb"], t["kb"]
        qkv = lqa.ln_qkv(x, g, be, w, wb)
        mask = kb.to(b16)[:, None, None, :]

        def ln():
            return F.layer_norm(x.float(), (c,), g, be, 1e-6).to(b16)

        def sdpa(q3):
            q, kk, v = q3.view(b, n, 3, hh, 64).permute(2, 0, 3, 1, 4).unbind(0)
            return F.scaled_dot_product_attention(q, kk, v, attn_mask=mask)

        margs = (x, g, be, t["w1"], t["b1"], t["w2"])
        rows = {
            "ln_qkv": lambda: row(
                lambda: lqa.ln_qkv(x, g, be, w, wb), lambda: lqa.ln_qkv_plain(x, g, be, w, wb),
                lambda: F.linear(ln(), w, wb.to(b16)), "F.layer_norm + F.linear, 2 calls",
                (2 * m * c * f, m * c * xb + f * c * 2 + f * 4 + 2 * c * 4 + m * f * 2)),
            "qkv_attention": lambda: row(
                lambda: lqa.qkv_attention(qkv, kb, hh), lambda: lqa.qkv_attention_plain(
                    qkv, kb, hh), lambda: sdpa(qkv), "SDPA",
                (4 * hh * b * n * n * 64, m * f * 2 + m * 4 + m * k * 2)),
            "proj_partial": lambda: row(
                lambda: lqp.proj_partial(t["attn"], t["wp"]),
                lambda: lqp.proj_partial_plain(t["attn"], t["wp"]),
                lambda: F.linear(t["attn"], t["wp"]), "F.linear (bf16 out)",
                (2 * m * k * c, m * k * 2 + c * k * 2 + m * c * 4)),
            "ln_mlp_partial": lambda: row(
                lambda: lm.ln_mlp_partial(*margs), lambda: lm.ln_mlp_partial_plain(*margs),
                lambda: F.linear(F.gelu(F.linear(ln(), t["w1"], t["b1"].to(b16))), t["w2"]),
                "F.layer_norm + F.linear + F.gelu + F.linear, 4 calls",
                (4 * m * c * h, m * c * xb + 2 * c * h * 2 + (h + 2 * c) * 4 + m * c * 4)),
        }
        return {name: rows[name]() for name in names}

    times = {}
    for label, c, heads, tp in TP_SHAPES:
        times[label] = {
            "N361_fp32x_flag0": timed(c, heads, tp, 361, "flag0", torch.float32,
                                      ("ln_qkv", "qkv_attention", "proj_partial",
                                       "ln_mlp_partial")),
            "N321_bf16x_open": timed(c, heads, tp, 321, "open", b16, ("ln_mlp_partial",))}
    emit({"phase": "tp_kernel_times", "shapes": TP_SHAPES, "rows": TRAIN_B, "timer": TIMER,
          "times": times})
    return worst, times


# ------------------------------------------------------------------ phase 3
def frame_work(model, nt: int) -> dict:
    """Operations and weight bytes of one tracked frame, counted from the
    shapes by the package (track/tracker.py::frame_cost, which
    Tracker.step_cost reads): the 12 blocks (qkv, attention, projection,
    MLP), the patch embedding and the head's conv towers, and the weights
    the step reads (blocks, patch embedding, towers) at their stored width."""
    from uvltrack_tpu_torch.track.tracker import frame_cost

    cost = frame_cost(model, nt)
    flops, wbytes = cost["flops"], cost["weight_bytes"]
    return {"frame_gflops": flops / 1e9, "kernel1_gflops": cost["kernel1_flops"] / 1e9,
            "frame_weight_bytes": wbytes,
            "frame_bound_ms": bound(flops, wbytes)[0], "frame_bound_by": bound(flops, wbytes)[1]}


def synthetic_sequence(n_frames: int, seed: int, h: int = 720, w: int = 1280, phase: int = 0):
    """A textured background and a textured 96x64 target moving on a
    Lissajous path from its point `phase`; returns (frames, ground-truth
    xywh boxes)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, size=(h // 16 + 1, w // 16 + 1, 3)).astype(np.uint8)
    bg = np.repeat(np.repeat(coarse, 16, 0), 16, 1)[:h, :w]
    bg = (bg // 2 + rng.integers(0, 128, size=(h, w, 3), dtype=np.uint8))
    tw, th = 96, 64
    target = rng.integers(0, 256, size=(th // 8, tw // 8, 3)).astype(np.uint8)
    target = np.repeat(np.repeat(target, 8, 0), 8, 1)
    frames, boxes = [], []
    for t in range(phase, phase + n_frames + 1):
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
    from uvltrack_tpu_torch.ops import attention

    attention.force_backend("cuda")
    tracker.initialize(frames[0], info)
    tally = AbTally()
    for f in frames[1:]:
        st = tracker.state
        crop = crop_side(st.box[0].tolist(), tracker.search_factor)
        attention.force_backend("plain")
        p = tracker.track_debug(f)
        tracker.state = st
        attention.force_backend("cuda")
        k = tracker.track_debug(f)
        tally.add(p["target_bbox"], p["merged_map"], k["target_bbox"], k["merged_map"], crop)
    attention.force_backend(None)
    return tally.summary()


def crop_side(box, search_factor: float) -> int:
    """The search crop's side in pixels for an xywh box (crop_params)."""
    import math

    return math.ceil(math.sqrt(box[2] * box[3]) * search_factor)


class AbTally:
    """paired_ab's rule, one frame at a time: two paths stepped from one
    state agree if they pick the same argmax cell of the merged map with
    boxes within AB_BOX_REL of the search crop's side, or pick cells that
    are a near-tie (within AB_TIE of the maximum) in both maps. A miss
    raises; `what` names the pair in the message."""

    def __init__(self, what: str = "plain/kernel"):
        self.what, self.same, self.flips, self.px, self.rel = what, 0, 0, [], []

    def add(self, box_a, map_a, box_b, map_b, crop: int) -> None:
        import numpy as np

        ma, mb = np.asarray(map_a).ravel(), np.asarray(map_b).ravel()
        ia, ib = int(ma.argmax()), int(mb.argmax())
        d = float(np.abs(np.subtract(box_a, box_b)).max())
        if ia == ib:
            self.same += 1
            self.px.append(d)
            self.rel.append(d / crop)
            if d > AB_BOX_REL * crop:
                raise AssertionError(f"{self.what}: same cell, boxes {d} px apart on a {crop} "
                                     f"px crop (> {AB_BOX_REL} of its side)")
        else:
            self.flips += 1
            if mb[ia] < (1 - AB_TIE) * mb[ib] or ma[ib] < (1 - AB_TIE) * ma[ia]:
                raise AssertionError(f"{self.what}: argmax flip that is not a near-tie: "
                                     f"{ma[ia]:.4g}/{ma[ib]:.4g} vs {mb[ib]:.4g}/{mb[ia]:.4g}")

    def summary(self) -> dict:
        import numpy as np

        return {"frames": self.same + self.flips, "same_cell": self.same,
                "near_tie_flips": self.flips,
                "box_diff_px_max_same_cell": max(self.px, default=0.0),
                "box_diff_px_mean_same_cell": float(np.mean(self.px)) if self.px else 0.0,
                "box_diff_crop_frac_max_same_cell": max(self.rel, default=0.0),
                "box_diff_crop_frac_mean_same_cell":
                    float(np.mean(self.rel)) if self.rel else 0.0,
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
    tracker = Tracker(cfg, model, tokenizer=tokenizer, graphs=False)
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
    t = Tracker(cfg, model, tokenizer=tokenizer, graphs=False)
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
        search, _ = sample_target_device(t._frame(frames[1])[None], t.state.box,
                                         t.search_factor, t.search_size)
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
    frames1 = frame[None]
    st = t.state
    ctx = anno2mask(box_cxcywh_to_xywh(torch.tensor([[0.5, 0.5, 0.2, 0.2]], device=t.device)),
                    t.map_size)
    with torch.no_grad():
        search, _ = sample_target_device(frames1, st.box, t.search_factor, t.search_size)
        feats = m.backbone.forward_cached_text(t.template, search, t.txt, t.text_mask, t.flag)
        out = {
            "crop": cuda_time_ms(lambda: sample_target_device(
                frames1, st.box, t.search_factor, t.search_size), iters, 3),
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
    tracker.initialize(frames[0], info)
    tracker.track(frames[1])
    n = len(frames[2:2 + n])
    return {"frames": n, **profile_window(lambda i: tracker.track(frames[2 + i]), n, "frame")}


class ProfileWindow:
    """torch.profiler from its construction to close(n, unit), a stretch of
    n units of work, the last ending in a read-back: the device's own
    events (kernels, copies, memsets) summed over the host-clock window,
    per unit, and the 12 that take most of it."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def close(self, n: int, unit: str) -> dict:
        import torch

        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - self.t0) * 1e6
        self.prof.__exit__(None, None, None)
        return _profile_summary(self.prof, wall_us, n, unit)


def profile_window(call, n: int, unit: str) -> dict:
    """ProfileWindow over call(0) .. call(n-1), each ending in a read-back
    and each one `unit`."""
    window = ProfileWindow()
    for i in range(n):
        call(i)
    return window.close(n, unit)


def _profile_summary(prof, wall_us: float, n: int, unit: str) -> dict:
    from torch.autograd import DeviceType

    def dev_us(e):
        return float(e.self_device_time_total)

    # the CPU ops that launched the device's events carry the same time
    # again and are left out
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    total = sum(dev_us(e) for e in evs)
    if total == 0:
        return {"device_time": "not measured (the profiler saw no device time)"}
    top = sorted(evs, key=dev_us, reverse=True)[:12]
    return {f"wall_ms_per_{unit}": wall_us / n / 1e3, f"device_ms_per_{unit}": total / n / 1e3,
            "busy_share": total / wall_us, f"device_ops_per_{unit}": sum(e.count for e in evs) / n,
            "top": [{"name": e.key[:90], f"calls_per_{unit}": e.count / n,
                     f"ms_per_{unit}": dev_us(e) / n / 1e3} for e in top]}


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
    tracker = Tracker(cfg, model, tokenizer=tokenizer, graphs=False)
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
    tf, tq = Tracker(cfg_fp, model_fp, graphs=False), Tracker(cfg_q8, model_q8, graphs=False)
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


# ------------------------------------------------------------ multistream
MULTISTREAM_TIMER = ("host clock per BatchTracker.step (StreamPool.submit), each ending in the "
                     "(S, 5) read-back; stream-frames/s = active stream-frames over the summed "
                     "step times; the frames are on the host before the clock starts")


def load_row(tracker, bt, st, i: int) -> None:
    """Put stream i of BatchTracker `bt` at state `st` into a single
    Tracker: its per-sequence rows (template, masks, text, flag) and its
    state, so both step from the same state."""
    import dataclasses

    tracker.template, tracker.template_mask = bt.template[i:i + 1], bt.template_mask[i:i + 1]
    tracker.txt, tracker.text_mask = bt.txt[i:i + 1], bt.text_mask[i:i + 1]
    tracker.flags = bt.flags[i:i + 1]
    tracker.state = dataclasses.replace(st, **{
        f.name: getattr(st, f.name)[i:i + 1] for f in dataclasses.fields(st)})


def checked_step(bt, single, batch, tallies) -> None:
    """One lockstep step, checked: from the same state, the batch on the
    plain backend, then on the kernels (whose state goes on); each active
    row of the kernel step against (b) the plain step's row and (a) a
    single Tracker stepped from that row's state on the kernels, under
    paired_ab's rule."""
    from uvltrack_tpu_torch.ops import attention

    st = bt.state
    attention.force_backend("plain")
    p, pm = (t.float().cpu().numpy() for t in bt.step_async(batch, debug=True))
    bt.state = st
    attention.force_backend("cuda")
    k, km = (t.float().cpu().numpy() for t in bt.step_async(batch, debug=True))
    after = bt.state
    for i in map(int, st.active.nonzero()[0]):
        crop = crop_side(st.box[i].tolist(), bt.search_factor)
        tallies["kernel_vs_plain"].add(p[i, :4], pm[i, 2], k[i, :4], km[i, 2], crop)
        load_row(single, bt, st, i)
        r = single.track_debug(batch[i])
        tallies["batch_vs_single"].add(r["target_bbox"], r["merged_map"], k[i, :4], km[i, 2],
                                       crop)
    bt.state = after
    attention.force_backend(None)


def expect_launches(per_fwd: dict, forwards: int, got: dict, what: str) -> None:
    want = {k: v * forwards for k, v in per_fwd.items()}
    if got != want:
        raise AssertionError(f"{what}: launches {got} != {per_fwd} x {forwards} forwards")


class LockstepCell:
    """S streams (one a mode, sentence and sequence each; lengths[i] frames
    of seqs[i], frame 0 the init) tracked in lockstep by one BatchTracker on
    the kernels. run() is one run of the sequence, timed per step; timed()
    a run whose launches per batched forward and per initialize are checked
    against the single-stream counts and whose re-mines are counted;
    finish() the checked run (checked_step each step), NL streams'
    grounding against a single Tracker's, a profiler window, and the
    phase's line."""

    def __init__(self, label, model, cfg, seqs, modes, languages, lengths, tokenizer, per_fwd):
        import numpy as np

        from uvltrack_tpu_torch.track.batch import BatchTracker

        self.label, self.model, self.cfg, self.tokenizer = label, model, cfg, tokenizer
        self.modes, self.languages, self.lengths, self.per_fwd = modes, languages, lengths, per_fwd
        self.S, self.T = len(modes), max(lengths) - 1
        self.frames0 = [seqs[i][0][0] for i in range(self.S)]
        self.boxes0 = np.asarray([seqs[i][1][0] for i in range(self.S)], np.float32)
        self.actives = [np.asarray([t < n for n in lengths]) for t in range(1, self.T + 1)]
        # a frozen stream's row gets its first frame again, as the batched runner does
        self.batches = [np.stack([seqs[i][0][t] if act[i] else self.frames0[i]
                                  for i in range(self.S)])
                        for t, act in zip(range(1, self.T + 1), self.actives)]
        self.bt = BatchTracker(cfg, model, self.S, tokenizer=tokenizer, graphs=False)
        self.lats, self.peak = [], 0

    def initialize(self):
        return self.bt.initialize(self.frames0, self.boxes0, languages=self.languages,
                                  modes=self.modes)

    def run(self):
        """(init boxes, init seconds, launches of initialize, launches of the
        steps, host-clock seconds a step, (T, S, 5) outputs)."""
        import numpy as np
        import torch

        from uvltrack_tpu_torch.ops import attention
        from uvltrack_tpu_torch.ops import build

        attention.force_backend("cuda")
        torch.cuda.synchronize()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        init_boxes = self.initialize()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_inst = build.instantiation_counts()
        build.reset_launch_counts()
        lat, outs = [], []
        for batch, active in zip(self.batches, self.actives):
            self.bt.set_active(active)
            t0 = time.perf_counter()
            outs.append(self.bt.step(batch))
            lat.append(time.perf_counter() - t0)
        attention.force_backend(None)
        return (init_boxes, init_s, init_inst, build.instantiation_counts(), np.asarray(lat),
                np.stack(outs))

    def timed(self):
        import numpy as np
        import torch

        torch.cuda.reset_peak_memory_stats()
        self.init_boxes, self.init_s, init_inst, inst, lat, self.out = self.run()
        self.peak = max(self.peak, torch.cuda.max_memory_allocated())
        self.lats.append(lat)
        label, T = self.label, self.T
        # (c) the batch rides in the rows: a batched forward launches what one
        # stream's forward launches (NL grounding: one batch-1 forward a stream)
        expect_launches(self.per_fwd, T, inst, f"{label}: {T} steps")
        expect_launches(self.per_fwd, 1 + self.modes.count("NL"), init_inst,
                        f"{label}: initialize")
        self.inst, self.init_inst = inst, init_inst
        self.frames_done = np.sum(self.actives, axis=0)
        self.remines = self.bt.remines
        if self.remines.tolist() != (self.frames_done
                                     // int(self.cfg.TEST.UPDATE_INTERVAL)).tolist():
            raise AssertionError(f"{label}: re-mines {self.remines.tolist()} after "
                                 f"{self.frames_done.tolist()} frames")
        if not np.isfinite(self.out).all() or self.out.shape != (T, self.S, 5):
            raise AssertionError(f"{label}: non-finite or misshapen output {self.out.shape}")

    def finish(self):
        import numpy as np

        from uvltrack_tpu_torch.ops import attention
        from uvltrack_tpu_torch.track.tracker import Tracker

        bt, label, S, T = self.bt, self.label, self.S, self.T
        # (a), (b): every step from a shared state
        tallies = {"kernel_vs_plain": AbTally(f"{label} kernel/plain"),
                   "batch_vs_single": AbTally(f"{label} batch/single")}
        single = Tracker(self.cfg, self.model, tokenizer=self.tokenizer, graphs=False)
        attention.force_backend("cuda")
        self.initialize()
        for batch, active in zip(self.batches, self.actives):
            bt.set_active(active)
            checked_step(bt, single, batch, tallies)
        # (d) NL streams: the grounded box against a single NL Tracker's
        grounding = []
        for i in (i for i in range(S) if self.modes[i] == "NL"):
            self.cfg.TEST.MODE = "NL"  # read by Tracker.initialize
            alone = Tracker(self.cfg, self.model, tokenizer=self.tokenizer, graphs=False)
            attention.force_backend("cuda")
            want = alone.initialize(self.frames0[i], {"language": self.languages[i]})
            self.cfg.TEST.MODE = "BBOX"
            d = float(np.abs(np.subtract(self.init_boxes[i], want["target_bbox"])).max())
            side = max(self.frames0[i].shape[:2])
            grounding.append({"stream": i, "box": self.init_boxes[i].tolist(),
                              "single": want["target_bbox"], "diff_px": d,
                              "side_frac": d / side})
            if d > AB_BOX_REL * side:
                raise AssertionError(f"{label}: stream {i} grounded {d} px from a single "
                                     f"Tracker's box (> {AB_BOX_REL} of the letterbox side)")
        # the card's busy share at batch S over 8 steps
        self.initialize()
        bt.step(self.batches[0])
        busy = profile_window(lambda j: bt.step(self.batches[1 + j]), min(8, T - 1), "step")
        attention.force_backend(None)
        if isinstance(busy.get("device_ms_per_step"), float):
            busy["device_ms_per_stream_frame"] = busy["device_ms_per_step"] / S
            busy["device_ops_per_stream_frame"] = busy["device_ops_per_step"] / S
        lat = np.concatenate(self.lats)
        stream_frames = int(self.frames_done.sum())
        emit({"phase": f"multistream_{label}", "S": S, "steps": T, "modes": self.modes,
              "stream_lengths": list(self.lengths), "frame_hw": list(self.frames0[0].shape[:2]),
              "timer": MULTISTREAM_TIMER, "runs": len(self.lats),
              "stream_frames_per_run": stream_frames,
              "stream_frames_per_s": stream_frames * len(self.lats) / float(lat.sum()),
              "stream_frames_per_s_by_run": [stream_frames / float(r.sum()) for r in self.lats],
              "slot_frames_per_s": S * len(lat) / float(lat.sum()),
              "step_ms_p50": float(np.percentile(lat, 50) * 1e3),
              "step_ms_p90": float(np.percentile(lat, 90) * 1e3),
              "step_ms_p50_by_run": [float(np.percentile(r, 50) * 1e3) for r in self.lats],
              "init_s": self.init_s, "peak_mem_bytes": int(self.peak),
              "launches_per_step": {k: v / T for k, v in self.inst.items()},
              "launches_per_initialize": self.init_inst, "remines": self.remines.tolist(),
              "paired": {k: t.summary() for k, t in tallies.items()},
              **({"nl_grounding": grounding} if grounding else {}), "device_profile": busy})


def tracker_run(model, cfg, seq, frames: int):
    """Host-clock seconds of each Tracker.track (BBOX, the kernels) over
    `frames` frames of seq after its frame 0: B-BBOX's step, timed in the
    multistream phase's turns."""
    import numpy as np

    from uvltrack_tpu_torch.ops import attention
    from uvltrack_tpu_torch.track.tracker import Tracker

    cfg.TEST.MODE = "BBOX"
    tracker = Tracker(cfg, model, graphs=False)
    attention.force_backend("cuda")
    tracker.initialize(seq[0][0], {"init_bbox": seq[1][0]})
    lat = []
    for f in seq[0][1:frames + 1]:
        t0 = time.perf_counter()
        tracker.track(f)
        lat.append(time.perf_counter() - t0)
    attention.force_backend(None)
    return np.asarray(lat)


def runner_cell(model, cfg, seqs, languages, lengths, tokenizer, direct) -> None:
    """The batched eval runner (eval/running_batched.py) over the same
    streams, frames handed over in memory through image_loader: every
    sequence must be saved (a stream the runner isolates as failed fails
    the run); whether its integer boxes equal the direct run's is
    reported."""
    import numpy as np

    from uvltrack_tpu_torch.eval import Sequence, SequenceList, run_dataset_batched
    from uvltrack_tpu_torch.ops import attention
    from uvltrack_tpu_torch.track.batch import BatchTracker

    frames = {f"s{i}/{t}": f for i in range(len(lengths)) for t, f in
              enumerate(seqs[i][0][:lengths[i]])}
    ds = SequenceList([Sequence(f"s{i}", [f"s{i}/{t}" for t in range(n)], "synthetic",
                                np.asarray(seqs[i][1][:n]), language=languages[i])
                       for i, n in enumerate(lengths)])
    rdir = REPO / "build" / "chip_smoke" / "results"
    cfg.TEST.MODE = "NLBBOX"  # a stream with no sentence gets flag 0
    attention.force_backend("cuda")
    t0 = time.perf_counter()
    stats = run_dataset_batched(lambda S: BatchTracker(cfg, model, S, tokenizer=tokenizer,
                                                       graphs=False), ds,
                                str(rdir), num_streams=len(lengths), image_loader=frames.get,
                                rerun=True, verbose=False)
    wall = time.perf_counter() - t0
    attention.force_backend(None)
    if stats["sequences"] != len(lengths):
        raise AssertionError(f"the batched runner saved {stats['sequences']} of "
                             f"{len(lengths)} sequences")
    same = True
    for i, n in enumerate(lengths):
        got = np.loadtxt(rdir / f"s{i}.txt", delimiter="\t", ndmin=2)
        if got.shape != (n, 4):
            raise AssertionError(f"runner result s{i}: shape {got.shape}, not ({n}, 4)")
        same &= bool(np.array_equal(got[1:], np.round(direct[:n - 1, i, :4])))
    emit({"phase": "multistream_runner", "sequences": stats["sequences"],
          "frames": stats["frames"], "wall_s": wall,
          "boxes_equal_the_direct_run": same})


POOL_OPENS = {0: ["A"], 3: ["B"], 7: ["C"], 12: ["D"]}
POOL_CLOSES, POOL_SKIPS = {12: ["A"]}, {15: ["C"], 16: ["C"]}
POOL_SEQ = {"A": 0, "B": 1, "C": 2, "D": 3}


def pool_schedule(pool, seqs, languages, on_open, on_round, rounds: int = 24):
    """Drive a StreamPool through the pool cell's rounds: opens, closes and
    skips as POOL_*; each open stream sends its sequence's next frame every
    round it does not skip; on_open(do) runs an open, on_round(pool,
    {stream: frame}) a round. Returns {stream: frames sent}."""
    sent = {}
    for r in range(rounds):
        for s in POOL_CLOSES.get(r, []):
            pool.close(s)
            del sent[s]
        for s in POOL_OPENS.get(r, []):
            i = POOL_SEQ[s]
            on_open(lambda: pool.open(s, seqs[i][0][0], {"init_bbox": seqs[i][1][0],
                                                        "language": languages[i]}))
            sent[s] = 0
        pending = {}
        for s in sent:
            if s not in POOL_SKIPS.get(r, []):
                sent[s] += 1
                pending[s] = seqs[POOL_SEQ[s]][0][sent[s]]
        on_round(pool, pending)
    return sent


def pool_cell(model, cfg, seqs, languages, tokenizer, per_fwd, rounds: int = 24):
    """A StreamPool of 4 slots in NLBBOX mode (streams without a sentence
    get flag 0): streams open at rounds 0, 3 and 7, C skips rounds 15-16
    (frozen), A closes at round 12 and D takes its slot; each open stream
    submits its next frame every round. A timed run (launches per submit
    and per open checked; a profiler window over 8 more rounds of the three
    streams left), then a checked run stepping the pool's batch through
    checked_step. Returns the timed run's launches."""
    import numpy as np
    import torch

    from uvltrack_tpu_torch.ops import attention
    from uvltrack_tpu_torch.ops import build
    from uvltrack_tpu_torch.track.pool import StreamPool
    from uvltrack_tpu_torch.track.tracker import Tracker

    opens, closes, skips, seq_of = POOL_OPENS, POOL_CLOSES, POOL_SKIPS, POOL_SEQ
    cfg.TEST.MODE = "NLBBOX"

    def schedule(pool, on_open, on_round):
        return pool_schedule(pool, seqs, languages, on_open, on_round, rounds)

    def timed():
        pool = StreamPool(cfg, model, capacity=4, tokenizer=tokenizer, graphs=False)
        lat, open_s, counts = [], [], {"open": {}, "submit": {}}

        def count(kind):
            for k, v in build.instantiation_counts().items():
                counts[kind][k] = counts[kind].get(k, 0) + v
            build.reset_launch_counts()

        def on_open(do):
            torch.cuda.synchronize()
            build.reset_launch_counts()
            t0 = time.perf_counter()
            do()
            torch.cuda.synchronize()
            open_s.append(time.perf_counter() - t0)
            count("open")

        def on_round(pool, pending):
            build.reset_launch_counts()
            t0 = time.perf_counter()
            out = pool.submit(pending)
            lat.append((time.perf_counter() - t0, len(pending)))
            if not all(np.isfinite(o["bbox"]).all() for o in out.values()):
                raise AssertionError("pool: non-finite box")
            count("submit")

        attention.force_backend("cuda")
        sent = schedule(pool, on_open, on_round)
        attention.force_backend(None)
        return pool, sent, np.asarray(lat), open_s, counts

    timed()  # warm-up
    torch.cuda.reset_peak_memory_stats()
    pool, sent, lat, open_s, counts = timed()
    peak = torch.cuda.max_memory_allocated()
    expect_launches(per_fwd, rounds, counts["submit"], "pool: submits")
    expect_launches(per_fwd, sum(map(len, opens.values())), counts["open"], "pool: opens")
    want = [0] * pool.capacity
    for s, i in pool.slot_of.items():
        want[i] = sent[s] // int(cfg.TEST.UPDATE_INTERVAL)
    remines = pool.bt.remines.tolist()
    if remines != want:
        raise AssertionError(f"pool: re-mines {remines} != {want}")
    # the card's busy share over 8 more rounds of the streams left open
    attention.force_backend("cuda")
    busy = profile_window(lambda j: pool.submit({
        s: seqs[seq_of[s]][0][sent[s] + 1 + j] for s in sent}), 8, "step")
    attention.force_backend(None)

    tallies = {"kernel_vs_plain": AbTally("pool kernel/plain"),
               "batch_vs_single": AbTally("pool batch/single")}
    single = Tracker(cfg, model, tokenizer=tokenizer, graphs=False)

    def checked(pool, pending):
        """submit's batch and active rows, stepped by checked_step."""
        (h, w), = {f.shape[:2] for f in pending.values()}
        batch = np.zeros((pool.capacity, h, w, 3), np.uint8)
        active = np.zeros((pool.capacity,), bool)
        for s, f in pending.items():
            batch[pool.slot_of[s]], active[pool.slot_of[s]] = f, True
        pool.bt.set_active(active)
        checked_step(pool.bt, single, batch, tallies)

    attention.force_backend("cuda")
    schedule(StreamPool(cfg, model, capacity=4, tokenizer=tokenizer, graphs=False),
             lambda do: do(), checked)
    attention.force_backend(None)
    stream_frames = int(lat[:, 1].sum())
    emit({"phase": "multistream_pool", "capacity": 4, "rounds": rounds,
          "schedule": {"open": opens, "close": closes, "skip": skips},
          "timer": MULTISTREAM_TIMER, "stream_frames": stream_frames,
          "stream_frames_per_s": stream_frames / float(lat[:, 0].sum()),
          "submit_ms_p50": float(np.percentile(lat[:, 0], 50) * 1e3),
          "submit_ms_p90": float(np.percentile(lat[:, 0], 90) * 1e3),
          "open_ms_mean": float(np.mean(open_s) * 1e3), "peak_mem_bytes": int(peak),
          "launches_per_submit": {k: v / rounds for k, v in counts["submit"].items()},
          "launches_per_open": {k: v / len(open_s) for k, v in counts["open"].items()},
          "remines_by_slot": remines,
          "paired": {k: t.summary() for k, t in tallies.items()},
          "device_profile": {"streams": len(sent), **busy}})
    return {k: counts["open"].get(k, 0) + counts["submit"].get(k, 0)
            for k in {*counts["open"], *counts["submit"]}}


def multistream_phase(model, cfg, model_q8, cfg_q8, tokenizer, language, per_fwd_fp,
                      per_fwd_q8, seqs) -> dict:
    """Lockstep tracking of UVLTrack-B at S = 1, 4 and 8 (bf16) and 4
    (int8), the batched runner at S=4, and a StreamPool of 4 slots, on
    720p synthetic sequences (a seed and a start on the path each; frame 0
    the init). The host's clock drifts within a call, so the cells' timed
    runs, and a single Tracker's (B-BBOX's step) beside them, go in turns:
    each cell once in order, then once in reverse. Returns the launches by
    instantiation over the timed runs."""
    import numpy as np

    launches = {}

    def add(inst):
        for k, v in inst.items():
            launches[k] = launches.get(k, 0) + v

    t0 = time.perf_counter()
    mix = ["BBOX", "NLBBOX"] * 4
    langs = [language] * 8
    lengths4 = [33, 33, 25, 33]  # stream 2 is 8 frames shorter: frozen for 8 steps
    cells = [LockstepCell("S1", model, cfg, seqs, ["BBOX"], langs[:1], [33], tokenizer,
                          per_fwd_fp),
             LockstepCell("S4", model, cfg, seqs, mix[:4], langs[:4], lengths4, tokenizer,
                          per_fwd_fp),
             # the mix and an NL stream, grounded at initialize
             LockstepCell("S8", model, cfg, seqs, mix[:7] + ["NL"], langs,
                          [33, 33, 25] + [33] * 5, tokenizer, per_fwd_fp),
             LockstepCell("S4_q8", model_q8, cfg_q8, seqs, mix[:4], langs[:4], [17, 17, 9, 17],
                          tokenizer, per_fwd_q8)]
    # the kernel phases checked every kernel at each of these batches
    assert {cell.S for cell in cells} - {1} <= set(LOCKSTEP_S)
    for cell in cells:
        cell.run()  # warm-up: this batch size's first launches, cuBLAS/cuDNN plans
    tracker_run(model, cfg, seqs[0], 32)
    turns = []
    for order in (cells, cells[::-1]):
        turn = {"tracker": float(np.percentile(tracker_run(model, cfg, seqs[0], 32), 50) * 1e3)}
        for cell in order:
            cell.timed()
            turn[cell.label] = float(np.percentile(cell.lats[-1], 50) * 1e3)
        turns.append(turn)
    for cell in cells:
        add(cell.inst)
    emit({"phase": "multistream_turns", "what": "step p50 ms of each timed run, in the turns' "
          "order (tracker: Tracker.track, B-BBOX's step, over stream 0's frames)",
          "turns": turns})
    s4 = cells[1]
    runner_cell(model, cfg, seqs, [None, language, None, language], lengths4, tokenizer, s4.out)
    for cell in cells:
        cell.finish()
    add(pool_cell(model, cfg, seqs, [None, language, language, None], tokenizer, per_fwd_fp))
    emit({"phase": "multistream_seconds", "seconds": time.perf_counter() - t0})
    return launches


# --------------------------------------------------------------- compiled
COMPILED_TIMER = ("host clock per Tracker.track (BatchTracker.step, StreamPool.submit), each "
                  "ending in the box read-back; graph and eager runs of one cell in turns "
                  "eager/graph/graph/eager; the frames are on the host before the clock starts")


def graph_launches(*jts) -> dict:
    """{instantiation: launches} made by the JitTrackers' graphs: each graph's
    captured calls times its replays (a replay calls no wrapper, so
    build.launch counts nothing)."""
    out = {}
    for jt in jts:
        for key in jt.keys():
            cap, rep = jt.captured_launches(key), jt.replays(key)
            for name in ("step", "remine"):
                for k, n in cap[name].items():
                    out[k] = out.get(k, 0) + n * rep[name]
    return out


def eager_remine_launches(tracker) -> dict:
    """The kernel launches of one eager re-mine body at the tracker's S."""
    import torch

    from uvltrack_tpu_torch.ops import build

    st, c = tracker._tensors()
    due = torch.ones((tracker.S,), dtype=torch.bool, device=tracker.device)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    tracker.jt.remine_body(due, st, c)
    torch.cuda.synchronize()
    return build.instantiation_counts()


def check_captures(jt, keys, per_fwd: dict, remine: dict, what: str) -> dict:
    """The step graph of each key recorded the eager forward's launches
    (per_fwd), its re-mine graph the eager re-mine's (remine). Returns the
    captures, by key."""
    caps = {}
    for key in keys:
        cap = jt.captured_launches(key)
        if cap["step"] != per_fwd or (cap["remine"] and cap["remine"] != remine):
            raise AssertionError(f"{what}: graph {key} captured {cap}, the eager forward "
                                 f"launches {per_fwd} and the re-mine {remine}")
        caps[str(key)] = cap
    return caps


def lat_stats(lat, unit: str = "frame") -> dict:
    import numpy as np

    lat = np.asarray(lat)
    return {f"{unit}s": int(len(lat)), f"{unit}s_per_s": len(lat) / float(lat.sum()),
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p90_ms": float(np.percentile(lat, 90) * 1e3)}


def turns(run, eager, graph):
    """run(eager), run(graph), run(graph), run(eager): A B B A in one call.
    Returns {"eager": [r, r], "graph": [r, r]}."""
    out = {"eager": [], "graph": []}
    for name, t in (("eager", eager), ("graph", graph), ("graph", graph), ("eager", eager)):
        out[name].append(run(t))
    return out


def graph_vs_eager(graph, frames, info, label: str):
    """Every frame from a shared state: the graph step, then the eager debug
    step from the state before it (paired_ab's rule on the box and merged
    map). Returns (the AbTally, the frames whose box and score are bitwise
    equal)."""
    tally, bitwise = AbTally(f"{label} graph/eager"), 0
    graph.initialize(frames[0], info)
    for f in frames[1:]:
        st = graph.state
        crop = crop_side(st.box[0].tolist(), graph.search_factor)
        g = graph.track(f)
        gmap = graph.graph_maps()[0, 2].cpu().numpy()
        after = graph.state
        graph.state = st
        e = graph.track_debug(f)
        graph.state = after
        tally.add(e["target_bbox"], e["merged_map"], g["target_bbox"], gmap, crop)
        bitwise += int(g["target_bbox"] == e["target_bbox"] and g["score"] == e["score"])
    return tally, bitwise


def compiled_single(label, mode, cfg, jt, frames, boxes, tokenizer, language, per_fwd,
                    remine_fwd) -> dict:
    """One stream (B-BBOX, B-NLBBOX, B-NL or B-BBOX-Q8) on jt's graphs
    against the eager step, in turns; then every frame from a shared state,
    the graph step's box and maps against the eager debug step's
    (paired_ab's rule, and bitwise); re-mines and remine replays counted;
    the captures checked; a profiler window each."""
    import numpy as np
    import torch

    from uvltrack_tpu_torch.ops import attention
    from uvltrack_tpu_torch.track.tracker import Tracker

    cfg.TEST.MODE = mode
    info = {"init_bbox": boxes[0], "language": language}
    graph = Tracker(cfg, tokenizer=tokenizer, jit_tracker=jt)
    eager = Tracker(cfg, tokenizer=tokenizer, jit_tracker=jt, graphs=False)
    hw = frames[0].shape[:2]

    def run(t):
        t.initialize(frames[0], info)
        torch.cuda.synchronize()
        lat, out = [], []
        for f in frames[1:]:
            t0 = time.perf_counter()
            r = t.track(f)
            lat.append(time.perf_counter() - t0)
            out.append(r["target_bbox"] + [r["score"]])
        return np.asarray(out), np.asarray(lat), t.remines

    attention.force_backend("cuda")
    n0, s0 = jt.graphs_captured, jt.capture_seconds
    t0 = time.perf_counter()
    run(graph)  # warm-up: captures this frame size's graphs unless another cell did
    first_run_s = time.perf_counter() - t0
    run(eager)
    captured, capture_s = jt.graphs_captured - n0, jt.capture_seconds - s0
    key = jt.graph_key(hw, 1)
    reps0 = jt.replays(key)
    torch.cuda.reset_peak_memory_stats()
    res = turns(run, eager, graph)
    peak = torch.cuda.max_memory_allocated()
    reps = {k: v - reps0[k] for k, v in jt.replays(key).items()}
    n = len(frames) - 1
    want_remines = n // int(cfg.TEST.UPDATE_INTERVAL)
    remines = [r[2] for rr in res.values() for r in rr]
    if remines != [want_remines] * 4:
        raise AssertionError(f"{label}: re-mines {remines} (eager, eager, graph, graph), "
                             f"not {want_remines} each")
    if reps != {"step": 2 * n, "remine": 2 * want_remines}:
        raise AssertionError(f"{label}: replays {reps} over two runs of {n} frames")
    caps = check_captures(jt, [key], per_fwd, remine_fwd, label)
    free_equal = all(np.array_equal(g[0], e[0]) for g in res["graph"] for e in res["eager"])
    tally, bitwise = graph_vs_eager(graph, frames, info, label)
    prof = {}
    for name, t in (("graph", graph), ("eager", eager)):
        t.initialize(frames[0], info)
        t.track(frames[1])
        prof[name] = profile_window(lambda i, t=t: t.track(frames[2 + i]), 16, "frame")
    # track_many: a chunk's frames in one upload, one read-back a chunk
    chunked = {}
    for name, t in (("graph", graph), ("eager", eager)):
        t.initialize(frames[0], info)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        many = t.track_many(frames[1:], chunk=32)
        chunked[name] = {"frames_per_s": n / (time.perf_counter() - t0),
                         "boxes_equal_track": bool(np.array_equal(many, res[name][0][0]))}
        if label == "B-BBOX":  # where the card waits within a chunk
            t.initialize(frames[0], info)
            chunked[name]["device_profile"] = profile_window(
                lambda i, t=t: t.track_many(frames[1:17], chunk=16), 1, "chunk_of_16")
    if not all(c["boxes_equal_track"] for c in chunked.values()):
        raise AssertionError(f"{label}: track_many's boxes differ from track's")
    attention.force_backend(None)
    out = {"phase": f"compiled_{label}", "mode": mode, "frames": n, "frame_hw": list(hw),
           "track_many_chunk32": chunked,
           "timer": COMPILED_TIMER,
           **{name: {**lat_stats(np.concatenate([r[1] for r in rr])),
                     "p50_ms_by_run": [float(np.percentile(r[1], 50) * 1e3) for r in rr],
                     "device_profile": prof[name]} for name, rr in res.items()},
           "bitwise_equal_frames": bitwise, "paired_graph_vs_eager": tally.summary(),
           "free_running_runs_bitwise_equal": free_equal, "remines": want_remines,
           "replays_over_two_runs": reps, "captured_launches": caps,
           "graphs_captured": captured, "capture_s": capture_s,
           "first_graph_run_s": first_run_s, "peak_mem_bytes": int(peak),
           "reserved_bytes": int(torch.cuda.memory_reserved())}
    emit(out)
    return out


def compiled_lockstep(label, cell, jt, per_fwd, remine_fwd) -> dict:
    """A LockstepCell's streams (S4, S8) through a BatchTracker on jt's
    graphs against one on the eager step, in turns; then each step from a
    shared state, every active row of the graph step against the eager debug
    step's (paired_ab's rule, and bitwise); re-mines as the eager path's."""
    import numpy as np
    import torch

    from uvltrack_tpu_torch.ops import attention
    from uvltrack_tpu_torch.track.batch import BatchTracker

    S, T = cell.S, cell.T
    graph = BatchTracker(cell.cfg, None, S, tokenizer=cell.tokenizer, jit_tracker=jt)
    eager = BatchTracker(cell.cfg, None, S, tokenizer=cell.tokenizer, jit_tracker=jt,
                         graphs=False)

    def init(bt):
        return bt.initialize(cell.frames0, cell.boxes0, languages=cell.languages,
                             modes=cell.modes)

    def run(bt):
        init(bt)
        torch.cuda.synchronize()
        lat, out = [], []
        for batch, active in zip(cell.batches, cell.actives):
            bt.set_active(active)
            t0 = time.perf_counter()
            out.append(bt.step(batch))
            lat.append(time.perf_counter() - t0)
        return np.stack(out), np.asarray(lat), bt.remines.tolist()

    attention.force_backend("cuda")
    n0, s0 = jt.graphs_captured, jt.capture_seconds
    run(graph)
    run(eager)
    captured, capture_s = jt.graphs_captured - n0, jt.capture_seconds - s0
    torch.cuda.reset_peak_memory_stats()
    res = turns(run, eager, graph)
    peak = torch.cuda.max_memory_allocated()
    frames_done = np.sum(cell.actives, axis=0)
    want = (frames_done // int(cell.cfg.TEST.UPDATE_INTERVAL)).tolist()
    for name, rr in res.items():
        for r in rr:
            if r[2] != want:
                raise AssertionError(f"{label} {name}: re-mines {r[2]}, not {want}")
    caps = check_captures(jt, [jt.graph_key(cell.frames0[0].shape[:2], S)], per_fwd,
                          remine_fwd, label)
    tally, bitwise, rows = AbTally(f"{label} graph/eager"), 0, 0
    init(graph)
    for batch, active in zip(cell.batches, cell.actives):
        graph.set_active(active)
        st = graph.state
        g = graph.step(batch)
        gm = graph.graph_maps().float().cpu().numpy()
        after = graph.state
        graph.state = st
        e, em = (t.float().cpu().numpy() for t in graph.step_async(batch, debug=True))
        e = e.astype(np.float64)
        graph.state = after
        for i in map(int, st.active.nonzero()[0]):
            crop = crop_side(st.box[i].tolist(), graph.search_factor)
            tally.add(e[i, :4], em[i, 2], g[i, :4], gm[i, 2], crop)
            bitwise += int(np.array_equal(g[i], e[i]))
            rows += 1
    prof = {}
    for name, bt in (("graph", graph), ("eager", eager)):
        init(bt)
        bt.step(cell.batches[0])
        prof[name] = profile_window(lambda j, bt=bt: bt.step(cell.batches[1 + j]),
                                    min(8, T - 1), "step")
    attention.force_backend(None)
    stream_frames = int(frames_done.sum())
    out = {"phase": f"compiled_{label}", "S": S, "steps": T, "modes": cell.modes,
           "timer": COMPILED_TIMER,
           **{name: {**lat_stats(np.concatenate([r[1] for r in rr]), "step"),
                     "stream_frames_per_s": stream_frames * len(rr)
                     / float(sum(r[1].sum() for r in rr)),
                     "p50_ms_by_run": [float(np.percentile(r[1], 50) * 1e3) for r in rr],
                     "device_profile": prof[name]} for name, rr in res.items()},
           "bitwise_equal_rows": bitwise, "rows": rows,
           "paired_graph_vs_eager": tally.summary(), "remines": want,
           "free_running_runs_bitwise_equal": all(
               np.array_equal(g[0], e[0]) for g in res["graph"] for e in res["eager"]),
           "captured_launches": caps, "graphs_captured": captured, "capture_s": capture_s,
           "peak_mem_bytes": int(peak)}
    emit(out)
    return out


def compiled_pool(cfg, jt, seqs, languages, tokenizer, per_fwd, remine_fwd) -> dict:
    """The pool cell's schedule (pool_schedule) on a StreamPool over jt's
    graphs against one on the eager step, in turns; then each round from a
    shared state, the graph step's active rows against the eager debug
    step's; re-mines by slot as the eager pool's."""
    import numpy as np
    import torch

    from uvltrack_tpu_torch.ops import attention
    from uvltrack_tpu_torch.track.pool import StreamPool

    cfg.TEST.MODE = "NLBBOX"

    def run(graphs):
        pool = StreamPool(cfg, None, 4, tokenizer=tokenizer, jit_tracker=jt, graphs=graphs)
        lat = []

        def on_round(p, pending):
            t0 = time.perf_counter()
            p.submit(pending)
            lat.append((time.perf_counter() - t0, len(pending)))

        pool_schedule(pool, seqs, languages, lambda do: do(), on_round)
        return np.asarray(lat), pool.bt.remines.tolist()

    attention.force_backend("cuda")
    n0, s0 = jt.graphs_captured, jt.capture_seconds
    run(True)
    run(False)
    captured, capture_s = jt.graphs_captured - n0, jt.capture_seconds - s0
    torch.cuda.reset_peak_memory_stats()
    res = turns(run, False, True)
    peak = torch.cuda.max_memory_allocated()
    remines = {name: [r[1] for r in rr] for name, rr in res.items()}
    if len({str(r) for rr in remines.values() for r in rr}) != 1:
        raise AssertionError(f"pool: re-mines by slot differ: {remines}")
    caps = check_captures(jt, [jt.graph_key(seqs[0][0][0].shape[:2], 4)], per_fwd, remine_fwd,
                          "pool")
    tally, bitwise, rows = AbTally("pool graph/eager"), 0, 0
    pool = StreamPool(cfg, None, 4, tokenizer=tokenizer, jit_tracker=jt)

    def checked(p, pending):
        nonlocal bitwise, rows
        (h, w), = {f.shape[:2] for f in pending.values()}
        batch = np.zeros((p.capacity, h, w, 3), np.uint8)
        active = np.zeros((p.capacity,), bool)
        for s, f in pending.items():
            batch[p.slot_of[s]], active[p.slot_of[s]] = f, True
        bt = p.bt
        bt.set_active(active)
        st = bt.state
        g = bt.step(batch)
        gm = bt.graph_maps().float().cpu().numpy()
        after = bt.state
        bt.state = st
        e, em = (t.float().cpu().numpy() for t in bt.step_async(batch, debug=True))
        e = e.astype(np.float64)
        bt.state = after
        for i in map(int, active.nonzero()[0]):
            tally.add(e[i, :4], em[i, 2], g[i, :4], gm[i, 2],
                      crop_side(st.box[i].tolist(), bt.search_factor))
            bitwise += int(np.array_equal(g[i], e[i]))
            rows += 1

    pool_schedule(pool, seqs, languages, lambda do: do(), checked)
    attention.force_backend(None)
    out = {"phase": "compiled_pool", "capacity": 4, "timer": COMPILED_TIMER,
           **{name: {"stream_frames_per_s": float(sum(r[0][:, 1].sum() for r in rr)
                                                  / sum(r[0][:, 0].sum() for r in rr)),
                     "submit_p50_ms": float(np.percentile(
                         np.concatenate([r[0][:, 0] for r in rr]), 50) * 1e3),
                     "submit_p90_ms": float(np.percentile(
                         np.concatenate([r[0][:, 0] for r in rr]), 90) * 1e3)}
              for name, rr in res.items()},
           "bitwise_equal_rows": bitwise, "rows": rows,
           "paired_graph_vs_eager": tally.summary(), "remines_by_slot": remines["graph"][0],
           "captured_launches": caps, "graphs_captured": captured, "capture_s": capture_s,
           "peak_mem_bytes": int(peak)}
    emit(out)
    return out


def shared_and_knob(cfg, model, jt, frames, boxes) -> dict:
    """A second Tracker on jt captures no graph, and its boxes equal a fresh
    Tracker's (its own JitTracker, its own captures); then
    UVLTRACK_FUSED_PREFIX=0 set after the capture gets a graph of its own,
    recording 12 qkv_attention launches and no ln_qkv."""
    from uvltrack_tpu_torch.ops import attention
    from uvltrack_tpu_torch.track.tracker import Tracker

    cfg.TEST.MODE = "BBOX"
    info = {"init_bbox": boxes[0]}
    attention.force_backend("cuda")
    second, fresh = Tracker(cfg, jit_tracker=jt), Tracker(cfg, model)
    n0 = jt.graphs_captured
    second.initialize(frames[0], info)
    got = [second.track(f) for f in frames[1:17]]
    if jt.graphs_captured != n0:
        raise AssertionError(f"a second Tracker captured {jt.graphs_captured - n0} graphs")
    fresh.initialize(frames[0], info)
    want = [fresh.track(f) for f in frames[1:17]]
    if got != want:
        raise AssertionError("the second Tracker's boxes differ from a fresh Tracker's")
    os.environ["UVLTRACK_FUSED_PREFIX"] = "0"
    try:
        key = jt.graph_key(frames[0].shape[:2], 1)
        second.track(frames[17])
        cap = jt.captured_launches(key)["step"]
    finally:
        del os.environ["UVLTRACK_FUSED_PREFIX"]
        attention.force_backend(None)
    if cap != {"qkv_attention[bf16]": 12}:
        raise AssertionError(f"UVLTRACK_FUSED_PREFIX=0 graph captured {cap}")
    out = {"phase": "compiled_shared", "second_tracker_frames": len(got),
           "second_tracker_new_graphs": 0, "boxes_equal_a_fresh_trackers": True,
           "fresh_tracker_graphs": fresh.jt.graphs_captured,
           "fused_prefix_off_graph_launches": cap, "graph_keys": [str(k) for k in jt.keys()]}
    emit(out)
    return out


def compiled_phase(model, cfg, model_q8, cfg_q8, tokenizer, language, frames, boxes, seqs,
                   per_fwd_fp, per_fwd_q8):
    """The compiled step (CUDA graphs through a shared JitTracker) against
    the eager step, in turns, cell by cell: B-BBOX, B-NLBBOX, B-NL,
    B-BBOX-Q8, lockstep S4 and S8 (the multistream phase's sequences) and
    the S=4 pool. Returns (the bf16 JitTracker, the int8 one)."""
    from uvltrack_tpu_torch.ops import attention
    from uvltrack_tpu_torch.track.tracker import JitTracker

    from uvltrack_tpu_torch.track.tracker import Tracker

    t0 = time.perf_counter()
    jt, jt_q8 = JitTracker(cfg, model), JitTracker(cfg_q8, model_q8)
    # what one eager re-mine launches (none: forward_prompt is the head's)
    cfg.TEST.MODE = "BBOX"
    probe = Tracker(cfg, jit_tracker=jt, graphs=False)
    probe.initialize(frames[0], {"init_bbox": boxes[0]})
    attention.force_backend("cuda")
    remine = eager_remine_launches(probe)
    attention.force_backend(None)
    summary = {}
    for label, mode in (("B-BBOX", "BBOX"), ("B-NLBBOX", "NLBBOX"), ("B-NL", "NL")):
        summary[label] = compiled_single(label, mode, cfg, jt, frames, boxes, tokenizer,
                                         language, per_fwd_fp, remine)
    summary["B-BBOX-Q8"] = compiled_single("B-BBOX-Q8", "BBOX", cfg_q8, jt_q8, frames, boxes,
                                           tokenizer, language, per_fwd_q8, remine)
    shared_and_knob(cfg, model, jt, frames, boxes)
    mix, langs = ["BBOX", "NLBBOX"] * 4, [language] * 8
    cells = [LockstepCell("S4", model, cfg, seqs, mix[:4], langs[:4], [33, 33, 25, 33],
                          tokenizer, per_fwd_fp),
             LockstepCell("S8", model, cfg, seqs, mix[:7] + ["NL"], langs,
                          [33, 33, 25] + [33] * 5, tokenizer, per_fwd_fp)]
    for cell in cells:
        summary[cell.label] = compiled_lockstep(cell.label, cell, jt, per_fwd_fp, remine)
    summary["pool"] = compiled_pool(cfg, jt, seqs, [None, language, language, None],
                                    tokenizer, per_fwd_fp, remine)
    emit({"phase": "compiled_summary", "seconds": time.perf_counter() - t0,
          "eager_remine_launches": remine,
          "graphs_captured": jt.graphs_captured + jt_q8.graphs_captured,
          "capture_s": jt.capture_seconds + jt_q8.capture_seconds,
          "graph_launches": graph_launches(jt, jt_q8),
          "fps_graph_over_eager": {k: v["graph"].get("frames_per_s", v["graph"].get(
              "stream_frames_per_s")) / v["eager"].get("frames_per_s", v["eager"].get(
                  "stream_frames_per_s")) for k, v in summary.items()}})
    return jt, jt_q8


# ------------------------------------------------------------------ serve
def serve_phase(cfg, jt, tokenizer, language, seqs) -> dict:
    """The port's HTTP service (cli/serve.py::make_server) in this process
    on 127.0.0.1, on the compiled step's JitTracker: per-stream, a BBOX and
    an NLBBOX stream (two servers of one JitTracker, so one device lock), 32
    720p frames each as "npy" bodies from two client threads; --lockstep 4,
    four streams (two with a sentence) for 24 rounds, each round's requests
    from four threads, stream C closed and reopened at round 12. Served
    boxes against a direct Tracker / StreamPool on the same JitTracker
    (bitwise); the --max_streams 429 and /close as tests/test_serve.py
    has them. Request latency on the client's clock."""
    import base64
    import io
    import threading
    import urllib.error
    import urllib.request

    import numpy as np

    from uvltrack_tpu_torch.cli.serve import make_server
    from uvltrack_tpu_torch.ops import attention
    from uvltrack_tpu_torch.track.pool import StreamPool
    from uvltrack_tpu_torch.track.tracker import Tracker

    def body(img):
        buf = io.BytesIO()
        np.save(buf, img)
        return base64.b64encode(buf.getvalue()).decode()

    def post(url, route, payload):
        req = urllib.request.Request(url + route, data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def start(proto, **kw):
        server = make_server(proto, "127.0.0.1", 0, **kw)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        return f"http://127.0.0.1:{server.server_address[1]}", server

    def stop(server):
        if server.dispatcher is not None:
            server.dispatcher.stop()
        server.shutdown()
        server.server_close()

    def timed_post(lat, url, route, payload):
        t0 = time.perf_counter()
        code, out = post(url, route, payload)
        lat.append(time.perf_counter() - t0)
        if code != 200:
            raise AssertionError(f"serve {route}: HTTP {code} {out}")
        return out

    t_phase = time.perf_counter()
    attention.force_backend("cuda")
    n0 = jt.graphs_captured
    cfgs = {m: cfg.clone() for m in ("BBOX", "NLBBOX")}
    for m, c in cfgs.items():
        c.TEST.MODE = m
    # per-stream: a BBOX server (at most one stream) and an NLBBOX server
    streams = {"cam_bbox": ("BBOX", 0, None), "cam_text": ("NLBBOX", 1, language)}
    servers = {m: start(Tracker(cfgs[m], tokenizer=tokenizer, jit_tracker=jt),
                        max_streams=1 if m == "BBOX" else 0) for m in cfgs}
    lat, results, errs = {s: [] for s in streams}, {s: [] for s in streams}, []
    for s, (m, i, lang) in streams.items():
        payload = {"stream": s, "image": body(seqs[i][0][0]), "format": "npy",
                   "bbox": seqs[i][1][0]}
        if lang:
            payload["language"] = lang
        timed_post([], servers[m][0], "/initialize", payload)
    bodies = {s: [body(f) for f in seqs[i][0][1:33]] for s, (_, i, _) in streams.items()}

    def client(s):
        try:
            for b in bodies[s]:
                results[s].append(timed_post(lat[s], servers[streams[s][0]][0], "/track",
                                             {"stream": s, "image": b, "format": "npy"}))
        except Exception as e:  # fails the phase below
            errs.append(f"{s}: {e}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(s,)) for s in streams]
    [t.start() for t in threads]
    [t.join() for t in threads]
    wall = time.perf_counter() - t0
    if errs:
        raise AssertionError(f"serve per-stream: {errs}")
    health = {m: json.loads(urllib.request.urlopen(u + "/health", timeout=60).read())
              for m, (u, _) in servers.items()}
    # the served boxes against a direct Tracker on the same JitTracker
    for s, (m, i, lang) in streams.items():
        direct = Tracker(cfgs[m], tokenizer=tokenizer, jit_tracker=jt)
        direct.initialize(seqs[i][0][0], {"init_bbox": seqs[i][1][0], "language": lang})
        for got, f in zip(results[s], seqs[i][0][1:33]):
            want = direct.track(f)
            if got["bbox"] != want["target_bbox"] or got["score"] != want["score"]:
                raise AssertionError(f"serve {s}: served box {got} != direct {want}")
    # admission and /close (tests/test_serve.py)
    url_b = servers["BBOX"][0]
    gates = {"429": post(url_b, "/initialize", {"stream": "extra", "image": bodies["cam_bbox"][0],
                                                "format": "npy", "bbox": seqs[0][1][0]})[0],
             "close": post(url_b, "/close", {"stream": "cam_bbox"})[0],
             "track_closed": post(url_b, "/track", {"stream": "cam_bbox",
                                                    "image": bodies["cam_bbox"][0],
                                                    "format": "npy"})[0],
             "admit_after_close": post(url_b, "/initialize", {
                 "stream": "extra", "image": bodies["cam_bbox"][0], "format": "npy",
                 "bbox": seqs[0][1][0]})[0]}
    if gates != {"429": 429, "close": 200, "track_closed": 404, "admit_after_close": 200}:
        raise AssertionError(f"serve admission/close: {gates}")
    for _, server in servers.values():
        stop(server)
    per_stream = {"streams": {s: lat_stats(v, "request") for s, v in lat.items()},
                  "request_p50_ms": float(np.percentile(sum(lat.values(), []), 50) * 1e3),
                  "request_p90_ms": float(np.percentile(sum(lat.values(), []), 90) * 1e3),
                  "served_frames_per_s": sum(map(len, results.values())) / wall,
                  "health": health, "gates": gates}

    # --lockstep 4: four streams, 24 rounds, C closed and reopened at round 12
    langs = {"A": None, "B": language, "C": language, "D": None}
    url, server = start(Tracker(cfgs["NLBBOX"], tokenizer=tokenizer, jit_tracker=jt),
                        lockstep=4, batch_window=1.0)
    direct = StreamPool(cfgs["NLBBOX"], None, 4, tokenizer=tokenizer, jit_tracker=jt)
    llat, served, wanted, sent = [], [], [], {}

    def open_(s, i, t):
        payload = {"stream": s, "image": body(seqs[i][0][t]), "format": "npy",
                   "bbox": seqs[i][1][t]}
        if langs[s]:
            payload["language"] = langs[s]
        timed_post([], url, "/initialize", payload)
        with jt.lock:
            direct.open(s, seqs[i][0][t], {"init_bbox": seqs[i][1][t], "language": langs[s]})
        sent[s] = t

    for i, s in enumerate("ABCD"):
        open_(s, i, 0)
    t0 = time.perf_counter()
    for r in range(24):
        if r == 12:
            code, _ = post(url, "/close", {"stream": "C"})
            with jt.lock:
                direct.close("C")
            if code != 200:
                raise AssertionError(f"lockstep /close: HTTP {code}")
            open_("C", 2, sent["C"])
        pending, out, errs = {}, {}, []
        for s in "ABCD":
            sent[s] += 1
            pending[s] = seqs["ABCD".index(s)][0][sent[s]]
        msgs = {s: body(f) for s, f in pending.items()}

        def go(s):
            try:
                out[s] = timed_post(llat, url, "/track", {"stream": s, "image": msgs[s],
                                                          "format": "npy"})
            except Exception as e:  # fails the phase below
                errs.append(f"{s}: {e}")

        threads = [threading.Thread(target=go, args=(s,)) for s in pending]
        [t.start() for t in threads]
        [t.join() for t in threads]
        if errs:
            raise AssertionError(f"serve lockstep round {r}: {errs}")
        served.append(out)
        with jt.lock:
            wanted.append(direct.submit(pending))
    lwall = time.perf_counter() - t0
    stop(server)
    attention.force_backend(None)
    for r, (got, want) in enumerate(zip(served, wanted)):
        for s in got:
            if got[s]["bbox"] != want[s]["bbox"] or got[s]["score"] != want[s]["score"]:
                raise AssertionError(f"serve lockstep round {r} {s}: {got[s]} != {want[s]}")
    out = {"phase": "serve", "timer": "client clock per HTTP request (npy body of a 720p "
           "frame, base64 JSON), from the request's start to its parsed reply",
           "per_stream": per_stream,
           "lockstep": {"S": 4, "rounds": 24, "requests": len(llat),
                        "request_p50_ms": float(np.percentile(llat, 50) * 1e3),
                        "request_p90_ms": float(np.percentile(llat, 90) * 1e3),
                        "served_frames_per_s": len(llat) / lwall,
                        "closed_and_reopened": "C at round 12"},
           "served_equal_direct": True, "new_graphs": jt.graphs_captured - n0,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    return out


# -------------------------------------------------------------------- eval
# the eval group's OTB99-layout dataset: 8 sequences of 720p frames, ragged
# (--streams freezes the short ones), each with a sentence
EVAL_LENGTHS = (32, 48, 36, 44, 40, 34, 46, 38)
EVAL_WORDS = ("the", "red", "checkered", "box", "moving", "left", "right", "target", "small",
              "textured", "patch", "on", "a", "busy", "background")
# UVLTrack-L's launches per backbone forward: 12 visual blocks (bf16 stream)
# and 12 joint blocks (fp32 stream) through kernel #1, every block through #2
L_PER_FWD = {"ln_qkv[bf16x-bf16w]": 12, "ln_qkv[fp32x-bf16w]": 12, "qkv_attention[bf16]": 24}
EVAL_TIMER = ("host clock: runner FPS as the CLI prints it (frames over the summed sequence "
              "times, decode overlapped by the prefetcher at S=1, inline at S>1); step p50/p90 "
              "of the direct replay of the same run (Tracker.track / BatchTracker.step on the "
              "CLI's JitTracker, frames decoded beforehand)")
def write_eval_dataset(root: Path, seed: int, lengths=EVAL_LENGTHS) -> dict:
    """An OTB99-layout dataset under root/otb99 (OTB_videos/<seq>/
    {groundtruth_rect.txt,img/%04d.jpg}, OTB_query_test/<seq>.txt) of
    720p sequences of `lengths` frames from synthetic_sequence, each with a
    sentence; and a GOT-10k test split under root/got10k (3 sequences of 8
    frames, a one-row ground truth: server-evaluated). Returns the writer's
    name and seconds."""
    import cv2
    import numpy as np

    def write(path, rgb):
        if not cv2.imwrite(str(path), np.ascontiguousarray(rgb[..., ::-1]),
                           [cv2.IMWRITE_JPEG_QUALITY, 90]):
            raise IOError(f"cv2 could not write {path}")

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 100)
    otb = root / "otb99"
    (otb / "OTB_query_test").mkdir(parents=True)
    for i, n in enumerate(lengths):
        name = f"Seq{i:02d}"
        frames, boxes = synthetic_sequence(n - 1, seed + 40 + i, phase=7 * i)
        img = otb / "OTB_videos" / name / "img"
        img.mkdir(parents=True)
        for t, f in enumerate(frames):
            write(img / f"{t + 1:04d}.jpg", f)
        np.savetxt(otb / "OTB_videos" / name / "groundtruth_rect.txt", boxes, delimiter=",",
                   fmt="%.1f")
        words = rng.choice(EVAL_WORDS, size=5 + i % 3)
        (otb / "OTB_query_test" / f"{name}.txt").write_text(" ".join(words) + "\n")
    got = root / "got10k" / "test"
    names = [f"GOT-10k_Test_{i:06d}" for i in (1, 2, 3)]
    got.mkdir(parents=True)
    (got / "list.txt").write_text("\n".join(names) + "\n")
    for i, name in enumerate(names):
        frames, boxes = synthetic_sequence(7, seed + 60 + i, phase=5 * i)
        (got / name).mkdir()
        for t, f in enumerate(frames):
            write(got / name / f"{t + 1:08d}.jpg", f)
        np.savetxt(got / name / "groundtruth.txt", boxes[:1], delimiter=",", fmt="%.4f")
    return {"jpeg_writer": f"cv2 {cv2.__version__}", "write_s": time.perf_counter() - t0}


def cli_run(label: str, argv, results: Path, expect: dict) -> dict:
    """uvltrack_tpu_torch.cli.test.main(argv) in this process, its stdout
    captured; the Tracker the CLI builds is kept (build_tracker wrapped).
    The launch counts are set to 0 just before and read just after: the
    wrappers' eager calls (initialize's forwards, each graph's warm-up)
    and the graphs' (captured calls x replays). Fails if a run printed an
    error, or if an instantiation of `expect` never launched. Returns
    {proto, out, results_dir, launches, graph_launches, seconds}."""
    import contextlib
    import io

    from uvltrack_tpu_torch.cli import test as cli_test
    from uvltrack_tpu_torch.ops import build

    built, orig = [], cli_test.build_tracker

    def keep(*a, **kw):
        built.append(orig(*a, **kw))
        return built[-1]

    cli_test.build_tracker = keep
    buf = io.StringIO()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            cli_test.main(argv)
    finally:
        cli_test.build_tracker = orig
    seconds = time.perf_counter() - t0
    out = buf.getvalue()
    eager, graph = build.instantiation_counts(), graph_launches(built[0].jt)
    if "ERROR" in out or "failed" in out or "Traceback" in out:
        raise AssertionError(f"{label}: the run reported a failure:\n{out[-2000:]}")
    idle = [k for k in expect if eager.get(k, 0) + graph.get(k, 0) == 0]
    if idle:
        raise AssertionError(f"{label}: {idle} never launched (eager {eager}, graphs {graph})")
    return {"proto": built[0], "out": out, "seconds": seconds, "launches": eager,
            "graph_launches": graph}


def runner_fps(out: str) -> float:
    """The overall frames/s the runner printed last ("overall X FPS" or
    "X FPS aggregate")."""
    import re

    m = re.findall(r"([0-9.]+) FPS", out)
    if not m:
        raise AssertionError(f"no FPS line in the runner's output:\n{out[-1000:]}")
    return float(m[-1])


class Decoded(dict):
    """Each sequence's frames through the runner's decoder (native libjpeg,
    cv2 where it did not build), decoded once for all the direct runs:
    self(seq) -> (frames, host ms a frame the decode took)."""

    def __call__(self, seq) -> tuple:
        from uvltrack_tpu_torch.native import imread_rgb

        if seq.name not in self:
            t0 = time.perf_counter()
            frames = [imread_rgb(f) for f in seq.frames]
            self[seq.name] = frames, (time.perf_counter() - t0) * 1e3 / len(frames)
        return self[seq.name]


def direct_single(proto, seqs, results: Path, decoded: Decoded) -> dict:
    """Each sequence through a Tracker on the CLI's JitTracker, frame by
    frame (track), from the same decoded frames; its result files written
    by the runners' save_results. Returns the step latencies and decode ms."""
    import numpy as np
    import torch

    from uvltrack_tpu_torch.eval.running import save_results
    from uvltrack_tpu_torch.track.tracker import Tracker

    t = Tracker(proto.cfg, tokenizer=proto.tokenizer, jit_tracker=proto.jt)
    lat, dec = [], []
    for seq in seqs:
        frames, ms = decoded(seq)
        dec.append(ms)
        boxes = [t.initialize(frames[0], seq.init_info())["target_bbox"]]
        torch.cuda.synchronize()
        for f in frames[1:]:
            t0 = time.perf_counter()
            boxes.append(t.track(f)["target_bbox"])
            lat.append(time.perf_counter() - t0)
        save_results(str(results), seq.name, np.asarray(boxes, np.float64),
                     np.zeros(len(boxes)))
    return {"lat": lat, "decode_ms_per_frame": float(np.mean(dec))}


def direct_batched(proto, seqs, S: int, results: Path, decoded: Decoded) -> dict:
    """The lockstep runner's groups (S sequences at a time, in dataset
    order: one resolution) through a BatchTracker on the CLI's JitTracker,
    from the same decoded frames: initialize from each first frame and
    ground-truth box with its sentence, then a step a frame index with the
    finished streams frozen and fed their first frame (run_dataset_batched's
    rule). Returns the step latencies."""
    import numpy as np
    import torch

    from uvltrack_tpu_torch.eval.running import save_results
    from uvltrack_tpu_torch.track.batch import BatchTracker

    bts, lat = {}, []
    for g in range(0, len(seqs), S):
        group = seqs[g:g + S]
        n = len(group)
        if n not in bts:
            bts[n] = BatchTracker(proto.cfg, None, n, tokenizer=proto.tokenizer,
                                  jit_tracker=proto.jt)
        bt = bts[n]
        frames = [decoded(s)[0] for s in group]
        boxes0 = np.stack([np.asarray(s.ground_truth_rect[0], np.float32) for s in group])
        init = bt.initialize([f[0] for f in frames], boxes0, languages=[s.language for s in group])
        outs = [[list(np.asarray(init[i], np.float64))] for i in range(n)]
        torch.cuda.synchronize()
        for k in range(1, max(len(f) for f in frames)):
            active = np.array([k < len(f) for f in frames])
            rows = np.stack([f[k] if k < len(f) else f[0] for f in frames])
            bt.set_active(active)
            t0 = time.perf_counter()
            packed = bt.step(rows)
            lat.append(time.perf_counter() - t0)
            for i in np.flatnonzero(active):
                outs[i].append(packed[i, :4].tolist())
        for i, s in enumerate(group):
            save_results(str(results), s.name, np.asarray(outs[i], np.float64),
                         np.zeros(len(outs[i])))
    return {"lat": lat}


def same_files(label: str, cli_dir: Path, direct_dir: Path, seqs) -> int:
    """The CLI's <seq>.txt files byte for byte the direct run's; each a
    finite (n, 4) box list. Returns the number of files."""
    import numpy as np

    for s in seqs:
        got = (cli_dir / f"{s.name}.txt").read_bytes()
        if got != (direct_dir / f"{s.name}.txt").read_bytes():
            raise AssertionError(f"{label}: {s.name}.txt differs from the direct run's")
        boxes = np.loadtxt(cli_dir / f"{s.name}.txt", delimiter="\t", ndmin=2)
        if boxes.shape != (len(s.frames), 4) or not np.isfinite(boxes).all():
            raise AssertionError(f"{label}: {s.name}.txt holds {boxes.shape}")
    return len(seqs)


def large_checks(proto, seq, frames) -> dict:
    """UVLTrack-L on the CLI's JitTracker: L_PER_FWD launches per eager
    forward and in the step graph; the kernel path against the plain path
    frame by frame from a shared state (paired_ab); the graph step against
    the eager debug step from a shared state, every box bitwise; a profiler
    window of 16 frames."""
    import torch

    from uvltrack_tpu_torch.ops import attention, build
    from uvltrack_tpu_torch.track.tracker import Tracker

    jt, info = proto.jt, seq.init_info()
    key = jt.graph_key(frames[0].shape[:2], 1)
    cap = jt.captured_launches(key)
    if cap["step"] != L_PER_FWD or cap["remine"]:
        raise AssertionError(f"L: the step graph captured {cap}, not {L_PER_FWD}")
    eager = Tracker(proto.cfg, tokenizer=proto.tokenizer, jit_tracker=jt, graphs=False)
    eager.initialize(frames[0], info)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    eager.track(frames[1])
    torch.cuda.synchronize()
    if build.instantiation_counts() != L_PER_FWD:
        raise AssertionError(f"L: an eager forward launched {build.instantiation_counts()}")
    ab = paired_ab(eager, frames[:17], info)
    graph = Tracker(proto.cfg, tokenizer=proto.tokenizer, jit_tracker=jt)
    attention.force_backend("cuda")
    tally, bitwise = graph_vs_eager(graph, frames, info, "L")
    attention.force_backend(None)
    if bitwise != len(frames) - 1:
        raise AssertionError(f"L: {bitwise} of {len(frames) - 1} graph boxes bitwise the "
                             "eager step's")
    graph.initialize(frames[0], info)
    graph.track(frames[1])
    prof = profile_window(lambda i: graph.track(frames[2 + i]), 16, "frame")
    return {"paired_kernel_vs_plain": ab, "paired_graph_vs_eager": tally.summary(),
            "graph_bitwise_equal_frames": bitwise, "captured_launches": cap,
            "device_profile": prof}


def large_lockstep_checks(proto, seqs, decoded: Decoded) -> dict:
    """UVLTrack-L at S=L_STREAMS: a BatchTracker on the graphs against one
    on the eager step, the same 16 steps of the first L_STREAMS sequences
    (all active), every step's boxes bitwise; a profiler window of 8 steps."""
    import numpy as np

    from uvltrack_tpu_torch.track.batch import BatchTracker

    group = seqs[:L_STREAMS]
    frames = [decoded(s)[0][:25] for s in group]
    boxes0 = np.stack([np.asarray(s.ground_truth_rect[0], np.float32) for s in group])
    langs = [s.language for s in group]
    outs = []
    for graphs in (False, True):
        bt = BatchTracker(proto.cfg, None, L_STREAMS, tokenizer=proto.tokenizer,
                          jit_tracker=proto.jt, graphs=graphs)
        bt.initialize([f[0] for f in frames], boxes0, languages=langs)
        outs.append(np.stack([bt.step(np.stack([f[k] for f in frames])) for k in range(1, 17)]))
    if not np.array_equal(outs[0], outs[1]):
        raise AssertionError("L S=8: the graph steps' boxes differ from the eager steps'")
    prof = profile_window(lambda i: bt.step(np.stack([f[17 + i] for f in frames])), 8, "step")
    return {"steps_bitwise_equal": 16, "device_profile": prof}


def eval_phase(args, vocab: Path, tmp: Path) -> dict:
    """The `eval` group: cli.test.main over a synthetic OTB99 dataset in
    five runs (B: BBOX --chunk 16, NLBBOX --streams 4, --quant int8; L:
    BBOX, NLBBOX --streams 8), each run's result files bitwise against a
    direct run on its JitTracker; L's launches, kernel-vs-plain and
    graph-vs-eager; analyze on runs a and d; the server-split message and
    pack. Returns {"launches", "graph_launches"} summed over the runs."""
    import numpy as np
    import torch

    from uvltrack_tpu_torch import native
    from uvltrack_tpu_torch.cli import analyze as cli_analyze
    from uvltrack_tpu_torch.cli import pack as cli_pack
    from uvltrack_tpu_torch.eval import environment, get_dataset
    from uvltrack_tpu_torch.track.tracker import frame_cost

    t_group = time.perf_counter()
    decoder = ("native libjpeg (uvltrack_tpu_torch/native)" if native.load_library() is not None
               else "cv2 (the native libjpeg decoder did not build)")
    ds_info = write_eval_dataset(tmp, args.seed)
    decoded = Decoded()
    results = tmp / "results"
    os.environ.update({"UVLTRACK_REPO": str(REPO), "UVLTRACK_OTB99_PATH": str(tmp / "otb99"),
                       "UVLTRACK_GOT10K_PATH": str(tmp / "got10k"),
                       "UVLTRACK_RESULTS_PATH": str(results)})
    environment.reset_env_cache()
    seqs = list(get_dataset("otb99"))
    emit({"phase": "eval_dataset", "sequences": len(seqs),
          "frames": [len(s.frames) for s in seqs], "frame_hw": [720, 1280],
          "layout": "OTB99 (OTB_videos/<seq>/img/%04d.jpg, OTB_query_test/<seq>.txt)",
          "decoder": decoder, **ds_info})
    common = ["--dataset_name", "otb99", "--set", "TEST.THRESHOLD=-1",
              "--set", f"MODEL.BACKBONE.LANGUAGE.VOCAB_PATH={vocab}"]
    q8 = {"ln_qkv[bf16x-int8w]": 6, "ln_qkv[fp32x-int8w]": 6, "qkv_attention[bf16]": 6,
          "qkv_attention[fp32]": 6}
    b_fwd = {"ln_qkv[bf16x-bf16w]": 6, "ln_qkv[fp32x-bf16w]": 6, "qkv_attention[bf16]": 12}
    runs = [  # (label, param, extra args, report dir, streams, launches per forward)
        ("a_B_BBOX_chunk16", "baseline_base", ["--set", "TEST.MODE=BBOX", "--chunk", "16"],
         "baseline_base/otb99_BBOX_0300", 1, b_fwd),
        ("b_B_NLBBOX_S4", "baseline_base", ["--set", "TEST.MODE=NLBBOX", "--streams", "4"],
         "baseline_base/otb99_NLBBOX_0300", 4, b_fwd),
        ("c_B_BBOX_int8", "baseline_base", ["--set", "TEST.MODE=BBOX", "--quant", "int8",
                                            "--runid", "3"],
         "baseline_base_003/otb99_BBOX_0300", 1, q8),
        ("d_L_BBOX", "baseline_large", ["--set", "TEST.MODE=BBOX"],
         "baseline_large/otb99_BBOX_0300", 1, L_PER_FWD),
        ("e_L_NLBBOX_S8", "baseline_large", ["--set", "TEST.MODE=NLBBOX", "--streams",
                                             str(L_STREAMS)],
         "baseline_large/otb99_NLBBOX_0300", L_STREAMS, L_PER_FWD),
    ]
    launches, glaunch = {}, {}
    for label, param, extra, report, S, per_fwd in runs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run = cli_run(label, ["uvltrack", param] + common + extra, results, per_fwd)
        peak = torch.cuda.max_memory_allocated()
        proto, out = run["proto"], run["out"]
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v
        for k, v in run["graph_launches"].items():
            glaunch[k] = glaunch.get(k, 0) + v
        direct_dir = tmp / "direct" / label
        if S == 1:
            d = direct_single(proto, seqs, direct_dir, decoded)
        else:
            d = direct_batched(proto, seqs, S, direct_dir, decoded)
            d["decode_ms_per_frame"] = float(np.mean([decoded(s)[1] for s in seqs]))
        files = same_files(label, results / "uvltrack" / report, direct_dir, seqs)
        scores = [line for line in out.splitlines() if "AUC=" in line]
        if len(scores) != 1:
            raise AssertionError(f"{label}: no score line in the CLI's output")
        lat = np.asarray(d["lat"])
        rec = {"phase": f"eval_{label}", "argv": extra, "timer": EVAL_TIMER,
               "runner_fps": runner_fps(out), "cli_seconds": run["seconds"],
               "decode_ms_per_frame": d["decode_ms_per_frame"],
               "step_ms_p50": float(np.percentile(lat, 50) * 1e3),
               "step_ms_p90": float(np.percentile(lat, 90) * 1e3),
               "direct_frames_per_s": (S if S > 1 else 1) * len(lat) / float(lat.sum()),
               "result_files_bitwise_direct": files, "scores": scores[0].split(": ", 1)[-1],
               "launches": run["launches"], "graph_launches": run["graph_launches"],
               "peak_mem_bytes": int(peak), "capture_s": proto.jt.capture_seconds,
               "graphs_captured": proto.jt.graphs_captured}
        if param == "baseline_large":
            nt = int(proto.cfg.MODEL.BACKBONE.LANGUAGE.BERT.MAX_QUERY_LEN)
            rec.update({"params": sum(p.numel() for p in proto.model.parameters()),
                        **frame_work(proto.model, nt),
                        "frame_cost_gflops": frame_cost(proto.model, nt)["flops"] / 1e9})
            if S == 1:
                rec["large"] = large_checks(proto, seqs[0], decoded(seqs[0])[0])
            else:
                rec["large"] = large_lockstep_checks(proto, seqs, decoded)
        emit(rec)
        del run, proto
        torch.cuda.empty_cache()
    # analyze on runs a and d: the per-sequence table into a file, and the scores
    for label, param, mode in (("a", "baseline_base", "BBOX"), ("d", "baseline_large", "BBOX")):
        import contextlib
        import io

        save = tmp / f"analyze_{label}.txt"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli_analyze.main(["--tracker_param", param, "--mode", mode, "--per_seq",
                              "--save_file", str(save)])
            cli_analyze.main(["--tracker_param", param, "--mode", mode])
        table = save.read_text()
        rows = [s.name for s in seqs if f"\n{s.name} " in table]
        if len(rows) != len(seqs) or "AUC=" not in buf.getvalue():
            raise AssertionError(f"analyze {label}: {len(rows)} sequence rows, output "
                                 f"{buf.getvalue()[-500:]}")
        emit({"phase": f"eval_analyze_{label}", "per_seq_rows": len(rows),
              "scores": buf.getvalue().strip().splitlines()[-1]})
    # the server-evaluated split: no local score, the pack CLI named; then pack
    run = cli_run("got10k_split", ["uvltrack", "baseline_base", "--dataset_name", "got10k_test",
                                   "--set", "TEST.MODE=BBOX"], results, b_fwd)
    if "cannot score locally" not in run["out"] or \
            "python -m uvltrack_tpu_torch.cli.pack" not in run["out"] or "AUC=" in run["out"]:
        raise AssertionError(f"got10k_test: no server-split message:\n{run['out'][-800:]}")
    for k, v in run["launches"].items():
        launches[k] = launches.get(k, 0) + v
    for k, v in run["graph_launches"].items():
        glaunch[k] = glaunch.get(k, 0) + v
    del run
    import contextlib
    import io
    import zipfile

    with contextlib.redirect_stdout(io.StringIO()):
        cli_pack.main(["got10k", "--tracker_param", "baseline_base", "--dataset_name",
                       "got10k_test", "--mode", "BBOX", "--out_dir", str(tmp / "submit")])
    with zipfile.ZipFile(tmp / "submit" / "uvltrack_baseline_base_got10k_test.zip") as z:
        members = sorted(n for n in z.namelist() if n.endswith("_001.txt"))
    want = [f"GOT-10k_Test_{i:06d}/GOT-10k_Test_{i:06d}_001.txt" for i in (1, 2, 3)]
    if members != want:
        raise AssertionError(f"pack: {members}, not {want}")
    torch.cuda.empty_cache()
    emit({"phase": "eval_server_split", "message": "named the pack CLI", "zip_files": members,
          "group_seconds": time.perf_counter() - t_group})
    return {"launches": launches, "graph_launches": glaunch}


def box_iou(a, b) -> float:
    """IoU of two [x, y, w, h] boxes."""
    iw = max(0.0, min(a[0] + a[2], b[0] + b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[1] + a[3], b[1] + b[3]) - max(a[1], b[1]))
    inter = iw * ih
    return inter / (a[2] * a[3] + b[2] * b[3] - inter)


# ------------------------------------------------------------------ train
TRAIN_B = 16  # rows of the train forward: TRAIN.BATCH_SIZE 8 x DATA.SEARCH.NUMBER 2
# the Functions' forward tolerance (the KERNEL_* rule), at their outputs' scale:
# the attention output as #1/#2's, x + proj as the post-residual stream, the MLP's
TRAIN_ATOL = {"LnQkvAttention": KERNEL_ATOL["ln_qkv_attention"],
              "QkvAttention": KERNEL_ATOL["qkv_attention"],
              "LnQkvAttnProj": Q8_KERNEL_ATOL["proj_residual"],
              "LnMlp": KERNEL_ATOL["ln_mlp"]}
# kernel vs plain gradients from the same saved inputs and cotangent: the same
# recompute, so bitwise expected; gated at 1e-3 of each input's largest |g|
TRAIN_GRAD_REL = 1e-3
# launches a train step makes (one forward at the default knobs; the
# backward recomputes the plain versions and launches nothing)
TRAIN_PER_FWD = {"ln_qkv[bf16x-bf16w]": 6, "ln_qkv[fp32x-bf16w]": 6, "qkv_attention[bf16]": 12}
TRAIN_KNOBS = (
    ("UVLTRACK_FUSED_PROJ", "1", dict(TRAIN_PER_FWD, **{"proj_residual[bf16x-bf16a-bf16w]": 6,
                                                        "proj_residual[fp32x-bf16a-bf16w]": 6})),
    ("UVLTRACK_FUSED_MLP", "1", dict(TRAIN_PER_FWD, **{"ln_mlp[bf16x-bf16w]": 6,
                                                       "ln_mlp[fp32x-bf16w]": 6})),
    ("UVLTRACK_FUSED_PREFIX", "0", {"qkv_attention[bf16]": 12}))
# B-TRAIN's gate, kernel backend against plain from one init, step 1: the loss
# within 1% (bf16 rounding of 12 blocks' attention); grad_norm within 5%, or
# within twice the plain backend's own move when its search images change by
# 2^-12 relative (TRAIN_PROBE_EPS, 16x under one bf16 rounding step), if that
# is larger: the losses supervise one argmax-selected box a row, and where two
# cells nearly tie (random weights) either backend's rounding flips the
# selection and reroutes the box losses' gradient (measured on an H100 at
# seed 0: one row of 16 flips either way, the plain backend's grad_norm moves
# 9.6% under the 2^-12 change, and the kernels' is 10.7% from plain's)
TRAIN_LOSS_REL, TRAIN_NORM_REL, TRAIN_PROBE_EPS = 1e-2, 5e-2, 2.0 ** -12
TRAIN_TIMER = ("host clock per train_step (forward, backward, clip, AdamW on fp32 master "
               "parameters), each ending in a read of its loss; p50 over steps 2-6")


def function_phase(dev, seed: int) -> dict:
    """(a) The four autograd Functions at B=16, C=768, H=12, N=321 (bf16 x)
    and N=361 (fp32 x; #2's qkv is bf16 at both, as the model makes it),
    3 masks: the kernel forward against the plain version (TRAIN_ATOL +
    KERNEL_RTOL), and every input's gradient against torch.autograd.grad of
    the plain version from the same inputs and cotangent."""
    import numpy as np
    import torch

    from uvltrack_tpu_torch.ops import autograd as ag
    from uvltrack_tpu_torch.ops import ln_mlp as lm
    from uvltrack_tpu_torch.ops import ln_qkv_attention as lqa
    from uvltrack_tpu_torch.ops import ln_qkv_attn_proj as lqp

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    c, heads = 768, 12

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)

    def w(o, i):
        return t(rng.normal(size=(o, i)) / np.sqrt(i), torch.bfloat16)

    plain = {"LnQkvAttention": lqa.ln_qkv_attention_plain, "QkvAttention": lqa.qkv_attention_plain,
             "LnQkvAttnProj": lqp.ln_qkv_attn_proj_plain, "LnMlp": lm.ln_mlp_plain}
    worst = {k: 0.0 for k in plain}
    worst_grad = {k: 0.0 for k in plain}
    bitwise, grads = 0, 0
    for n, x_dtype in ((321, torch.bfloat16), (361, torch.float32)):
        for kind in ("flag0", "flag2", "open"):
            x = t(rng.normal(size=(TRAIN_B, n, c)), x_dtype)
            g, be = t(1 + 0.1 * rng.normal(size=c)), t(0.1 * rng.normal(size=c))
            wq, bq = w(3 * c, c), t(0.02 * rng.normal(size=3 * c))
            wp, bp = w(c, c), t(0.02 * rng.normal(size=c))
            w1, b1 = w(4 * c, c), t(0.02 * rng.normal(size=4 * c))
            w2, b2 = w(c, 4 * c), t(0.02 * rng.normal(size=c))
            kb = t(np.where(key_masks(TRAIN_B, n, kind, rng), -1e10, 0.0))
            cases = {"LnQkvAttention": ((x, g, be, wq, bq, kb), (heads, 1e-6)),
                     "QkvAttention": ((lqa.ln_qkv_plain(x, g, be, wq, bq), kb), (heads,)),
                     "LnQkvAttnProj": ((x, g, be, wq, bq, wp, bp, kb), (heads, 1e-6)),
                     "LnMlp": ((x, g, be, w1, b1, w2, b2), (1e-6,))}
            for name, (inputs, static) in cases.items():
                kin = [a.detach().clone().requires_grad_(True) for a in inputs]
                pin = [a.detach().clone().requires_grad_(True) for a in inputs]
                out = getattr(ag, name).apply(*kin, *static)
                ref = plain[name](*pin, *static)
                d = (out.detach().float() - ref.detach().float()).abs()
                if not bool((d <= TRAIN_ATOL[name] + KERNEL_RTOL * ref.float().abs()).all()):
                    raise AssertionError(f"{name} N={n} mask={kind}: forward max abs err "
                                         f"{float(d.max())} over tolerance")
                worst[name] = max(worst[name], float(d.max()))
                ct = torch.randn(out.shape, generator=gen, device=dev).to(out.dtype)
                for a, b in zip(torch.autograd.grad(out, kin, ct),
                                torch.autograd.grad(ref, pin, ct)):
                    grads += 1
                    bitwise += int(torch.equal(a, b))
                    rel = float((a.float() - b.float()).abs().max()
                                / b.float().abs().max().clamp_min(1e-30))
                    if rel > TRAIN_GRAD_REL:
                        raise AssertionError(f"{name} N={n} mask={kind}: a gradient differs "
                                             f"from the plain recompute's by {rel} of its max")
                    worst_grad[name] = max(worst_grad[name], rel)
    torch.cuda.synchronize()
    out = {"phase": "train_functions", "B": TRAIN_B, "C": c, "heads": heads,
           "grid": "N=321 bf16 x, N=361 fp32 x (#2: bf16 qkv) x 3 masks",
           "forward_tolerance": {k: f"|kernel-plain| <= {a} + {KERNEL_RTOL}*|plain|"
                                 for k, a in TRAIN_ATOL.items()},
           "forward_max_abs_err": worst, "grad_max_rel_err": worst_grad,
           "grads_bitwise": f"{bitwise}/{grads}"}
    emit(out)
    return out


def train_config(**over):
    """baseline_base.yaml as B-TRAIN runs it, with `over` (KEY=value) set."""
    from uvltrack_tpu_torch.config import load_cfg

    cfg = load_cfg(str(REPO / "experiments/uvltrack/baseline_base.yaml"))
    cfg.merge_from_list([f"{k}={v}" for k, v in over.items()])
    return cfg


def launches_since(before: dict) -> dict:
    """Launches per instantiation since the counts `before` were read."""
    from uvltrack_tpu_torch.ops import build

    now = build.instantiation_counts()
    return {k: v - before.get(k, 0) for k, v in now.items() if v > before.get(k, 0)}


def _train_run(state, step, batch, backend: str, n: int, per_fwd=None, forwards: int = 1):
    """n steps on `backend` ("cuda" kernels or "plain"): per step the host
    ms, loss, grad_norm and, on the kernels, launches checked against
    per_fwd x forwards (TRAIN_PER_FWD by default)."""
    import numpy as np
    import torch

    from uvltrack_tpu_torch.ops import attention, build

    out = []
    attention.force_backend(backend)
    try:
        for _ in range(n):
            before = build.instantiation_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            loss = float(m["Loss/total"])
            out.append({"ms": (time.perf_counter() - t0) * 1e3, "loss": loss,
                        "grad_norm": float(m["grad_norm"])})
            got = launches_since(before)
            if backend == "cuda":
                expect_launches(per_fwd or TRAIN_PER_FWD, forwards, got, "train step")
            elif got:
                raise AssertionError(f"plain train step launched {got}")
            if not (np.isfinite(loss) and np.isfinite(out[-1]["grad_norm"])):
                raise AssertionError(f"train step on {backend}: loss {loss}, {out[-1]}")
    finally:
        attention.force_backend(None)
    return state, out


def _probe(model, batch, cfg, backend: str, eps: float = 0.0, seed: int = 0) -> dict:
    """One forward and backward of the train loss from the model's current
    state, no update (BN running stats and gradients restored): loss,
    grad_norm and each row's supervised cell (the argmax of cls x cont that
    selects pred_boxes); eps > 0 scales the search images by 1 + eps * N(0, 1)."""
    import torch

    from uvltrack_tpu_torch.core.geometry import anno2mask, rotate_half_batch
    from uvltrack_tpu_torch.ops import attention
    from uvltrack_tpu_torch.train.actor import flatten_batch, forward_and_loss
    from uvltrack_tpu_torch.train.optim import global_norm

    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    stats = [(m.running_mean.clone(), m.running_var.clone()) for m in bns]
    b = dict(batch)
    if eps:
        gen = torch.Generator(device=b["search_images"].device).manual_seed(seed)
        b["search_images"] = b["search_images"] * (1 + eps * torch.randn(
            b["search_images"].shape, generator=gen, device=gen.device))
    attention.force_backend(backend)
    try:
        fb = flatten_batch(b)
        ws, wt = fb["search_images"].shape[2] // 16, fb["template_images"].shape[2] // 16
        with torch.no_grad():
            out = model(fb["template_images"], fb["search_images"], fb["text"], fb["text_mask"],
                        anno2mask(fb["template_anno"], wt),
                        rotate_half_batch(anno2mask(fb["search_anno"], ws)), fb["flag"],
                        train=True)
            cells = torch.argmax(out["cls_score"] * torch.softmax(
                out["cont_score"].float(), -1)[:, :, 0], -1).tolist()
        for p in model.parameters():
            p.grad = None
        loss, _ = forward_and_loss(model, b, cfg, train=True)
        loss.backward()
        norm = float(global_norm([p.grad for p in model.parameters()]))
    finally:
        attention.force_backend(None)
        for p in model.parameters():
            p.grad = None
        for m, (rm, rv) in zip(bns, stats):
            m.running_mean.copy_(rm)
            m.running_var.copy_(rv)
    return {"loss": float(loss), "grad_norm": norm, "cells": cells}


def gate_probes(k_model, p_model, batch, cfg, seed: int, counted):
    """The step-1 gate's yardstick from a shared init: the probes (plain,
    plain under the 2^-12 input change, kernels), the plain backend's own
    relative grad_norm move, the grad_norm bound max(TRAIN_NORM_REL, 2 x
    that move) and the supervised cells that differ from plain's."""
    probes = {"plain": _probe(p_model, batch, cfg, "plain"),
              "plain_eps": _probe(p_model, batch, cfg, "plain", TRAIN_PROBE_EPS, seed),
              "cuda": counted(lambda: _probe(k_model, batch, cfg, "cuda"))}
    sens = abs(probes["plain_eps"]["grad_norm"] - probes["plain"]["grad_norm"]) / probes[
        "plain"]["grad_norm"]
    flips = {k: sum(a != b for a, b in zip(probes[k]["cells"], probes["plain"]["cells"]))
             for k in ("plain_eps", "cuda")}
    return probes, sens, max(TRAIN_NORM_REL, 2 * sens), flips


def step1_gate(k1: dict, p1: dict, norm_bound: float, what: str):
    """Step 1 on the kernels (k1) against plain (p1), from one init: the
    loss within TRAIN_LOSS_REL and grad_norm within norm_bound (relative);
    returns (loss_rel, grad_norm_rel)."""
    loss_rel = abs(k1["loss"] - p1["loss"]) / abs(p1["loss"])
    norm_rel = abs(k1["grad_norm"] - p1["grad_norm"]) / abs(p1["grad_norm"])
    if loss_rel > TRAIN_LOSS_REL or norm_rel > norm_bound:
        raise AssertionError(f"{what} step 1, kernels vs plain: loss {k1['loss']} vs "
                             f"{p1['loss']} ({loss_rel}), grad_norm {k1['grad_norm']} vs "
                             f"{p1['grad_norm']} ({norm_rel}, bound {norm_bound})")
    return loss_rel, norm_rel


def _p50(xs):
    import numpy as np

    return float(np.percentile(xs, 50))


def train_phase(args, dev, tmp: Path) -> dict:
    """(b)-(e): UVLTrack-B training at full width (B-TRAIN). Returns the
    launches per instantiation counted over (b)-(e), set to 0 just before."""
    import gc
    from collections import Counter

    import numpy as np
    import torch

    from uvltrack_tpu_torch.data.synthetic import synthetic_batch_from_cfg
    from uvltrack_tpu_torch.ops import build
    from uvltrack_tpu_torch.train.actor import forward_and_loss
    from uvltrack_tpu_torch.train.step import make_train_step, setup_training

    t_group = time.perf_counter()
    cfg = train_config()
    bsz = int(cfg.TRAIN.BATCH_SIZE)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             synthetic_batch_from_cfg(np.random.default_rng(args.seed), cfg, bsz).items()}
    total = Counter()

    def counted(fn):
        before = build.instantiation_counts()
        res = fn()
        total.update(launches_since(before))
        return res

    # (b) the kernels against plain, from one init, in turns K P P K K P ...
    t0 = time.perf_counter()
    _, k_state, k_step = setup_training(cfg, 1, device=dev, seed=args.seed)
    _, p_state, p_step = setup_training(cfg, 1, device=dev, seed=args.seed)
    build_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated() / 2 ** 20
    probes, sens, norm_bound, flips = gate_probes(k_state.model, p_state.model, batch, cfg,
                                                  args.seed, counted)
    runs = {"cuda": [], "plain": []}
    torch.cuda.reset_peak_memory_stats()
    for i in range(6):
        order = ("cuda", "plain") if i % 2 == 0 else ("plain", "cuda")
        for backend in order:
            if backend == "cuda":
                k_state, r = counted(lambda: _train_run(k_state, k_step, batch, "cuda", 1))
            else:
                p_state, r = _train_run(p_state, p_step, batch, "plain", 1)
            runs[backend] += r
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    loss_rel, norm_rel = step1_gate(runs["cuda"][0], runs["plain"][0], norm_bound, "B-TRAIN")
    del p_state, p_step
    gc.collect()
    torch.cuda.empty_cache()
    prof = counted(lambda: profile_window(
        lambda i: _train_run(k_state, k_step, batch, "cuda", 1), 2, "step"))
    step_ms = {b: _p50([r["ms"] for r in runs[b][1:]]) for b in runs}
    emit({"phase": "train_B", "cell": "B-TRAIN",
          "config": "experiments/uvltrack/baseline_base.yaml",
          "rows": f"{bsz} x {cfg.DATA.SEARCH.NUMBER} search frames = {TRAIN_B}",
          "params": sum(p.numel() for p in k_state.model.parameters()), "build_s": build_s,
          "timer": TRAIN_TIMER, "gate": f"step 1, kernels vs plain (relative): loss within "
          f"{TRAIN_LOSS_REL}, grad_norm within max({TRAIN_NORM_REL}, 2 x the plain backend's "
          f"move under a {TRAIN_PROBE_EPS:g} input change) = {norm_bound}",
          "step1": {"loss_rel": loss_rel, "grad_norm_rel": norm_rel,
                    "plain_grad_norm_move_at_eps": sens,
                    "supervised_cells_differing_from_plain": flips,
                    "probes": {k: {"loss": v["loss"], "grad_norm": v["grad_norm"]}
                               for k, v in probes.items()}},
          "losses": {b: [r["loss"] for r in runs[b]] for b in runs},
          "grad_norms": {b: [r["grad_norm"] for r in runs[b]] for b in runs},
          "step_ms_p50": step_ms, "step_ms": {b: [r["ms"] for r in runs[b]] for b in runs},
          "samples_per_s": {b: TRAIN_B / (step_ms[b] / 1e3) for b in runs},
          "launches_per_step": TRAIN_PER_FWD, "resident_mb_two_models": resident,
          "peak_mb_two_models": peak, "profile_kernels_2_steps": prof})

    # (c) the knobs: #4, #7 and #2's Functions inside the model, 2 steps each
    knobs = {}
    for knob, value, per_fwd in TRAIN_KNOBS:
        old = os.environ.get(knob)
        os.environ[knob] = value
        try:
            k_state, r = counted(lambda: _train_run(k_state, k_step, batch, "cuda", 2, per_fwd))
        finally:
            os.environ.pop(knob) if old is None else os.environ.__setitem__(knob, old)
        knobs[f"{knob}={value}"] = {"losses": [x["loss"] for x in r],
                                    "ms": [x["ms"] for x in r], "launches_per_step": per_fwd}
    emit({"phase": "train_knobs", "runs": knobs})

    # (d) TPU.REMAT: the same gradients, bitwise, from the same state; then
    # REMAT and GRAD_ACCUM=2 steps with their launches and peak memory
    model = k_state.model
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    stats = [(m.running_mean.clone(), m.running_var.clone()) for m in bns]

    def grads(remat):
        model.backbone.remat = remat
        for p in model.parameters():
            p.grad = None
        for m, (rm, rv) in zip(bns, stats):
            m.running_mean.copy_(rm)
            m.running_var.copy_(rv)
        torch.cuda.reset_peak_memory_stats()
        loss, _ = forward_and_loss(model, batch, cfg, train=True)
        loss.backward()
        torch.cuda.synchronize()
        return ([p.grad.clone() for p in model.parameters()],
                torch.cuda.max_memory_allocated() / 2 ** 20)

    (g0, peak0), (g1, peak1) = counted(lambda: grads(False)), counted(lambda: grads(True))
    same = sum(int(torch.equal(a, b)) for a, b in zip(g0, g1))
    if same != len(g0):
        raise AssertionError(f"TPU.REMAT: {len(g0) - same} of {len(g0)} gradients differ from "
                             "the plain step's")
    del g0, g1
    rcfg, acfg = train_config(**{"TPU.REMAT": True}), train_config(**{"TPU.GRAD_ACCUM": 2})
    model.backbone.remat = True
    torch.cuda.reset_peak_memory_stats()
    k_state, r_remat = counted(lambda: _train_run(
        k_state, make_train_step(model, k_state.optimizer, rcfg), batch, "cuda", 2, forwards=2))
    peak_remat = torch.cuda.max_memory_allocated() / 2 ** 20
    model.backbone.remat = False
    torch.cuda.reset_peak_memory_stats()
    k_state, r_acc = counted(lambda: _train_run(
        k_state, make_train_step(model, k_state.optimizer, acfg), batch, "cuda", 2, forwards=2))
    peak_acc = torch.cuda.max_memory_allocated() / 2 ** 20
    emit({"phase": "train_remat_accum",
          "remat_grads_bitwise": f"{same}/{same}",
          "peak_mb_one_backward": {"remat_off": peak0, "remat_on": peak1},
          "remat": {"losses": [x["loss"] for x in r_remat], "ms": [x["ms"] for x in r_remat],
                    "launches_per_step": {k: 2 * v for k, v in TRAIN_PER_FWD.items()},
                    "peak_mb": peak_remat},
          "grad_accum_2": {"losses": [x["loss"] for x in r_acc], "ms": [x["ms"] for x in r_acc],
                           "launches_per_step": {k: 2 * v for k, v in TRAIN_PER_FWD.items()},
                           "peak_mb": peak_acc}})
    del k_state, k_step, model, stats
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the CLI: 2 epochs of 3 synthetic batches, then a resume to epoch 3
    from uvltrack_tpu_torch.cli import train as ctrain

    argv = ["--config", "baseline_base", "--synthetic", "3", "--seed", str(args.seed),
            "--save_dir", str(tmp)]
    t0 = time.perf_counter()
    first = counted(lambda: ctrain.main(argv + ["--epochs", "2"]))
    t_first = time.perf_counter() - t0
    del first
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    second = counted(lambda: ctrain.main(argv + ["--epochs", "3"]))
    t_second = time.perf_counter() - t0
    ck = tmp / "checkpoints" / "train" / "uvltrack" / "baseline_base"
    log = tmp / "logs" / "uvltrack-baseline_base.log"
    recs = [json.loads(x) for x in (log.parent / (log.name + ".jsonl")).read_text().splitlines()]
    files = sorted(os.listdir(ck))
    if (second.epoch, second.state.step) != (3, 9) or files != [
            "ep0001.pt", "ep0002.pt", "ep0003.pt"] or "resumed from epoch 2" not in log.read_text():
        raise AssertionError(f"cli.train: epoch {second.epoch}, step {second.state.step}, "
                             f"checkpoints {files}")
    if not all(np.isfinite(v) for r in recs for v in r["train"].values()):
        raise AssertionError(f"cli.train: a loss is not finite: {recs}")
    emit({"phase": "train_cli", "argv": " ".join(argv), "epochs": [r["epoch"] for r in recs],
          "loss_per_epoch": [r["train"]["Loss/total"] for r in recs],
          "checkpoints": files, "checkpoint_mb": (ck / files[-1]).stat().st_size / 2 ** 20,
          "seconds_epochs_1_2": t_first, "seconds_resume_epoch_3": t_second})
    del second
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "train_group", "seconds": time.perf_counter() - t_group,
          "launches": dict(total)})
    return dict(total)


# ------------------------------------------------------------------- data
# B-TRAIN-REAL: baseline_base.yaml as it is, on the fixture trees, with only
# the SAMPLE_PER_EPOCH keys cut to fit the run, and the vocab the script
# writes in place of BERT's, which does not ship
DATA_STEPS = 8  # training steps an epoch of epochs 1-2
# the resumed epochs: long enough that the loader still draws batches through
# all but the last prefetch + 2 steps, as through a real epoch of 30,000 samples
# (48 until the fp32-compute cells of the cli group needed the time)
DATA_LONG_STEPS = 32
DATA_PROFILE_AT = (12, 2)  # the profiler window in a long epoch: steps 13-14
DATA_VAL_STEPS = 2  # batches of the VALTRACK and VALVL families an epoch
DATA_LOADER_STEPS = 8  # the loader alone: batches an epoch, 2 epochs a mode
DATA_SYN_STEPS = 6  # synthetic B-TRAIN steps a turn
DATA_WATCHDOG_S = 420  # the group takes 80-140 s
DATA_TIMER = ("host clock per train_step inside cli.train's loop (forward, backward, clip, "
              "AdamW), each ending in a read of its loss; loader wait = host time in the train "
              "loader's next() before each step. Loader-active steps: each epoch's steps 2 .. "
              "n - prefetch - 2, before which the loader has drawn at most step + prefetch + 1 "
              "of the epoch's n batches, so it still has batches to draw (a real epoch's steady "
              "state); tail: the epoch's last prefetch + 2 steps, where it may have drawn them "
              "all; the profiled steps are in neither")


def write_data_fixtures(args, tmp: Path) -> Path:
    """(a) The config's seven training and four validation datasets as
    fixture trees (uvltrack_tpu_torch/tools/data_fixtures.py, from --seed:
    1280x720 JPEG frames, 640x480 COCO/RefCOCOg images) and a GOT-10k LMDB
    pack written by the port's write_lmdb, the environment pointed at them;
    the pack read back against the folder (the same sequences, boxes and
    decoded frames) and pre-warmed by cli.prewarm. Returns the vocab."""
    import numpy as np

    from uvltrack_tpu_torch.cli import prewarm
    from uvltrack_tpu_torch.data.builders import names2datasets
    from uvltrack_tpu_torch.eval.environment import reset_env_cache
    from uvltrack_tpu_torch.tools.data_fixtures import vocab_words, write_trees

    t0 = time.perf_counter()
    env = write_trees(tmp / "trees", seed=args.seed, frame_hw=(720, 1280), image_hw=(480, 640),
                      n_seq=3, n_frames=24)
    write_s = time.perf_counter() - t0
    os.environ.update(env)
    reset_env_cache()
    vocab = tmp / "vocab.txt"
    write_vocab(vocab, vocab_words(), args.seed)
    folder, packed = names2datasets(["GOT10K_vottrain", "GOT10K_vottrain_lmdb"])
    equal = checked = 0
    for i in range(len(folder)):
        a, b = folder.get_sequence_info(i), packed.get_sequence_info(i)
        if not all(np.array_equal(a[k], b[k]) for k in a):
            raise AssertionError(f"GOT10K_vottrain_lmdb sequence {i}: info differs from the folder")
        ids = [0, len(a["bbox"]) // 2, len(a["bbox"]) - 1]
        for x, y in zip(folder.get_frames(i, ids, a)[0], packed.get_frames(i, ids, b)[0]):
            equal += int(np.array_equal(x, y))
            checked += 1
    if equal != checked:
        raise AssertionError(f"GOT10K_vottrain_lmdb: {equal} of {checked} frames equal the folder's")
    t0 = time.perf_counter()
    prewarm.main(["--data_dir", str(tmp / "trees"), "--dataset_str", "g", "--full"])
    emit({"phase": "data_fixtures", "seed": args.seed, "write_s": write_s,
          "prewarm_s": time.perf_counter() - t0, "frame": "1280x720 JPEG q90",
          "image": "640x480 JPEG", "sequences_a_dataset": 3, "frames_a_sequence": 24,
          "env": sorted(env), "got10k_lmdb_frames_equal_folder": f"{equal}/{checked}"})
    return vocab


def loader_alone(cfg, bsz: int, seed: int, mode: str) -> dict:
    """(b) build_train_loader over 2 epochs of DATA_LOADER_STEPS batches in
    one worker mode: each epoch's samples/s (the pool's start included),
    the first batch's seconds and the samples/s after it, and the flags
    drawn."""
    from collections import Counter

    from uvltrack_tpu_torch.data.loader import build_train_loader

    cfg.TPU.LOADER_WORKER_MODE = mode
    cfg.DATA.TRAIN.SAMPLE_PER_EPOCH = DATA_LOADER_STEPS * bsz
    loader = build_train_loader(cfg, bsz, seed=seed)
    flags, out = Counter(), {"samples_per_s_epochs": [], "first_batch_s": [],
                             "samples_per_s_after_first": []}
    for _ in range(2):
        t0 = time.perf_counter()
        n, t_first = 0, None
        for b in loader:
            t_first = t_first or time.perf_counter()
            flags.update(int(f) for f in b["flag"])
            n += len(b["flag"])
        t_end = time.perf_counter()
        out["samples_per_s_epochs"].append(n / (t_end - t0))
        out["first_batch_s"].append(t_first - t0)
        out["samples_per_s_after_first"].append((n - bsz) / (t_end - t_first))
    return dict(out, flags=dict(flags))


class _TimedLoader:
    """A train loader whose next() the host's clock times (the loader
    wait). With run["profile_at"] = (i, n) it opens a ProfileWindow before
    the next() of the i-th batch of the run, which the timed step closes
    after step i + n - 1: the window spans n whole turns of the loop
    (next(), upload, step)."""

    def __init__(self, inner, run: dict):
        self.inner, self.run = inner, run
        run["prefetch"] = inner.prefetch

    def __len__(self):
        return len(self.inner)

    def __iter__(self):
        it = iter(self.inner)
        at = self.run.get("profile_at")
        while True:
            if at and len(self.run["wait_ms"]) == at[0]:
                self.run["window"] = ProfileWindow()
            t0 = time.perf_counter()
            try:
                b = next(it)
            except StopIteration:
                return
            self.run["wait_t0"].append(t0)
            self.run["wait_ms"].append((time.perf_counter() - t0) * 1e3)
            yield b


def real_cli(argv, run: dict):
    """cli.train.main(argv) with each train step timed and its launches
    counted (run["steps"]: ms, loss, launches) and the train loader's waits
    recorded (run["wait_ms"]); run["profile_at"] = (i, n), if given, puts
    steps i .. i + n - 1 in a profiler window (run["profile"]). The
    returned trainer's train_step carries the untimed step as .step."""
    import math

    import torch

    from uvltrack_tpu_torch.cli import train as ctrain
    from uvltrack_tpu_torch.data import loader as tloader
    from uvltrack_tpu_torch.ops import build
    from uvltrack_tpu_torch.train import step as tstep

    run.update(steps=[], wait_ms=[], wait_t0=[])
    at = run.get("profile_at")
    setup0, build0 = tstep.setup_sharded_training, tloader.build_train_loader

    def setup(*a, **k):
        model, state, step = setup0(*a, **k)

        def timed(state, batch):
            i = len(run["steps"])
            before = build.instantiation_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            loss = float(m["Loss/total"])
            run["steps"].append({"ms": (time.perf_counter() - t0) * 1e3, "loss": loss,
                                 "launches": launches_since(before), "end": time.perf_counter(),
                                 "profiled": bool(at) and at[0] <= i < at[0] + at[1]})
            if at and i == at[0] + at[1] - 1:
                t1 = time.perf_counter()
                run["profile"] = run.pop("window").close(at[1], "step")
                run["profile_close_s"] = time.perf_counter() - t1
            return state, m
        timed.step = step
        return model, state, timed

    tstep.setup_sharded_training = setup
    tloader.build_train_loader = lambda *a, **k: _TimedLoader(build0(*a, **k), run)
    try:
        t0 = time.perf_counter()
        trainer = ctrain.main(argv)
        run["seconds"] = time.perf_counter() - t0
    finally:
        tstep.setup_sharded_training, tloader.build_train_loader = setup0, build0
    for i, st in enumerate(run["steps"]):
        expect_launches(TRAIN_PER_FWD, 1, st["launches"], f"B-TRAIN-REAL step {i + 1}")
        if not math.isfinite(st["loss"]):
            raise AssertionError(f"B-TRAIN-REAL step {i + 1}: loss {st['loss']}")
    return trainer


def loader_phases(run: dict) -> tuple:
    """The indices of run's loader-active steps and of its tail steps
    (DATA_TIMER), each epoch's first step (the pool's start) and the
    profiled steps in neither."""
    n, tail = run["per_epoch"], run["prefetch"] + 2
    active, idle = [], []
    for i, st in enumerate(run["steps"]):
        if st["profiled"] or i % n == 0:
            continue
        (active if i % n < n - tail else idle).append(i)
    return active, idle


def data_phase(args, dev, tmp: Path) -> dict:
    """The `data` group: (a) fixture trees; (b) the loader alone in thread
    and process mode; (c) B-TRAIN-REAL (cli.train on the trees) in turns
    with synthetic B-TRAIN steps; (d) step 1 on one real batch, kernels
    against plain. Returns the launches per instantiation of (c) and (d),
    each counted from the counts just before it."""
    import gc
    from collections import Counter

    import numpy as np
    import torch

    from uvltrack_tpu_torch.data.loader import build_train_loader
    from uvltrack_tpu_torch.data.synthetic import synthetic_batch_from_cfg
    from uvltrack_tpu_torch.ops import build
    from uvltrack_tpu_torch.train.step import setup_training

    t_group = time.perf_counter()
    vocab = write_data_fixtures(args, tmp)
    cfg = train_config(**{"MODEL.BACKBONE.LANGUAGE.VOCAB_PATH": vocab})
    bsz = int(cfg.TRAIN.BATCH_SIZE)
    mp_context = os.environ.get("UVLTRACK_LOADER_MP_CONTEXT", "fork")
    alone = {m: loader_alone(cfg, bsz, args.seed, m) for m in ("thread", "process")}
    flags = Counter()
    for r in alone.values():
        flags.update(r["flags"])
    n = sum(flags.values())
    emit({"phase": "data_loader", "config": "experiments/uvltrack/baseline_base.yaml",
          "num_worker": int(cfg.TRAIN.NUM_WORKER), "process_mp_context": mp_context,
          "cpu_count": os.cpu_count(), "batch": bsz, "batches_an_epoch": DATA_LOADER_STEPS,
          "samples_per_s": {m: r["samples_per_s_epochs"] for m, r in alone.items()},
          "first_batch_s": {m: r["first_batch_s"] for m, r in alone.items()},
          "samples_per_s_after_first": {m: r["samples_per_s_after_first"]
                                        for m, r in alone.items()},
          "task_mix": {str(f): flags.get(f, 0) / n for f in (0, 1, 2)},
          "task_mix_config": {"0": 0.45, "1": 0.11, "2": 0.44}, "samples": n})
    if set(flags) != {0, 1, 2}:
        raise AssertionError(f"the loader drew flags {dict(flags)}, not all three tasks")

    # (c) 2 epochs, then a resume to 3 (thread workers, the config's) and
    # one to 4 under process workers, each of DATA_LONG_STEPS steps with a
    # profiler window inside its loader-active steps; synthetic steps on the
    # same trainer after each run, the second turn profiled
    total = Counter()
    sets = [f"DATA.TRAIN.SAMPLE_PER_EPOCH={DATA_STEPS * bsz}",
            f"DATA.VALTRACK.SAMPLE_PER_EPOCH={DATA_VAL_STEPS * bsz}",
            f"DATA.VALVL.SAMPLE_PER_EPOCH={DATA_VAL_STEPS * bsz}",
            f"MODEL.BACKBONE.LANGUAGE.VOCAB_PATH={vocab}"]
    argv = ["--config", "baseline_base", "--seed", str(args.seed), "--save_dir", str(tmp / "run")]
    for s in sets:
        argv += ["--set", s]
    long = ["--set", f"DATA.TRAIN.SAMPLE_PER_EPOCH={DATA_LONG_STEPS * bsz}"]
    syn = {k: torch.from_numpy(v).to(dev) for k, v in synthetic_batch_from_cfg(
        np.random.default_rng(args.seed), cfg, bsz).items()}
    runs, syn_runs, syn_prof, peak = {}, [], None, {}
    for label, extra, per_epoch in (
            ("epochs_1_2", ["--epochs", "2"], DATA_STEPS),
            ("resume_3", ["--epochs", "3"] + long, DATA_LONG_STEPS),
            ("resume_4_process", ["--epochs", "4", "--set", "TPU.LOADER_WORKER_MODE=process"]
             + long, DATA_LONG_STEPS)):
        torch.cuda.reset_peak_memory_stats()
        before = build.instantiation_counts()
        runs[label] = {"per_epoch": per_epoch}
        if per_epoch == DATA_LONG_STEPS:
            runs[label]["profile_at"] = DATA_PROFILE_AT
        trainer = real_cli(argv + extra, runs[label])
        total.update(launches_since(before))
        peak[label] = torch.cuda.max_memory_allocated() / 2 ** 20
        step = trainer.train_step.step
        before = build.instantiation_counts()
        trainer.state, r = _train_run(trainer.state, step, syn, "cuda", DATA_SYN_STEPS)
        syn_runs.append(r)
        if label == "resume_3":
            def syn_step(i):
                trainer.state, m = step(trainer.state, syn)
                return float(m["Loss/total"])

            syn_prof = profile_window(syn_step, DATA_PROFILE_AT[1], "step")
            expect_launches(TRAIN_PER_FWD, DATA_SYN_STEPS + DATA_PROFILE_AT[1],
                            launches_since(before), "synthetic steps between the real runs")
        total.update(launches_since(before))
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    log = tmp / "run" / "logs" / "uvltrack-baseline_base.log"
    recs = [json.loads(x) for x in (log.parent / (log.name + ".jsonl")).read_text().splitlines()]
    ck = sorted(os.listdir(tmp / "run" / "checkpoints" / "train" / "uvltrack" / "baseline_base"))
    text = log.read_text()
    if [r["epoch"] for r in recs] != [1, 2, 3, 4] or ck != [f"ep{e:04d}.pt" for e in (1, 2, 3, 4)] \
            or "resumed from epoch 2" not in text or "resumed from epoch 3" not in text:
        raise AssertionError(f"B-TRAIN-REAL: epochs {[r['epoch'] for r in recs]}, checkpoints {ck}")
    for r in recs:
        if set(r["val"]) != {"valtrack", "valground", "valvl"}:
            raise AssertionError(f"B-TRAIN-REAL epoch {r['epoch']} validated {sorted(r['val'])}")
        vals = list(r["train"].values()) + [x for v in r["val"].values() for x in v.values()]
        if not all(np.isfinite(vals)):
            raise AssertionError(f"B-TRAIN-REAL epoch {r['epoch']}: a metric is not finite: {r}")
    def pick(xs, idx):
        return [xs[i] for i in idx]

    cells = {}
    for label, run in runs.items():
        active, idle = loader_phases(run)
        n = run["per_epoch"]
        step_ms = [s["ms"] for s in run["steps"]]
        ms, waits = pick(step_ms, active), pick(run["wait_ms"], active)
        # the train loop's wall an epoch: the first batch's wait to the
        # last step's end (uploads included; validation, saves and the
        # profiler's close not)
        loop_s = [run["steps"][e + n - 1]["end"] - run["wait_t0"][e]
                  for e in range(0, len(run["steps"]), n)]
        if "profile_at" in run:
            loop_s[run["profile_at"][0] // n] -= run["profile_close_s"]
        cells[label] = {"steps": len(run["steps"]), "steps_an_epoch": n,
                        "loader_active_steps": len(active), "step_ms_p50": _p50(ms),
                        "samples_per_s": TRAIN_B / (_p50(ms) / 1e3),
                        "loader_wait_ms_p50": _p50(waits), "loader_wait_ms_max": max(waits),
                        "tail_steps": len(idle), "tail_step_ms_p50": _p50(pick(step_ms, idle)),
                        "tail_loader_wait_ms_p50": _p50(pick(run["wait_ms"], idle)),
                        "first_step_wait_ms": run["wait_ms"][::n],
                        "seconds_cli": run["seconds"], "epoch_loop_s": loop_s,
                        "rows_per_s_epoch_loop": [TRAIN_B * n / t for t in loop_s],
                        "profile_loader_active": run.get("profile"),
                        "profile_close_s": run.get("profile_close_s"),
                        "step_ms": step_ms, "wait_ms": run["wait_ms"], "peak_mb": peak[label],
                        "losses": [s["loss"] for s in run["steps"]]}
    syn_ms = [x["ms"] for r in syn_runs for x in r[1:]]
    emit({"phase": "data_train", "cell": "B-TRAIN-REAL",
          "config": "experiments/uvltrack/baseline_base.yaml", "argv": " ".join(argv),
          "rows": f"{bsz} x {cfg.DATA.SEARCH.NUMBER} search frames = {TRAIN_B}",
          "timer": DATA_TIMER, "runs": cells,
          "synthetic_turns": {"step_ms": [[x["ms"] for x in r] for r in syn_runs],
                              "step_ms_p50": _p50(syn_ms),
                              "samples_per_s": TRAIN_B / (_p50(syn_ms) / 1e3)},
          "order": "real epochs 1-2, synthetic, real epoch 3, synthetic (profiled), "
                   "real epoch 4 (process), synthetic",
          "launches_per_step": TRAIN_PER_FWD, "profile_synthetic": syn_prof,
          "val_per_epoch": {r["epoch"]: r["val"] for r in recs},
          "loss_per_epoch": [r["train"]["Loss/total"] for r in recs], "checkpoints": ck})

    # (d) step 1 on one real batch from one init, kernels against plain
    before = build.instantiation_counts()
    _, k_state, k_step = setup_training(cfg, 1, device=dev, seed=args.seed)
    _, p_state, p_step = setup_training(cfg, 1, device=dev, seed=args.seed)
    cfg.TPU.LOADER_WORKER_MODE = "thread"
    cfg.DATA.TRAIN.SAMPLE_PER_EPOCH = bsz
    batch = next(iter(build_train_loader(cfg, bsz, seed=args.seed)))
    real = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    probes, sens, norm_bound, flips = gate_probes(k_state.model, p_state.model, real, cfg,
                                                  args.seed, lambda fn: fn())
    _, k1 = _train_run(k_state, k_step, real, "cuda", 1)
    _, p1 = _train_run(p_state, p_step, real, "plain", 1)
    loss_rel, norm_rel = step1_gate(k1[0], p1[0], norm_bound, "B-TRAIN-REAL")
    total.update(launches_since(before))
    emit({"phase": "data_step1", "batch_flags": batch["flag"].tolist(),
          "gate": f"loss within {TRAIN_LOSS_REL}, grad_norm within max({TRAIN_NORM_REL}, 2 x "
          f"the plain backend's move under a {TRAIN_PROBE_EPS:g} input change) = {norm_bound}",
          "loss_rel": loss_rel, "grad_norm_rel": norm_rel, "plain_grad_norm_move_at_eps": sens,
          "supervised_cells_differing_from_plain": flips,
          "step1": {"cuda": k1[0], "plain": p1[0]},
          "probes": {k: {"loss": v["loss"], "grad_norm": v["grad_norm"]}
                     for k, v in probes.items()}})
    del k_state, k_step, p_state, p_step, real
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "data_group", "seconds": time.perf_counter() - t_group,
          "launches": dict(total)})
    return dict(total)



# ------------------------------------------------------------------ cli
# fp32 compute (TPU.COMPUTE_DTYPE=float32: fp32 weights, an fp32 stream in
# every block): launches per backbone forward of UVLTrack-B, by knob, and
# the fp32 weights whose hi/lo planes split_hilo writes once per model
F32_PER_FWD = {"ln_qkv[fp32x-fp32w]": 12, "qkv_attention[fp32]": 12}
F32_KNOBS = {  # label -> (environment, extra launches a forward, exported ops, weights split)
    "": ({}, {}, {"ln_qkv": 12, "qkv_attention": 12}, 12),
    "fused_proj": ({"UVLTRACK_FUSED_PROJ": "1"}, {"proj_residual[fp32x-fp32a-fp32w]": 12},
                   {"ln_qkv": 12, "qkv_attention": 12, "proj_residual": 12}, 24),
    "fused_mlp": ({"UVLTRACK_FUSED_MLP": "1"}, {"ln_mlp[fp32x-fp32w]": 12},
                  {"ln_qkv": 12, "qkv_attention": 12, "ln_mlp": 12}, 36),
}
F32W_NAMES = ("ln_qkv[fp32x-fp32w]", "proj_residual[fp32x-fp32a-fp32w]", "ln_mlp[fp32x-fp32w]",
              "split_hilo[fp32w]")
F32W_GRID_DOC = ("B in {1, 8} x N in {321, 361} x C in {768, 1024} (H = C/64) x 3 masks, "
                 "fp32 x and W: ln_qkv, its attention and proj_residual (alone, and as "
                 "kernel #4 on that attention) a mask, ln_mlp (the pair and each launch) and "
                 "split_hilo a shape; each kernel called twice (bitwise equal)")
CLI_PROFILE = ["--warmup", "5", "--iters", "30"]  # iterations of each cli.profile run
CLI_DEMO_FRAMES = 48
CLI_TIMER = ("cli.profile's own host clock per call (mean/p50/p90 over --iters, each call "
             "ending in torch.cuda.synchronize or the step's box read-back), as it prints it")


def expect_f32_launches(extra: dict, forwards: int, splits: int, got: dict, what: str) -> None:
    """fp32 compute: F32_PER_FWD and a knob's `extra` launches a forward, and
    one split_hilo launch for each of the `splits` fp32 weights the path's
    model instances read (each instance splits its own weights once)."""
    want = {k: v * forwards for k, v in {**F32_PER_FWD, **extra}.items()}
    want["split_hilo[fp32w]"] = splits
    if got != want:
        raise AssertionError(f"{what}: launches {got} != {want}")


def f32w_kernel_phase(dev, seed: int):
    """The fp32-weight instantiations against their plain fp32 versions
    over F32W_GRID_DOC, under the fp32 rule, two calls bitwise equal:
    ln_qkv[fp32x-fp32w] (and the fp32 attention after it),
    proj_residual[fp32x-fp32a-fp32w] (alone and as #4), ln_mlp[fp32x-fp32w]
    (both launches, and each alone), split_hilo (bitwise its plain
    version); then times of each kernel, its plain version and its library
    call (fp32, TF32 off) beside its bound at B in {1, 8}, N in {321, 361},
    C in {768, 1024}. Returns (worst errors, times)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from uvltrack_tpu_torch.ops import hilo
    from uvltrack_tpu_torch.ops import ln_mlp as lm
    from uvltrack_tpu_torch.ops import ln_qkv_attention as lqa
    from uvltrack_tpu_torch.ops import ln_qkv_attn_proj as lqp

    rng = np.random.default_rng(seed + 14)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    def case(b, n, c):
        """x, LN scale/bias, and the block's four fp32 weights with biases
        (Linear layout)."""
        f = 4 * c
        return dict(x=t(rng.normal(size=(b, n, c))), g=t(1 + 0.1 * rng.normal(size=c)),
                    be=t(0.1 * rng.normal(size=c)), w=t(rng.normal(size=(3 * c, c)) / np.sqrt(c)),
                    wb=t(0.02 * rng.normal(size=3 * c)), wp=t(rng.normal(size=(c, c)) / np.sqrt(c)),
                    bp=t(0.02 * rng.normal(size=c)), w1=t(rng.normal(size=(f, c)) / np.sqrt(c)),
                    b1=t(0.02 * rng.normal(size=f)), w2=t(rng.normal(size=(c, f)) / np.sqrt(f)),
                    b2=t(0.02 * rng.normal(size=c)))

    worst = {}

    def check(name, got, want, what):
        if got.dtype != torch.float32 or got.shape != want.shape:
            raise AssertionError(f"{name} {what}: {got.dtype}{tuple(got.shape)} vs plain "
                                 f"{want.dtype}{tuple(want.shape)}")
        d = (got - want).abs()
        if not bool((d <= F32_ATOL + F32_RTOL * want.abs()).all()):
            raise AssertionError(f"{name} {what}: max abs err {float(d.max())} over {F32_ATOL} "
                                 f"+ {F32_RTOL}*|plain|")
        worst[name] = max(worst.get(name, 0.0), float(d.max()))

    def twice(name, fn, what):
        """fn() twice: the same bits both times."""
        first, again = fn(), fn()
        torch.cuda.synchronize()
        if not torch.equal(first, again):
            raise AssertionError(f"{name} {what}: a second call differs")
        return first

    shapes = [(b, n, c) for b in (1, LOCKSTEP_B) for n in (321, 361) for c in (768, L_WIDTH)]
    cases = {}
    for b, n, c in shapes:
        k = cases[(b, n, c)] = case(b, n, c)
        x, g, be, w, wb, wp, bp = (k[i] for i in ("x", "g", "be", "w", "wb", "wp", "bp"))
        w1, b1, w2, b2 = (k[i] for i in ("w1", "b1", "w2", "b2"))
        what = f"B={b} N={n} C={c}"
        for kind in ("flag0", "flag2", "open"):
            kb = t(np.where(key_masks(b, n, kind, rng), -1e10, 0.0))
            wm = f"{what} mask={kind}"
            qkv = twice(F32W_NAMES[0], lambda: lqa.ln_qkv(x, g, be, w, wb), wm)
            check(F32W_NAMES[0], qkv, lqa.ln_qkv_plain(x, g, be, w, wb), wm)
            attn = lqa.qkv_attention(qkv, kb, c // 64)
            check("ln_qkv_attention[fp32x-fp32w]", attn,
                  lqa.ln_qkv_attention_plain(x, g, be, w, wb, kb, c // 64), wm)
            out = twice(F32W_NAMES[1], lambda: lqp.proj_residual(x, attn, wp, bp), wm)
            check(F32W_NAMES[1], out, lqp.proj_residual_plain(x, attn, wp, bp), wm)
            fused = lqp.ln_qkv_attn_proj(x, g, be, w, wb, wp, bp, kb, c // 64)
            check("ln_qkv_attn_proj[fp32x-fp32w]", fused,
                  lqp.ln_qkv_attn_proj_plain(x, g, be, w, wb, wp, bp, kb, c // 64), wm)
        f = w1.shape[0]
        hidden = torch.empty((b * n, f), dtype=torch.float32, device=dev)
        out = torch.empty_like(x)
        mlp = twice(F32W_NAMES[2], lambda: lm.ln_mlp(x, g, be, w1, b1, w2, b2), what)
        check(F32W_NAMES[2], mlp, lm.ln_mlp_plain(x, g, be, w1, b1, w2, b2), what)
        lm.launch_ln_mlp(x, g, be, w1, b1, w2, b2, hidden, out, stages="ln_fc1_gelu")
        check("ln_fc1_gelu[fp32]", hidden.view(b, n, f), lm.ln_fc1_gelu_plain(x, g, be, w1, b1),
              what)
        lm.launch_ln_mlp(x, g, be, w1, b1, w2, b2, hidden, out, stages="fc2_bias")
        check("fc2_bias[fp32]", out, lm.fc2_bias_plain(hidden.view(b, n, f), w2, b2), what)
        if not torch.equal(out, mlp):
            raise AssertionError(f"ln_mlp[fp32x-fp32w] {what}: the launches alone differ from "
                                 "the pair")
        for name in ("w", "wp", "w1", "w2"):
            planes = twice(F32W_NAMES[3], lambda: hilo.split_hilo(k[name]), what)
            if not torch.equal(planes, hilo.split_hilo_plain(k[name])):
                raise AssertionError(f"split_hilo {what} {name}: not its plain version's bits")
            if not torch.equal(hilo.planes(k[name]), planes):
                raise AssertionError(f"split_hilo {what} {name}: the cached planes differ")
        worst[F32W_NAMES[3]] = 0.0
    emit({"phase": "f32w_kernel_check", "grid": F32W_GRID_DOC, "max_abs_err": worst,
          "tolerance": f"|kernel-plain| <= {F32_ATOL} + {F32_RTOL}*|plain|; split_hilo bitwise",
          "repeatable": "bitwise, two calls at every check"})

    def row(kern, plain, lib, lib_what, work):
        b_ms, b_by = bound(*work)
        return {**timings(kern, plain, lib), "library": lib_what, "bound_ms": b_ms,
                "bound_by": b_by}

    times = {}
    for b, n, c in shapes:
        k = cases[(b, n, c)]
        x, g, be, w, wb, wp, bp = (k[i] for i in ("x", "g", "be", "w", "wb", "wp", "bp"))
        w1, b1, w2, b2 = (k[i] for i in ("w1", "b1", "w2", "b2"))
        m, f = b * n, 4 * c
        # fp32 products as three bf16 passes at the least (bound()'s note);
        # inputs read once, outputs written once, all fp32
        key = f"{'' if b == 1 else f'B{b}_'}N{n}_C{c}"
        times[key] = {F32W_NAMES[0]: row(
            lambda: lqa.ln_qkv(x, g, be, w, wb), lambda: lqa.ln_qkv_plain(x, g, be, w, wb),
            lambda: F.linear(F.layer_norm(x, (c,), g, be, 1e-6), w, wb),
            "F.layer_norm + F.linear, fp32",
            (3 * 2 * m * c * 3 * c, 4 * (m * c + 3 * c * c + 3 * c + 2 * c + m * 3 * c)))}
        if n != 361:  # row 1b at both N; the rest at N=361
            continue
        attn = lqa.ln_qkv_attention(x, g, be, w, wb, torch.zeros((b, n), device=dev), c // 64)
        hidden = torch.empty((m, f), dtype=torch.float32, device=dev)
        out = torch.empty_like(x)
        h3 = hidden.view(b, n, f)
        lm.launch_ln_mlp(x, g, be, w1, b1, w2, b2, hidden, out, stages="ln_fc1_gelu")
        planes = torch.empty((2, 3 * c, c), dtype=torch.bfloat16, device=dev)

        def launch(stages):
            return lambda: lm.launch_ln_mlp(x, g, be, w1, b1, w2, b2, hidden, out, stages=stages)

        def fc1_lib():
            return F.gelu(F.linear(F.layer_norm(x, (c,), g, be, 1e-6), w1, b1))

        times[key].update({
            F32W_NAMES[1]: row(lambda: lqp.proj_residual(x, attn, wp, bp),
                               lambda: lqp.proj_residual_plain(x, attn, wp, bp),
                               lambda: x + F.linear(attn, wp, bp), "F.linear + add, fp32",
                               (3 * 2 * m * c * c, 4 * (3 * m * c + c * c + c))),
            F32W_NAMES[2]: row(launch("pair"), lambda: lm.ln_mlp_plain(x, g, be, w1, b1, w2, b2),
                               lambda: F.linear(fc1_lib(), w2, b2),
                               "F.layer_norm + F.linear + F.gelu + F.linear, fp32",
                               (3 * 4 * m * c * f, 4 * (2 * m * c + 2 * c * f + f + 3 * c
                                                        + 2 * m * f))),
            f"{F32W_NAMES[2]} ln_fc1_gelu": row(
                launch("ln_fc1_gelu"), lambda: lm.ln_fc1_gelu_plain(x, g, be, w1, b1), fc1_lib,
                "F.layer_norm + F.linear + F.gelu, fp32",
                (3 * 2 * m * c * f, 4 * (m * c + c * f + f + 2 * c + m * f))),
            f"{F32W_NAMES[2]} fc2_bias": row(
                launch("fc2_bias"), lambda: lm.fc2_bias_plain(h3, w2, b2),
                lambda: F.linear(h3, w2, b2), "F.linear, fp32",
                (3 * 2 * m * f * c, 4 * (m * f + c * f + c + m * c))),
            # the qkv weight's planes: 4 bytes read and 4 written a value
            F32W_NAMES[3]: row(lambda: hilo.split_hilo(w, out=planes),
                               lambda: hilo.split_hilo_plain(w), None, None,
                               (0, 8 * 3 * c * c)),
        })
    emit({"phase": "f32w_kernel_times", "timer": TIMER, "times": times,
          "hilo_cache_bytes": hilo.cache_bytes()})
    del cases
    hilo.clear_cache()
    return worst, times


def cli_capture(fn, argv) -> tuple:
    """fn(argv) with stdout captured and the launch counts set to 0 just
    before and read just after: (return value, stdout, launches, seconds)."""
    import contextlib
    import io

    from uvltrack_tpu_torch.ops import build

    buf = io.StringIO()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        ret = fn(argv)
    return ret, buf.getvalue(), build.instantiation_counts(), time.perf_counter() - t0


def profile_runs(tmp: Path) -> tuple:
    """(b) cli.profile.main on UVLTrack-B: forward on the kernels and on the
    plain backend (--xla), both counted by utils/costs.py (the counts must be
    equal), forward on the kernels under a torch.profiler trace (read back:
    the GEMM core's launches in it), forward with int8
    weights, the step on both backends, and UVLTrack-L's step; each run's
    printed latency line parsed, its launches counted from 0. Returns
    (records, launches summed)."""
    import re

    from uvltrack_tpu_torch.cli import profile as cli_profile
    from uvltrack_tpu_torch.utils import costs

    lat_re = re.compile(r"^(forward|step) \(batch=(\d+)\): mean=([\d.]+)ms p50=([\d.]+)ms "
                        r"p90=([\d.]+)ms fps=([\d.]+)$", re.M)
    counted, orig = [], costs.program_cost

    def record(*a, **k):
        counted.append(orig(*a, **k))
        return counted[-1]

    costs.program_cost = record
    runs = [("forward_B", ["--what", "forward"], PER_FWD_FP),
            ("forward_B_xla", ["--what", "forward", "--xla"], {}),
            # the profiler's host cost would lift the timed calls: a run of its own
            ("forward_B_trace", ["--what", "forward", "--trace_dir", str(tmp / "trace")],
             PER_FWD_FP),
            ("forward_B_int8", ["--what", "forward", "--quant", "int8"], PER_FWD_Q8),
            ("step_B", ["--what", "step"], {}),
            ("step_B_xla", ["--what", "step", "--xla"], {}),
            ("step_L", ["--what", "step", "--config", "baseline_large"], {})]
    recs, launches = {}, {}
    try:
        for label, extra, per_fwd in runs:
            n0 = len(counted)
            _, out, got, secs = cli_capture(cli_profile.main, extra + CLI_PROFILE)
            m = lat_re.search(out)
            if not m:
                raise AssertionError(f"profile {label}: no latency line:\n{out[-800:]}")
            rec = {"p50_ms": float(m.group(4)), "p90_ms": float(m.group(5)),
                   "mean_ms": float(m.group(3)), "fps": float(m.group(6)), "launches": got,
                   "cli_seconds": secs}
            if len(counted) > n0:
                rec["cost"] = counted[-1]
            if "xla" in label and got:
                raise AssertionError(f"profile {label}: the plain backend launched {got}")
            if "xla" not in label and not got:
                raise AssertionError(f"profile {label}: no kernel launched")
            forwards = int(CLI_PROFILE[1]) + int(CLI_PROFILE[3]) + 1  # + the counted call
            if per_fwd:
                expect_launches(per_fwd, forwards, got, f"profile {label}")
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
            recs[label] = rec
    finally:
        costs.program_cost = orig
    if recs["forward_B"]["cost"] != recs["forward_B_xla"]["cost"]:
        raise AssertionError(f"cost count differs: kernels {recs['forward_B']['cost']}, "
                             f"plain {recs['forward_B_xla']['cost']}")
    recs["trace"] = trace_kernels(tmp / "trace" / "trace.json")
    if not any("ln_gemm_kernel" in k for k in recs["trace"]["ours"]):
        raise AssertionError(f"the profiler trace holds none of the GEMM core's launches: "
                             f"{recs['trace']}")
    return recs, launches


def trace_kernels(path: Path) -> dict:
    """A Chrome trace read back: its events, its device kernels and the
    names of the port's kernels among them."""
    trace = json.loads(path.read_text())["traceEvents"]
    kernels = [e["name"] for e in trace if e.get("cat") == "kernel"]
    ours = sorted({k.split("<")[0].split("(")[0] for k in kernels
                   if "ln_gemm_kernel" in k or "attention_bf16_kernel" in k})
    return {"events": len(trace), "device_kernels": len(kernels), "ours": ours}


def cli_phase(args, dev, vocab: Path, tmp: Path) -> dict:
    """The `cli` group: (a) the fp32-weight instantiations; (b) cli.profile;
    (c) cli.export --check at fp32 compute, plain and under each fused knob
    (F32_KNOBS), the exported graph's kernel ops counted by name; (d)
    cli.parity on a .pth.tar of the seeded model, on the kernels and on the
    plain backend, in fp32 (plain and under each knob) and with --quant
    int8, the dumps held key by key to the fp32 rule; (e) cli.demo on a 48-frame 720p
    video against a direct Tracker over the same decoded frames; (f)
    cli.test on a trainer checkpoint (ep0001.pt) against a direct replay.
    Returns {"f32w": (worst, times), "launches", "graph_launches"}."""
    import cv2
    import numpy as np
    import torch

    from uvltrack_tpu_torch.cli import demo as cli_demo
    from uvltrack_tpu_torch.cli import export as cli_export
    from uvltrack_tpu_torch.cli import parity as cli_parity
    from uvltrack_tpu_torch.cli import test as cli_test
    from uvltrack_tpu_torch.config import load_cfg
    from uvltrack_tpu_torch.eval import environment, get_dataset
    from uvltrack_tpu_torch.models.uvltrack import build_model
    from uvltrack_tpu_torch.ops import attention, hilo
    from uvltrack_tpu_torch.track.tracker import Tracker
    from uvltrack_tpu_torch.train.checkpoint import CheckpointManager
    from uvltrack_tpu_torch.train.optim import build_optimizer
    from uvltrack_tpu_torch.train.step import create_train_state

    t_group = time.perf_counter()
    launches, glaunch = {}, {}

    def add(d, into=launches):
        for k, v in d.items():
            into[k] = into.get(k, 0) + v

    f32w = f32w_kernel_phase(dev, args.seed)
    results = tmp / "results"
    os.environ.update({"UVLTRACK_REPO": str(REPO), "UVLTRACK_RESULTS_PATH": str(results),
                       "UVLTRACK_OTB99_PATH": str(tmp / "otb99")})
    environment.reset_env_cache()

    # (b) the profiler
    recs, got = profile_runs(tmp)
    add(got)
    emit({"phase": "cli_profile", "config": "B: baseline_base.yaml, L: baseline_large.yaml, "
          "seed 0", "argv": CLI_PROFILE, "timer": CLI_TIMER, **recs})

    # (c) export at fp32 compute, --check: the loaded program against the
    # direct call; plain, then under each fused knob (kernels #4 and #7 with
    # fp32 weights)
    planes, peak = hilo.planes, [0]

    def planes_peak(w):  # the planes cache's largest size during the run
        got = planes(w)
        peak[0] = max(peak[0], hilo.cache_bytes())
        return got

    for label, (env, extra, ops, splits) in F32_KNOBS.items():
        out_pt2 = tmp / "uvltrack_b.pt2"
        os.environ.update(env)
        hilo.planes, peak[0] = planes_peak, 0
        try:
            _, out, got, secs = cli_capture(cli_export.main, ["--config", "baseline_base",
                                                              "--out", str(out_pt2), "--check"])
        finally:
            hilo.planes = planes
            for k in env:
                os.environ.pop(k)
        manifest = json.loads(Path(str(out_pt2) + ".json").read_text())
        if "check: loaded program matches the direct call" not in out:
            raise AssertionError(f"export --check {label}: {out[-800:]}")
        if manifest["kernel_ops"] != ops:
            raise AssertionError(f"export {label}: the graph's kernel ops "
                                 f"{manifest['kernel_ops']}, not {ops}")
        # two model instances (the direct one, the loaded program), a forward each
        expect_f32_launches(extra, 2, 2 * splits, got,
                            f"export --check {label} (the loaded program and the direct call)")
        add(got)
        emit({"phase": f"cli_export{'_' + label if label else ''}", "env": env,
              "seconds": secs, "file_bytes": manifest["bytes"],
              "hilo_cache_peak_bytes": peak[0], "weights_split": 2 * splits,
              "kernel_ops": manifest["kernel_ops"], "n_args_flat": manifest["n_args_flat"],
              "platforms": manifest["platforms"], "launches": got,
              "check": "loaded program within 1e-5 of the direct call"})
        out_pt2.unlink()

    # (d) parity: a .pth.tar of the seeded model, kernels against plain
    ckpt = tmp / "UVLTrack_seeded.pth.tar"
    seeded = build_model(load_cfg(str(REPO / "experiments/uvltrack/baseline_base.yaml")),
                         device=dev, seed=args.seed + 3)
    torch.save({"net": seeded.state_dict()}, ckpt)
    del seeded
    parity = {}
    runs = [(label, [], env, extra, splits)
            for label, (env, extra, _, splits) in F32_KNOBS.items()]
    runs.append(("int8", ["--quant", "int8"], {}, None, 0))
    for label, quant, env, extra, splits in runs:
        dumps = {}
        for backend in ("cuda", "plain"):
            attention.force_backend(backend)
            os.environ.update(env)
            try:
                path = tmp / f"parity_{backend}_{label}.npz"
                _, out, got, _ = cli_capture(cli_parity.main, [
                    "--checkpoint", str(ckpt), "--out", str(path), "--seed", str(args.seed),
                    *quant])
            finally:
                attention.force_backend(None)
                for k in env:
                    os.environ.pop(k)
            what = f"parity {backend} {label or 'fp32'}"
            if backend == "plain":
                if got:
                    raise AssertionError(f"parity on the plain backend launched {got}")
            elif quant:
                expect_launches({"ln_qkv[fp32x-int8w]": 12, "qkv_attention[fp32]": 12}, 2, got,
                                what)
            else:
                expect_f32_launches(extra, 2, splits, got, what)
            add(got)
            dumps[backend] = dict(np.load(path))
        worst = 0.0
        if sorted(dumps["cuda"]) != sorted(dumps["plain"]):
            raise AssertionError("parity dumps hold different keys")
        for k, ref in dumps["plain"].items():
            a, ref = dumps["cuda"][k].astype(np.float64), ref.astype(np.float64)
            d = np.abs(a - ref)
            if not (d <= F32_ATOL + F32_RTOL * np.abs(ref)).all() or not np.isfinite(a).all():
                raise AssertionError(f"parity {label} {k}: kernels vs plain max abs err "
                                     f"{d.max()} over the fp32 rule")
            worst = max(worst, float(d.max()))
        parity[label if quant else f"fp32{'_' + label if label else ''}"] = {
            "keys": len(dumps["cuda"]), "max_abs_err": worst, "env": env}
    emit({"phase": "cli_parity", "dumps": parity, "tolerance":
          f"|kernels-plain| <= {F32_ATOL} + {F32_RTOL}*|plain| every key"})
    torch.cuda.empty_cache()

    # (e) demo: a 48-frame 720p video, boxes against a direct Tracker
    frames, boxes = synthetic_sequence(CLI_DEMO_FRAMES - 1, args.seed + 21)
    video = tmp / "clip.avi"
    writer = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"MJPG"), 30, (1280, 720))
    for f in frames:
        writer.write(np.ascontiguousarray(f[..., ::-1]))
    writer.release()
    cap, decoded = cv2.VideoCapture(str(video)), []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        decoded.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    cap.release()
    built, orig = [], cli_test.build_tracker
    cli_test.build_tracker = lambda *a, **k: built.append(orig(*a, **k)) or built[-1]
    try:
        init = [str(v) for v in boxes[0]]
        dboxes, out, got, secs = cli_capture(cli_demo.main, [
            "--video", str(video), "--output", str(tmp / "demo.mp4"), "--init_bbox", *init])
    finally:
        cli_test.build_tracker = orig
    proto = built[0]
    g = graph_launches(proto.jt)
    add(got)
    add(g, glaunch)
    cap, n_out = cv2.VideoCapture(str(tmp / "demo.mp4")), 0
    while cap.read()[0]:
        n_out += 1
    cap.release()
    direct = Tracker(proto.cfg, tokenizer=proto.tokenizer, jit_tracker=proto.jt)
    want = [direct.initialize(decoded[0], {"init_bbox": [float(v) for v in init]})["target_bbox"]]
    want += [direct.track(f)["target_bbox"] for f in decoded[1:]]
    if not (len(decoded) == n_out == len(dboxes) == CLI_DEMO_FRAMES):
        raise AssertionError(f"demo: {len(decoded)} frames in, {n_out} out, {len(dboxes)} boxes")
    if np.asarray(dboxes, np.float64).tolist() != np.asarray(want, np.float64).tolist():
        raise AssertionError("demo: the boxes differ from a direct Tracker's")
    emit({"phase": "cli_demo", "frames_in": len(decoded), "frames_out": n_out,
          "boxes_bitwise_direct": len(want), "seconds": secs, "launches": got,
          "graph_launches": g, "video": "MJPG 1280x720 (cv2), out mp4v"})
    del proto, direct, built
    torch.cuda.empty_cache()

    # (f) cli.test on a trainer checkpoint (ep0001.pt) against a direct replay
    cfg = load_cfg(str(REPO / "experiments/uvltrack/baseline_base.yaml"))
    trained = build_model(cfg, device=dev, seed=args.seed + 5)
    pt = CheckpointManager(str(tmp / "ckpt")).save(
        1, create_train_state(trained, build_optimizer(cfg, trained)))
    w_saved = trained.backbone.vit.blocks[0].attn.qkv.weight.detach().to(torch.bfloat16)
    del trained
    write_eval_dataset(tmp, args.seed, lengths=(24,))
    environment.reset_env_cache()
    seqs = list(get_dataset("otb99"))
    run = cli_run("f_B_trainer_ckpt", ["uvltrack", "baseline_base", "--dataset_name", "otb99",
                                       "--set", "TEST.MODE=BBOX", "--set", "TEST.THRESHOLD=-1",
                                       "--set", f"MODEL.BACKBONE.LANGUAGE.VOCAB_PATH={vocab}",
                                       "--test_checkpoint", pt], results, PER_FWD_FP)
    proto = run["proto"]
    if not torch.equal(proto.model.backbone.vit.blocks[0].attn.qkv.weight, w_saved):
        raise AssertionError("cli.test: the tracker's weights are not the checkpoint's")
    d = direct_single(proto, seqs, tmp / "direct_f", Decoded())
    files = same_files("f_B_trainer_ckpt", results / "uvltrack" / "baseline_base" /
                       "otb99_BBOX_0300", tmp / "direct_f", seqs)
    add(run["launches"])
    add(run["graph_launches"], glaunch)
    emit({"phase": "cli_test_trainer_ckpt", "checkpoint": "ep0001.pt (train/checkpoint.py, "
          "a TrainState of the seed+5 model)", "result_files_bitwise_direct": files,
          "frames": len(seqs[0].frames), "step_ms_p50": float(np.percentile(d["lat"], 50) * 1e3),
          "launches": run["launches"], "graph_launches": run["graph_launches"],
          "group_seconds": time.perf_counter() - t_group})
    del run, proto
    torch.cuda.empty_cache()
    return {"f32w": f32w, "launches": launches, "graph_launches": glaunch}


# ---------------------------------------------------------------- parallel
# dp=2 on one card: two processes on cuda:0 over gloo, chosen and named here:
# NCCL refuses two ranks on one GPU, so gloo is the one cross-process check one
# card allows (gloo runs its all_reduce and all_gather of CUDA tensors through
# the host). Cases: B-TRAIN (8 samples x 2 search frames, the rotation local)
# with ZeRO-1 off and on, and 16 samples x 1 search frame (the rotation
# crosses ranks: the all_gather exchange under autograd).
DP_BACKEND = "gloo"
# ZeRO-1 against the replicated step (the JAX package's test_train_stack bound)
Z1_RTOL, Z1_ATOL = 1e-3, 1e-4
DP_CASES = (("replicated", {}, False), ("zero1", {}, True),
            ("search1", {"DATA.SEARCH.NUMBER": 1, "TRAIN.BATCH_SIZE": 16}, False))
DP_STEPS = 3  # step 1 gated, steps 2-3 timed
DP_TIMEOUT_S = 600
# the stream mesh on one card: two replicas on cuda:0 against the unsharded
# BatchTracker, frame by frame from a shared state, at S=8 and S=5 (S_pad 6)
MESH_AB_STEPS = 16  # before the first re-mine (frame 20)
MESH_TIMED_STEPS = 24  # a re-mine at 20 in each run
PAR_EVAL_LENGTHS = (24, 30, 20, 26)  # cli.test --streams 4 over 4 ragged sequences
DP_TIMER = ("host clock per train_step (forward, backward, the gradient all_reduce, clip, "
            "AdamW), each ending in a read of its loss; dp=2: the two processes share one "
            "card and reduce through gloo over the host")
MESH_TIMER = ("host clock per BatchTracker.step on the CUDA graphs (upload, every replica's "
              "replays, the read-back of the (S, 5) rows); runs in turns unsharded, mesh, "
              "mesh, unsharded")


class PairedOptimizer:
    """ZeRO-1 against the replicated update of the same gradients: step()
    hands the gradients the train step left on `model` to a second model's
    parameters, then steps both optimizers (the backward on the card is not
    bitwise repeatable, and Adam's first step moves a parameter whose
    gradient is rounding noise by +-lr either way, so two runs are compared
    from one backward)."""

    def __init__(self, model, zero1, follow_model, follow):
        self.model, self.zero1 = model, zero1
        self.follow_model, self.follow = follow_model, follow

    def step(self, step: int):
        for a, b in zip(self.model.parameters(), self.follow_model.parameters()):
            b.grad = None if a.grad is None else a.grad.clone()
        norm = self.zero1.step(step)
        self.follow.step(step)
        return norm


def dp_worker(args) -> int:
    """One rank of the dp=2 run (a child of the parallel group): every case
    of DP_CASES from the seed's init on this rank's rows of the global
    batch, DP_STEPS steps; writes rank<R>.json (losses, grad_norms, step
    ms, launches, Adam moment bytes; step 1 under ZeRO-1 against the
    replicated update of the same gradients)."""
    import numpy as np
    import torch

    from uvltrack_tpu_torch.data.synthetic import synthetic_batch_from_cfg
    from uvltrack_tpu_torch.ops import build
    from uvltrack_tpu_torch.parallel.mesh import init_distributed, make_mesh, shard_batch
    from uvltrack_tpu_torch.train.step import setup_sharded_training

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = Path(args.dp_worker)
    dev = init_distributed(torch.device("cuda"), backend=DP_BACKEND)
    mesh = make_mesh(data=-1, devices=[dev])
    res = {"rank": mesh.rank, "world": mesh.world, "device": str(dev), "backend": DP_BACKEND}
    for case, over, zero1 in DP_CASES:
        cfg = train_config(**over)
        batch = synthetic_batch_from_cfg(np.random.default_rng(args.seed), cfg,
                                         int(cfg.TRAIN.BATCH_SIZE))
        local = {k: torch.from_numpy(v).to(dev) for k, v in shard_batch(mesh, batch).items()}
        _, state, step = setup_sharded_training(cfg, mesh, 1, device=dev, seed=args.seed,
                                                zero1=zero1)
        ref = None
        if zero1:  # the replicated update of step 1's gradients beside it
            _, ref, _ = setup_sharded_training(cfg, mesh, 1, device=dev, seed=args.seed)
            z1_opt = state.optimizer
            state.optimizer = PairedOptimizer(state.model, z1_opt, ref.model, ref.optimizer)
        before = build.instantiation_counts()
        runs = []
        for i in range(DP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, local)
            loss = float(m["Loss/total"])
            runs.append({"ms": (time.perf_counter() - t0) * 1e3, "loss": loss,
                         "grad_norm": float(m["grad_norm"])})
            if ref is not None:
                worst = max(float(((p - r).abs() - Z1_RTOL * r.abs()).max() / Z1_ATOL)
                            for p, r in zip(state.model.parameters(), ref.model.parameters()))
                same = sum(int(torch.equal(p, r)) for p, r in zip(state.model.parameters(),
                                                                  ref.model.parameters()))
                res["zero1_vs_replicated_step1"] = {
                    "max_excess_over_atol": worst,
                    "parameters_bitwise_equal": f"{same}/{len(list(ref.model.parameters()))}",
                    "rule": f"|zero1 - replicated| <= {Z1_ATOL} + {Z1_RTOL} x |replicated|, "
                            "both updates from the same gradients"}
                state.optimizer, ref = z1_opt, None
                torch.cuda.empty_cache()
        res[case] = {"rows": int(local["flag"].shape[0] * local["search_images"].shape[0]),
                     "losses": [r["loss"] for r in runs],
                     "grad_norms": [r["grad_norm"] for r in runs], "ms": [r["ms"] for r in runs],
                     "launches": launches_since(before),
                     "moment_bytes": state.optimizer.moment_bytes()}
        del state, step, local
        torch.cuda.empty_cache()
    (out_dir / f"rank{mesh.rank}.json").write_text(json.dumps(res))
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_phase(args, dev, tmp: Path) -> dict:
    """dp=2 on one card (two gloo processes, dp_worker) against the dp=1 step
    on the same rows in turns (dp=1, dp=2, dp=1): step 1 under B-TRAIN's
    gate (loss within TRAIN_LOSS_REL; grad_norm within max(TRAIN_NORM_REL,
    2 x the plain backend's move under a 2^-12 input change)), ZeRO-1's
    parameters within Z1_RTOL / Z1_ATOL of the replicated step's, each rank's
    Adam moment bytes. Returns the launches of the dp=1 steps and of both
    ranks' steps."""
    import gc
    from collections import Counter

    import numpy as np
    import torch

    from uvltrack_tpu_torch.data.synthetic import synthetic_batch_from_cfg
    from uvltrack_tpu_torch.ops import build
    from uvltrack_tpu_torch.train.step import setup_training

    total = Counter()

    def dp1(case_over, n):
        cfg = train_config(**case_over)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in synthetic_batch_from_cfg(
            np.random.default_rng(args.seed), cfg, int(cfg.TRAIN.BATCH_SIZE)).items()}
        _, state, step = setup_training(cfg, 1, device=dev, seed=args.seed)
        probes = {"plain": _probe(state.model, batch, cfg, "plain"),
                  "plain_eps": _probe(state.model, batch, cfg, "plain", TRAIN_PROBE_EPS,
                                      args.seed)}
        before = build.instantiation_counts()
        state, runs = _train_run(state, step, batch, "cuda", n)
        total.update(launches_since(before))
        moments = state.optimizer.moment_bytes()
        del state, step, batch
        gc.collect()
        torch.cuda.empty_cache()
        sens = abs(probes["plain_eps"]["grad_norm"] - probes["plain"]["grad_norm"]) / probes[
            "plain"]["grad_norm"]
        return runs, sens, moments

    t0 = time.perf_counter()
    first = {case: dp1(over, DP_STEPS) for case, over, _ in DP_CASES if case != "zero1"}
    port = free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                   RANK=str(rank), LOCAL_RANK="0")
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), "--seed", str(args.seed),
             "--dp-worker", str(tmp)], env=env, cwd=str(REPO), text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    t_dp2 = time.perf_counter()
    try:
        logs = [p.communicate(timeout=DP_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    t_dp2 = time.perf_counter() - t_dp2
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"dp=2 rank {rank} exited {p.returncode}:\n{log[-3000:]}")
    ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]
    second = {case: dp1(over, 2) for case, over, _ in DP_CASES if case != "zero1"}
    gates = {}
    for case, _, _ in DP_CASES:
        ref_case = "replicated" if case == "zero1" else case
        runs, sens, _ = first[ref_case]
        bound = max(TRAIN_NORM_REL, 2 * sens)
        for r in ranks:
            for k in r[case]["launches"]:
                total[k] += r[case]["launches"][k]
            if r[case]["losses"] != ranks[0][case]["losses"]:
                raise AssertionError(f"dp=2 {case}: the ranks' losses differ: "
                                     f"{[x[case]['losses'] for x in ranks]}")
            expect_launches(TRAIN_PER_FWD, DP_STEPS, r[case]["launches"],
                            f"dp=2 {case} rank {r['rank']}")
        loss_rel, norm_rel = step1_gate(
            {"loss": ranks[0][case]["losses"][0], "grad_norm": ranks[0][case]["grad_norms"][0]},
            runs[0], bound, f"dp=2 {case} vs dp=1")
        gates[case] = {"loss_rel": loss_rel, "grad_norm_rel": norm_rel, "grad_norm_bound": bound,
                       "plain_grad_norm_move_at_eps": sens}
    z = ranks[0]["zero1_vs_replicated_step1"]
    if z["max_excess_over_atol"] > 1.0:
        raise AssertionError(f"ZeRO-1 vs replicated after step 1: {z}")
    dp1_ms = {case: _p50([r["ms"] for r in first[case][0][1:] + second[case][0]])
              for case in first}
    dp2_ms = {case: _p50(sum((r[case]["ms"][1:] for r in ranks), [])) for case, _, _ in DP_CASES}
    out = {"phase": "parallel_dp", "config": "experiments/uvltrack/baseline_base.yaml",
           "backend": DP_BACKEND, "why_gloo": "NCCL refuses two ranks on one GPU; gloo is the "
           "cross-process check one card allows (all_reduce and all_gather of CUDA tensors, "
           "through the host)",
           "processes": 2, "device": ranks[0]["device"], "timer": DP_TIMER,
           "cases": {case: {"over": over, "zero1": z1, "global_rows": TRAIN_B,
                            "rows_per_rank": ranks[0][case]["rows"]}
                     for case, over, z1 in DP_CASES},
           "gate": f"step 1, dp=2 vs dp=1 on the same rows (relative): loss within "
                   f"{TRAIN_LOSS_REL}, grad_norm within max({TRAIN_NORM_REL}, 2 x the plain "
                   "backend's move under a 2^-12 input change)",
           "step1": gates, "zero1_vs_replicated_step1": z,
           "losses": {"dp1": {c: [r["loss"] for r in first[c][0]] for c in first},
                      "dp2": {c: ranks[0][c]["losses"] for c, _, _ in DP_CASES}},
           "grad_norms": {"dp1": {c: [r["grad_norm"] for r in first[c][0]] for c in first},
                          "dp2": {c: ranks[0][c]["grad_norms"] for c, _, _ in DP_CASES}},
           "step_ms_p50": {"dp1": dp1_ms, "dp2": dp2_ms},
           "samples_per_s": {"dp1": {c: TRAIN_B / (dp1_ms[c] / 1e3) for c in dp1_ms},
                             "dp2": {c: TRAIN_B / (dp2_ms[c] / 1e3) for c in dp2_ms}},
           "adam_moment_mb_per_rank": {
               "dp1": first["replicated"][2] / 2 ** 20,
               **{f"dp2_{c}": [r[c]["moment_bytes"] / 2 ** 20 for r in ranks]
                  for c in ("replicated", "zero1")}},
           "launches_per_step_per_rank": TRAIN_PER_FWD, "dp2_wall_s": t_dp2,
           "seconds": time.perf_counter() - t0}
    emit(out)
    return dict(total)


# tp=2 on one card: two gloo processes on cuda:0
# form the model group (dp=1), each holding its slices of full-width,
# full-depth UVLTrack-B (shard_params_tp; seed-0 init) and stepping B-TRAIN's
# 16 rows; each case is held to the tp=1 step on the same rows and knobs, in
# turns (tp=1, tp=2, tp=1), by B-TRAIN's step-1 gate
TP_CASES = (("default", {}, 3), ("fused_proj", {"UVLTRACK_FUSED_PROJ": "1"}, 1),
            ("fused_mlp", {"UVLTRACK_FUSED_MLP": "1"}, 1))
# launches a step makes on each tp=2 rank: #1/#2 at H/tp heads as at tp=1;
# under the knobs the projection's share on proj_residual's fp32-x
# instantiation in all 12 blocks (a zero fp32 stream), the MLP's share with
# fc2_bias's fp32 out
TP_PER_FWD = {"default": TRAIN_PER_FWD,
              "fused_proj": dict(TRAIN_PER_FWD, **{"proj_residual[fp32x-bf16a-bf16w]": 12}),
              "fused_mlp": dict(TRAIN_PER_FWD, **{"ln_mlp[bf16x-bf16w-fp32o]": 6,
                                                  "ln_mlp[fp32x-bf16w-fp32o]": 6})}
TP1_PER_FWD = {"default": TRAIN_PER_FWD, "fused_proj": TRAIN_KNOBS[0][2],
               "fused_mlp": TRAIN_KNOBS[1][2]}
TP_TIMER = ("host clock per train_step (forward, backward with the model group's "
            "all_reduces, clip, AdamW), each ending in a read of its loss; tp=2: the two "
            "processes share one card and reduce through gloo over the host, so this is "
            "not a TP speed")


@contextlib.contextmanager
def knob_env(env: dict):
    """The environment knobs `env` set for the body, restored after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            os.environ.pop(k) if v is None else os.environ.__setitem__(k, v)


def tp_worker(args) -> int:
    """One rank of the tp=2 run (a child of the parallel group): every case
    of TP_CASES from the seed's init on B-TRAIN's rows; writes
    tp_rank<R>.json (losses, grad_norms, step ms, launches, the split
    blocks' shapes, parameter and Adam moment bytes)."""
    import numpy as np
    import torch

    from uvltrack_tpu_torch.data.synthetic import synthetic_batch_from_cfg
    from uvltrack_tpu_torch.ops import build
    from uvltrack_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from uvltrack_tpu_torch.train.step import setup_sharded_training

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = Path(args.tp_worker)
    dev = init_distributed(torch.device("cuda"), backend=DP_BACKEND)
    mesh = make_mesh(data=1, model=2, devices=[dev])
    res = {"rank": mesh.rank, "model_index": mesh.model_index, "device": str(dev)}
    for case, env, steps in TP_CASES:
        cfg = train_config()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in synthetic_batch_from_cfg(
            np.random.default_rng(args.seed), cfg, int(cfg.TRAIN.BATCH_SIZE)).items()}
        model, state, step = setup_sharded_training(cfg, mesh, 1, device=dev, seed=args.seed,
                                                    tensor_parallel=True)
        blk = model.backbone.vit.blocks[0]
        with knob_env(env):
            before = build.instantiation_counts()
            state, runs = _train_run(state, step, batch, "cuda", steps, TP_PER_FWD[case])
        res[case] = {"losses": [r["loss"] for r in runs],
                     "grad_norms": [r["grad_norm"] for r in runs], "ms": [r["ms"] for r in runs],
                     "launches": launches_since(before),
                     "block_shapes": {"heads": blk.attn.num_heads,
                                      "qkv": list(blk.attn.qkv.weight.shape),
                                      "proj": list(blk.attn.proj.weight.shape),
                                      "fc1": list(blk.mlp.fc1.weight.shape),
                                      "fc2": list(blk.mlp.fc2.weight.shape)},
                     "param_bytes": sum(p.numel() * p.element_size()
                                        for p in model.parameters()),
                     "moment_bytes": state.optimizer.moment_bytes()}
        del model, state, step, batch
        torch.cuda.empty_cache()
    (out_dir / f"tp_rank{mesh.rank}.json").write_text(json.dumps(res))
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def tp_phase(args, dev, tmp: Path) -> dict:
    """tp=2 on one card (two gloo processes, tp_worker) against the tp=1 step
    on the same rows and knobs, in turns (tp=1, tp=2, tp=1): step 1 of each
    case under B-TRAIN's gate (loss within TRAIN_LOSS_REL; grad_norm within
    max(TRAIN_NORM_REL, 2 x the plain backend's move under a 2^-12 input
    change)); both ranks' losses equal; each rank's launches per step;
    parameter and Adam moment bytes a rank against tp=1. Returns the
    launches of the tp=1 steps and of both ranks' steps."""
    import gc
    from collections import Counter

    import numpy as np
    import torch

    from uvltrack_tpu_torch.data.synthetic import synthetic_batch_from_cfg
    from uvltrack_tpu_torch.models.vit import VIT_VARIANTS
    from uvltrack_tpu_torch.ops import build
    from uvltrack_tpu_torch.train.step import setup_training

    total = Counter()
    cfg = train_config()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in synthetic_batch_from_cfg(
        np.random.default_rng(args.seed), cfg, int(cfg.TRAIN.BATCH_SIZE)).items()}

    def tp1(case, env, n, probe=False):
        model, state, step = setup_training(cfg, 1, device=dev, seed=args.seed)
        sens = None
        if probe:  # the plain backend ignores the knobs: one yardstick for every case
            p0 = _probe(state.model, batch, cfg, "plain")
            p1 = _probe(state.model, batch, cfg, "plain", TRAIN_PROBE_EPS, args.seed)
            sens = abs(p1["grad_norm"] - p0["grad_norm"]) / p0["grad_norm"]
        with knob_env(env):
            before = build.instantiation_counts()
            state, runs = _train_run(state, step, batch, "cuda", n, TP1_PER_FWD[case])
            total.update(launches_since(before))
        sizes = (sum(p.numel() * p.element_size() for p in model.parameters()),
                 state.optimizer.moment_bytes())
        del model, state, step
        gc.collect()
        torch.cuda.empty_cache()
        return runs, sens, sizes

    t0 = time.perf_counter()
    first = {case: tp1(case, env, n, probe=case == "default") for case, env, n in TP_CASES}
    sens = first["default"][1]
    port = free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                   RANK=str(rank), LOCAL_RANK="0")
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), "--seed", str(args.seed),
             "--tp-worker", str(tmp)], env=env, cwd=str(REPO), text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    t_tp2 = time.perf_counter()
    try:
        logs = [p.communicate(timeout=DP_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    t_tp2 = time.perf_counter() - t_tp2
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"tp=2 rank {rank} exited {p.returncode}:\n{log[-3000:]}")
    ranks = [json.loads((tmp / f"tp_rank{r}.json").read_text()) for r in range(2)]
    second = {case: tp1(case, env, n) for case, env, n in TP_CASES}
    bound = max(TRAIN_NORM_REL, 2 * sens)
    gates = {}
    for case, _, n in TP_CASES:
        for r in ranks:
            for k, v in r[case]["launches"].items():
                total[k] += v
            if r[case]["losses"] != ranks[0][case]["losses"]:
                raise AssertionError(f"tp=2 {case}: the ranks' losses differ: "
                                     f"{[x[case]['losses'] for x in ranks]}")
            if r[case]["block_shapes"]["heads"] != VIT_VARIANTS["base"]["num_heads"] // 2:
                raise AssertionError(f"tp=2 {case}: {r[case]['block_shapes']}")
        gates[case] = dict(zip(("loss_rel", "grad_norm_rel"), step1_gate(
            {"loss": ranks[0][case]["losses"][0], "grad_norm": ranks[0][case]["grad_norms"][0]},
            first[case][0][0], bound, f"tp=2 {case} vs tp=1")))
        gates[case]["tp1_turns_loss"] = [first[case][0][0]["loss"], second[case][0][0]["loss"]]
    tp1_ms = _p50([r["ms"] for r in first["default"][0][1:] + second["default"][0][1:]])
    tp2_ms = _p50(sum((r["default"]["ms"][1:] for r in ranks), []))
    p1, m1 = first["default"][2]
    out = {"phase": "parallel_tp", "config": "experiments/uvltrack/baseline_base.yaml",
           "backend": DP_BACKEND, "processes": 2, "mesh": {"data": 1, "model": 2},
           "device": ranks[0]["device"], "timer": TP_TIMER, "global_rows": TRAIN_B,
           "cases": {case: {"env": env, "steps": n} for case, env, n in TP_CASES},
           "block_shapes_per_rank": ranks[0]["default"]["block_shapes"],
           "gate": f"step 1, tp=2 vs tp=1 on the same rows and knobs (relative): loss within "
                   f"{TRAIN_LOSS_REL}, grad_norm within max({TRAIN_NORM_REL}, 2 x the plain "
                   "backend's move under a 2^-12 input change)",
           "grad_norm_bound": bound, "plain_grad_norm_move_at_eps": sens, "step1": gates,
           "losses": {"tp1": {c: [r["loss"] for r in first[c][0]] for c in first},
                      "tp2": {c: ranks[0][c]["losses"] for c, _, _ in TP_CASES}},
           "grad_norms": {"tp1": {c: [r["grad_norm"] for r in first[c][0]] for c in first},
                          "tp2": {c: ranks[0][c]["grad_norms"] for c, _, _ in TP_CASES}},
           "launches_per_rank": {c: ranks[0][c]["launches"] for c, _, _ in TP_CASES},
           "step_ms_p50": {"tp1": tp1_ms, "tp2": tp2_ms},
           "param_mb_per_rank": {"tp1": p1 / 2 ** 20,
                                 "tp2": [r["default"]["param_bytes"] / 2 ** 20 for r in ranks]},
           "adam_moment_mb_per_rank": {"tp1": m1 / 2 ** 20,
                                       "tp2": [r["default"]["moment_bytes"] / 2 ** 20
                                               for r in ranks]},
           "bytes_ratio_tp2_over_tp1": ranks[0]["default"]["param_bytes"] / p1,
           "tp2_wall_s": t_tp2, "seconds": time.perf_counter() - t0}
    emit(out)
    return dict(total)


def multihost_cli(args, tmp: Path) -> dict:
    """cli.train.main --multihost at world size 1 on NCCL (this process as
    rank 0 of torchrun's environment): 2 synthetic steps and a checkpoint.
    Returns its launches."""
    import torch

    from uvltrack_tpu_torch.cli import train as ctrain
    from uvltrack_tpu_torch.ops import build

    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()), "WORLD_SIZE": "1",
           "RANK": "0", "LOCAL_RANK": "0"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    argv = ["--config", "baseline_base", "--synthetic", "2", "--epochs", "1", "--multihost",
            "--seed", str(args.seed), "--save_dir", str(tmp)]
    dist, backends = torch.distributed, []
    init = dist.init_process_group

    def record(backend, *a, **kw):  # the backend the CLI chose
        backends.append(backend)
        return init(backend, *a, **kw)

    before = build.instantiation_counts()
    t0 = time.perf_counter()
    dist.init_process_group = record
    try:
        trainer = ctrain.main(argv)
    finally:
        dist.init_process_group = init
        for k, v in old.items():
            os.environ.pop(k) if v is None else os.environ.__setitem__(k, v)
    seconds = time.perf_counter() - t0
    launches = launches_since(before)
    ck = tmp / "checkpoints" / "train" / "uvltrack" / "baseline_base"
    files = sorted(os.listdir(ck))
    if trainer.state.step != 2 or files != ["ep0001.pt"] or torch.distributed.is_initialized():
        raise AssertionError(f"cli.train --multihost: step {trainer.state.step}, {files}")
    expect_launches(TRAIN_PER_FWD, 2, launches, "cli.train --multihost")
    if backends != ["nccl"]:
        raise AssertionError(f"cli.train --multihost on the card initialized {backends}")
    emit({"phase": "parallel_multihost_cli", "argv": " ".join(argv), "backend": backends[0],
          "world_size": 1, "env": sorted(env), "checkpoints": files, "seconds": seconds,
          "launches": launches})
    del trainer
    return launches


def stream_mesh_phase(model, cfg, seqs, per_fwd) -> list:
    """Two replicas on cuda:0 (make_mesh(devices=[cuda:0, cuda:0])) against
    the unsharded BatchTracker at S=8 and S=5 (S_pad 6, a pad stream): every
    step from the unsharded tracker's state on the eager debug step
    (paired_ab's rule; the rows bitwise equal counted; each replica launches
    one forward's kernels a step); then the CUDA graphs in turns: step ms,
    stream-frames/s, the profiler's busy share, and each replica's step
    graph holding one forward's launches. Returns the JitTrackers."""
    import numpy as np
    import torch

    from uvltrack_tpu_torch.ops import attention, build
    from uvltrack_tpu_torch.parallel.mesh import make_mesh
    from uvltrack_tpu_torch.track.batch import BatchTracker

    dev = next(model.parameters()).device
    mesh = make_mesh(devices=[dev, dev])
    jts = []
    attention.force_backend("cuda")
    for S in (8, 5):
        t_cell = time.perf_counter()
        frames0 = [seqs[i][0][0] for i in range(S)]
        boxes0 = np.asarray([seqs[i][1][0] for i in range(S)], np.float32)
        batches = [np.stack([seqs[i][0][t] for i in range(S)])
                   for t in range(1, MESH_TIMED_STEPS + 1)]
        one = BatchTracker(cfg, model, S)
        sharded = BatchTracker(cfg, model, S, mesh=mesh)
        if (sharded.S_pad, [r.S for r in sharded.replicas]) != (2 * -(-S // 2), [-(-S // 2)] * 2):
            raise AssertionError(f"mesh S={S}: S_pad {sharded.S_pad}")
        one.initialize(frames0, boxes0)
        sharded.initialize(frames0, boxes0)
        tally, bitwise, rows = AbTally(f"mesh S={S} sharded/unsharded"), 0, 0
        for batch in batches[:MESH_AB_STEPS]:
            st = one.state
            sharded.state = st
            a, am = (t.float().cpu().numpy() for t in one.step_async(batch, debug=True))
            before = build.instantiation_counts()
            b, bm = (t.float().cpu().numpy() for t in sharded.step_async(batch, debug=True))
            expect_launches(per_fwd, len(sharded.replicas), launches_since(before),
                            f"mesh S={S} step")
            for i in range(S):
                tally.add(a[i, :4], am[i, 2], b[i, :4], bm[i, 2],
                          crop_side(st.box[i].tolist(), one.search_factor))
                bitwise += int(np.array_equal(a[i], b[i]))
                rows += 1

        def run(bt):
            bt.initialize(frames0, boxes0)
            lat = []
            for batch in batches:
                t0 = time.perf_counter()
                out = bt.step(batch)
                lat.append(time.perf_counter() - t0)
            if not np.isfinite(out).all() or out.shape != (S, 5):
                raise AssertionError(f"mesh S={S}: output {out.shape}")
            return lat

        lats = {"unsharded": [], "mesh": []}
        for name, bt in (("unsharded", one), ("mesh", sharded), ("mesh", sharded),
                         ("unsharded", one)):
            lats[name].append(run(bt))
        if sharded.remines.tolist() != [MESH_TIMED_STEPS // 20] * S:
            raise AssertionError(f"mesh S={S}: re-mines {sharded.remines.tolist()}")
        caps = {}
        for r, rep in enumerate(sharded.replicas):
            keys = rep.jt.keys()
            remine = eager_remine_launches(rep)
            caps[f"replica{r}"] = check_captures(rep.jt, keys, per_fwd, remine,
                                                 f"mesh S={S} replica {r}")
            jts.append(rep.jt)
        busy = {}
        for name, bt in (("unsharded", one), ("mesh", sharded)):
            bt.initialize(frames0, boxes0)
            bt.step(batches[0])
            busy[name] = profile_window(lambda j, bt=bt: bt.step(batches[1 + j]), 8, "step")
        stats = {k: lat_stats(sum(v, []), "step") for k, v in lats.items()}
        emit({"phase": f"parallel_stream_mesh_S{S}", "S": S, "S_pad": sharded.S_pad,
              "replicas": len(sharded.replicas), "device": str(dev),
              "rows_per_replica": sharded.per, "timer": MESH_TIMER,
              "paired": tally.summary(), "rows_bitwise_equal": f"{bitwise}/{rows}",
              "launches_per_replica_step": per_fwd,
              "graph_captures": caps,
              "step_ms_p50": {k: v["p50_ms"] for k, v in stats.items()},
              "step_ms_p90": {k: v["p90_ms"] for k, v in stats.items()},
              "stream_frames_per_s": {k: S * v["steps_per_s"] for k, v in stats.items()},
              "device_profile": busy, "seconds": time.perf_counter() - t_cell})
    attention.force_backend(None)
    return jts


def mesh_cli_phase(args, model, cfg, vocab: Path, tmp: Path, seqs) -> dict:
    """cli.test --multichip --streams 4 over 4 ragged 720p sequences of the
    eval group's kind: the same result files, byte for byte, as --streams 4
    without it; then cli/serve's --multichip --lockstep 4 server (make_server
    on the mesh the CLI makes) against a direct unsharded StreamPool, bit
    for bit. On one card the mesh of the visible cards has one replica.
    Returns the JitTrackers of the meshes' replicas and the eager launches."""
    import threading

    import numpy as np

    from uvltrack_tpu_torch.cli.serve import make_server
    from uvltrack_tpu_torch.eval import environment
    from uvltrack_tpu_torch.ops import attention
    from uvltrack_tpu_torch.parallel.mesh import local_devices, make_mesh
    from uvltrack_tpu_torch.track import batch as tbatch
    from uvltrack_tpu_torch.track.pool import StreamPool
    from uvltrack_tpu_torch.track.tracker import Tracker

    t0 = time.perf_counter()
    write_eval_dataset(tmp, args.seed, PAR_EVAL_LENGTHS)
    results = tmp / "results"
    os.environ.update({"UVLTRACK_REPO": str(REPO), "UVLTRACK_OTB99_PATH": str(tmp / "otb99"),
                       "UVLTRACK_GOT10K_PATH": str(tmp / "got10k"),
                       "UVLTRACK_RESULTS_PATH": str(results)})
    environment.reset_env_cache()
    made, orig = [], tbatch.MeshBatchTracker.__init__

    def spy(self, *a, **kw):
        orig(self, *a, **kw)
        made.append(self)

    tbatch.MeshBatchTracker.__init__ = spy
    common = ["uvltrack", "baseline_base", "--dataset_name", "otb99", "--set",
              "TEST.THRESHOLD=-1", "--set", "TEST.MODE=NLBBOX", "--set",
              f"MODEL.BACKBONE.LANGUAGE.VOCAB_PATH={vocab}", "--streams", "4"]
    launches = {}
    try:
        runs = {label: cli_run(label, common + extra, results, PER_FWD_FP)
                for label, extra in (("streams4", ["--runid", "1"]),
                                     ("streams4_multichip", ["--runid", "2", "--multichip"]))}
    finally:
        tbatch.MeshBatchTracker.__init__ = orig
    for run in runs.values():
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v
    a, b = (results / "uvltrack" / f"baseline_base_00{i}" / "otb99_NLBBOX_0300" for i in (1, 2))
    names = sorted(f.name for f in a.iterdir() if f.suffix == ".txt"
                   and not f.name.endswith("_time.txt"))
    differ = [n for n in names if (a / n).read_bytes() != (b / n).read_bytes()]
    if len(names) != len(PAR_EVAL_LENGTHS) or differ or not made:
        raise AssertionError(f"cli.test --multichip: result files {names}, differing {differ}, "
                             f"meshes {len(made)}")
    jts = [rep.jt for bt in made for rep in bt.replicas]

    # cli/serve --multichip --lockstep 4: the mesh the CLI makes, 12 rounds
    attention.force_backend("cuda")
    scfg = cfg.clone()
    scfg.TEST.MODE = "BBOX"
    proto = Tracker(scfg, model)
    mesh = make_mesh(data=-1, model=1, devices=local_devices(proto.device))
    server = make_server(proto, "127.0.0.1", 0, lockstep=4, batch_window=1.0, mesh=mesh)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    direct = StreamPool(scfg, None, 4, jit_tracker=proto.jt)
    served, wanted = [], []
    try:
        for i, s in enumerate("ABCD"):
            _post_npy(url, "/initialize", {"stream": s, "bbox": seqs[i][1][0]}, seqs[i][0][0])
            direct.open(s, seqs[i][0][0], {"init_bbox": seqs[i][1][0]})
        for r in range(1, 13):
            out, errs = {}, []

            def go(s, r=r):
                try:
                    out[s] = _post_npy(url, "/track", {"stream": s}, seqs["ABCD".index(s)][0][r])
                except Exception as e:  # fails the phase below
                    errs.append(f"{s}: {e}")

            threads = [threading.Thread(target=go, args=(s,)) for s in "ABCD"]
            [t.start() for t in threads]
            [t.join() for t in threads]
            if errs:
                raise AssertionError(f"serve --multichip round {r}: {errs}")
            served.append(out)
            with proto.jt.lock:
                wanted.append(direct.submit({s: seqs["ABCD".index(s)][0][r] for s in "ABCD"}))
    finally:
        server.dispatcher.stop()
        server.shutdown()
        server.server_close()
        attention.force_backend(None)
    for r, (got, want) in enumerate(zip(served, wanted)):
        for s in got:
            if got[s]["bbox"] != want[s]["bbox"] or got[s]["score"] != want[s]["score"]:
                raise AssertionError(f"serve --multichip round {r} {s}: {got[s]} != {want[s]}")
    jts += [rep.jt for rep in server.pool.bt.replicas]
    emit({"phase": "parallel_mesh_cli", "cards_visible": len(local_devices(proto.device)),
          "replicas": {"cli_test": [len(bt.replicas) for bt in made],
                       "serve": len(server.pool.bt.replicas)},
          "cli_test": {label: {"seconds": run["seconds"], "fps": runner_fps(run["out"])}
                       for label, run in runs.items()},
          "result_files_equal": f"{len(names)}/{len(names)}",
          "serve_lockstep4_rounds": len(served), "served_equal_direct": True,
          "seconds": time.perf_counter() - t0})
    return {"jts": jts, "launches": launches}


def _post_npy(url: str, route: str, payload: dict, img) -> dict:
    """POST payload with `img` as an "npy" body; the parsed 200 reply."""
    import base64
    import io
    import urllib.request

    import numpy as np

    buf = io.BytesIO()
    np.save(buf, img)
    body = dict(payload, image=base64.b64encode(buf.getvalue()).decode(), format="npy")
    req = urllib.request.Request(url + route, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def parallel_phase(args, dev, model, cfg, vocab: Path, seqs) -> dict:
    """The `parallel` group: dp_phase, tp_phase, multihost_cli,
    stream_mesh_phase and mesh_cli_phase. Returns {"train_launches" (dp=1,
    both dp=2 ranks, tp=1, both tp=2 ranks and the CLI), "launches" (the
    eager tracking paths), "jts" (the replicas' JitTrackers, whose graphs'
    launches the kernels line counts)}."""
    import gc
    import tempfile

    import torch

    t_group = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        train = dp_phase(args, dev, Path(tmp))
    gc.collect()
    torch.cuda.empty_cache()
    t_tp = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
        for k, v in tp_phase(args, dev, Path(tmp)).items():
            train[k] = train.get(k, 0) + v
    t_tp = time.perf_counter() - t_tp
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mh_") as tmp:
        for k, v in multihost_cli(args, Path(tmp)).items():
            train[k] = train.get(k, 0) + v
    gc.collect()
    torch.cuda.empty_cache()
    from uvltrack_tpu_torch.ops import build

    before = build.instantiation_counts()
    jts = stream_mesh_phase(model, cfg, seqs, PER_FWD_FP)
    launches = launches_since(before)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_cli_") as tmp:
        cli = mesh_cli_phase(args, model, cfg, vocab, Path(tmp), seqs)
    for k, v in cli["launches"].items():
        launches[k] = launches.get(k, 0) + v
    emit({"phase": "parallel_group", "seconds": time.perf_counter() - t_group,
          "tp_leg_seconds": t_tp})
    return {"train_launches": train, "launches": launches, "jts": jts + cli["jts"]}


def main() -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--only", default="", help="comma-separated groups of phases to run "
                    f"({', '.join(GROUPS)}; all by default); a partial run prints no "
                    "kernels line")
    ap.add_argument("--dp-worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tp-worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    only = set(filter(None, args.only.split(","))) or set(GROUPS)
    if only - set(GROUPS):
        ap.error(f"--only: unknown groups {sorted(only - set(GROUPS))}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "uvltrack_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout holding uvltrack_tpu_torch/", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    if args.dp_worker:  # one rank of the parallel group's dp=2 run
        return dp_worker(args)
    if args.tp_worker:  # one rank of the parallel group's tp=2 run
        return tp_worker(args)
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

    if "kernels" in only:
        t0 = time.perf_counter()
        worst, times = kernel_phase(dev, args.seed)
        q8_worst, q8_times = q8_kernel_phase(dev, args.seed)
        fused_worst, fused_times = fused_kernel_phase(dev, args.seed)
        tp_kern = tp_kernel_phase(dev, args.seed)
        emit({"phase": "kernels_group", "seconds": time.perf_counter() - t0})

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

    per_fwd_fp = PER_FWD_FP
    t_track = time.perf_counter()
    if "track" in only:
        # NLBBOX and NL on the first 32 frames (a re-mine at 20), as the
        # compiled phase tracks every mode
        for mode, n in (("BBOX", len(frames)), ("NLBBOX", 33), ("NL", 33)):
            add(track_phase(mode, model, cfg, frames[:n], boxes, BertTokenizer(str(vocab)),
                            language, expect=per_fwd_fp))
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
    per_fwd_q8 = PER_FWD_Q8
    if "track" in only:
        track_q8_and_knobs(model, cfg, model_q8, cfg_q8, frames, boxes, vocab, language,
                           per_fwd_fp, per_fwd_q8, add)
        emit({"phase": "track_group", "seconds": time.perf_counter() - t_track})
    # the multistream cells' sequences (a seed and a start on the path each)
    seqs = [synthetic_sequence(32, args.seed + 1 + i, phase=11 * i) for i in range(8)]
    if "multistream" in only:
        add(multistream_phase(model, cfg, model_q8, cfg_q8, BertTokenizer(str(vocab)),
                              language, per_fwd_fp, per_fwd_q8, seqs))
        drift_phase(model, cfg, model_q8, cfg_q8, frames, boxes)
        reference_phase(model_q8, cfg_q8, frames, boxes, label="_q8")
    jts = []
    if "compiled" in only or "serve" in only:
        jts = compiled_phase(model, cfg, model_q8, cfg_q8, BertTokenizer(str(vocab)),
                             language, frames[:COMPILED_FRAMES + 1], boxes, seqs, per_fwd_fp,
                             per_fwd_q8)
    if "serve" in only:
        serve_phase(cfg, jts[0], BertTokenizer(str(vocab)), language, seqs)
    large, eval_counts = None, {"launches": {}, "graph_launches": {}}
    if "eval" in only:
        import tempfile

        # kernels #1, #2 and #5 at UVLTrack-L's width, then the eval runs
        l_worst, l_times = kernel_phase(dev, args.seed, L_WIDTH, L_HEADS, l_grid(), "_L")
        l_q8_worst, l_q8_times = q8_kernel_phase(
            dev, args.seed, L_WIDTH, L_HEADS, l_grid(), "_L",
            names=("ln_qkv[", "#5", "qkv_attention[fp32]"))
        large = {"worst": l_worst, "times": l_times, "q8_worst": l_q8_worst,
                 "q8_times": l_q8_times}
        write_vocab(vocab, list(EVAL_WORDS) + language.split(), args.seed)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
            eval_counts = eval_phase(args, vocab, Path(tmp))
        add(eval_counts["launches"])
    train_counts = {}
    if "train" in only:
        import tempfile

        # the Functions alone, then B-TRAIN (counts from 0 just before it)
        function_phase(dev, args.seed)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
            train_counts = train_phase(args, dev, Path(tmp))
    if "data" in only:
        import faulthandler
        import tempfile

        # a loader pool that hangs (a fork beside the CUDA context) ends the
        # run with every thread's stack instead of holding the card
        faulthandler.dump_traceback_later(DATA_WATCHDOG_S, exit=True)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as tmp:
            data_counts = data_phase(args, dev, Path(tmp))
        faulthandler.cancel_dump_traceback_later()
        for k, v in data_counts.items():
            train_counts[k] = train_counts.get(k, 0) + v
    cli_counts = {"graph_launches": {}}
    if "cli" in only:
        import tempfile

        with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
            cli_counts = cli_phase(args, dev, vocab, Path(tmp))
        add(cli_counts["launches"])
    if "parallel" in only:
        # dp=2 over gloo on one card, cli.train --multihost, the stream mesh
        par = parallel_phase(args, dev, model, cfg, vocab, seqs)
        add(par["launches"])
        jts = list(jts) + par["jts"]
        for k, v in par["train_launches"].items():
            train_counts[k] = train_counts.get(k, 0) + v
    if only != set(GROUPS):
        emit({"phase": "total", "seconds": time.perf_counter() - t_start,
              "groups": sorted(only)})
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    # launches the graphs made (captured calls x replays), beside the host-counted ones
    glaunch = graph_launches(*jts)
    for counts in (eval_counts, cli_counts):
        for k, v in counts["graph_launches"].items():
            glaunch[k] = glaunch.get(k, 0) + v
    src = "uvltrack_tpu_torch/csrc"
    lb = f"B{LOCKSTEP_B}_"
    return finish(t_start, smi, torch, launches, glaunch, src, lb, worst, times, q8_worst,
                  q8_times, fused_worst, fused_times, large, train_counts, cli_counts["f32w"],
                  tp_kern)


def track_q8_and_knobs(model, cfg, model_q8, cfg_q8, frames, boxes, vocab, language,
                       per_fwd_fp, per_fwd_q8, add) -> None:
    """The Q8 track cells and the knob phases (fused_proj, fused_prefix_off,
    fused_mlp, bert_kernel), each adding its launches."""
    from uvltrack_tpu_torch.core.tokenizer import BertTokenizer

    # the first 32 frames (a re-mine at 20): the compiled phase tracks all
    # 64 with int8 weights, on both steps
    for mode in ("BBOX", "NLBBOX"):
        add(track_phase(mode, model_q8, cfg_q8, frames[:33], boxes, BertTokenizer(str(vocab)),
                        language, expect=per_fwd_q8, label="_q8"))
    fused = frames[:9]
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


def finish(t_start, smi, torch, launches, glaunch, src, lb, worst, times, q8_worst, q8_times,
           fused_worst, fused_times, large, train_counts, f32w, tp_kern) -> int:
    """The kernels line, the compositions and per-launch lines, the total,
    the nvidia-smi line and the ok line. `large`: the kernel checks and
    times at UVLTrack-L's width, which the rows of the instantiations on
    L's path carry under "C1024"; `train_counts`: the launches of the train
    group's B-TRAIN runs and of the parallel group's dp and tp legs, each
    row's "train_launches"; `f32w`: the cli group's checks and times of
    ln_qkv[fp32x-fp32w] (its row carries its C=1024 times under "C1024");
    `tp_kern`: tp_kernel_phase's checks and times, which the rows of the
    instantiations on the tp=2 step carry under "tp" (TP_SHAPES), and the
    two fc2 fp32-out rows, whose only path is that step, at B_tp2."""
    def at(table, shape, name):
        """A kernel's times at one shape, at B=1 and (under its key) at the
        lockstep batch."""
        def strip(t):
            return {k: v for k, v in t.items() if k != "library"}
        return {**strip(table[shape][name]), lb.rstrip("_"): strip(table[lb + shape][name])}

    # (name, source, TPU kernel line, launches, worst error, times at the
    # instantiation's main-path shape)
    rows = [
        ("ln_qkv", f"{src}/ln_qkv.cu", 167,
         launches.get("ln_qkv[bf16x-bf16w]", 0) + launches.get("ln_qkv[fp32x-bf16w]", 0),
         worst["ln_qkv"], at(times, "N361_fp32x_flag0", "ln_qkv")),
        ("qkv_attention", f"{src}/qkv_attention.cu", 119,
         launches.get("qkv_attention[bf16]", 0), worst["qkv_attention"],
         at(times, "N361_fp32x_flag0", "qkv_attention")),
    ]
    for name, line, shape in (("ln_qkv[bf16x-int8w]", 433, "N321_bf16x_open"),
                              ("ln_qkv[fp32x-int8w]", 433, "N361_fp32x_flag0"),
                              ("qkv_attention[fp32]", 433, "N361_fp32x_flag0"),
                              ("proj_residual[bf16x-bf16a-bf16w]", 291, "N321_bf16x_open"),
                              ("proj_residual[fp32x-bf16a-bf16w]", 291, "N361_fp32x_flag0"),
                              ("proj_residual[bf16x-bf16a-int8w]", 489, "N321_bf16x_open"),
                              ("proj_residual[fp32x-fp32a-int8w]", 489, "N361_fp32x_flag0")):
        source = f"{src}/{name.split('[')[0]}.cu"
        rows.append((name, source, line, launches.get(name, 0), q8_worst[name],
                     at(q8_times, shape, name)))
    # fp32 compute (the fp32 weights of export and parity): kernel #1's
    # prefix, #4's epilogue, #7, and the planes' split (the pre-pass of the
    # three, counted under #1, whose fp32 path needed it first)
    f32_worst, f32_times = f32w
    for f32_name, line in zip(F32W_NAMES, (167, 291, 551, 167)):
        rows.append((f32_name, f"{src}/{f32_name.split('[')[0]}.cu", line,
                     launches.get(f32_name, 0), f32_worst[f32_name],
                     at(f32_times, "N361_C768", f32_name)))
    # kernel #3 at BERT's N=40, kernel #7 at the ViT's two shapes
    for name, line, shape, err in (("attention[bf16]", 78, "N40_bert", "attention"),
                                   ("ln_mlp[bf16x-bf16w]", 551, "N321_bf16x", "ln_mlp"),
                                   ("ln_mlp[fp32x-bf16w]", 551, "N361_fp32x", "ln_mlp")):
        rows.append((name, f"{src}/{name.split('[')[0]}.cu", line, launches.get(name, 0),
                     fused_worst[err], at(fused_times, shape, name)))
    # fc2's fp32 out (a tensor-parallel rank's share of #7): the tp=2 train
    # step is its main path, so its launches are that step's
    tp_worst, tp_times = tp_kern
    for name, shape in (("ln_mlp[bf16x-bf16w-fp32o]", "N321_bf16x_open"),
                        ("ln_mlp[fp32x-bf16w-fp32o]", "N361_fp32x_flag0")):
        rows.append((name, f"{src}/ln_mlp.cu", 551, train_counts.get(name, 0),
                     tp_worst["ln_mlp_partial"],
                     {k: v for k, v in tp_times["B_tp2"][shape]["ln_mlp_partial"].items()
                      if k != "library"}))
    kernels = [{"name": name, "route": "cuda", "source": source,
                "replaces": f"{TPU_KERNEL}:{line}", "launches": n,
                "graph_launches": sum(glaunch.get(i, 0) for i in NAMED_BY_BASE.get(name, (name,))),
                "train_launches": sum(train_counts.get(i, 0)
                                      for i in NAMED_BY_BASE.get(name, (name,))),
                "max_abs_err": err, **t}
               for name, source, line, n, err, t in rows]
    # UVLTrack-L's width (C=1024, H=16): the instantiations its BBOX/NLBBOX
    # and int8 paths run, at their main-path shape, B=1 and B=8
    l_rows = {"ln_qkv": ("times", "N361_fp32x_flag0", "worst", "ln_qkv"),
              "qkv_attention": ("times", "N361_fp32x_flag0", "worst", "qkv_attention"),
              "ln_qkv[bf16x-int8w]": ("q8_times", "N321_bf16x_open", "q8_worst", None),
              "ln_qkv[fp32x-int8w]": ("q8_times", "N361_fp32x_flag0", "q8_worst", None),
              "qkv_attention[fp32]": ("q8_times", "N361_fp32x_flag0", "q8_worst", None)}
    for k in kernels:
        if k["name"] in l_rows:
            table, shape, errs, err_key = l_rows[k["name"]]
            k["C1024"] = {"shape": shape, "max_abs_err": large[errs][err_key or k["name"]],
                          **at(large[table], shape, err_key or k["name"])}
    for k in kernels:
        if k["name"] in F32W_NAMES:
            k["C1024"] = {"shape": "N361_C1024", "max_abs_err": f32_worst[k["name"]],
                          **at(f32_times, "N361_C1024", k["name"])}
        if k["name"] == F32W_NAMES[3]:
            k["note"] = ("the pre-pass of the fp32-weight mode of #1, #4 and #7 (their "
                         "weights' hi/lo planes, once per weight); no TPU kernel of its own")
    tp_rows = {"ln_qkv": ("N361_fp32x_flag0", "ln_qkv"),
               "qkv_attention": ("N361_fp32x_flag0", "qkv_attention"),
               "proj_residual[fp32x-bf16a-bf16w]": ("N361_fp32x_flag0", "proj_partial"),
               "ln_mlp[bf16x-bf16w-fp32o]": ("N321_bf16x_open", "ln_mlp_partial"),
               "ln_mlp[fp32x-bf16w-fp32o]": ("N361_fp32x_flag0", "ln_mlp_partial")}
    for k in kernels:
        if k["name"] in tp_rows:
            shape, name = tp_rows[k["name"]]
            k["tp"] = {label: {"shape": f"B{TRAIN_B}_{shape}", "C": c, "heads": h // tp,
                               "max_abs_err": tp_worst[name],
                               **{q: v for q, v in tp_times[label][shape][name].items()
                                  if q != "library"}}
                       for label, c, h, tp in TP_SHAPES}
        if k["name"].endswith("-fp32o]"):
            k["note"] = ("a tensor-parallel rank's share of #7 before the bias (fc2_bias with "
                         "an fp32 out); launches: the parallel group's tp=2 train steps, its "
                         "main path; times at B_tp2 (F=1536)")
    idle = [k["name"] for k in kernels if k["launches"] == 0]
    if idle:
        raise AssertionError(f"kernels never launched on their paths: {idle}")
    for shape in ("N361_fp32x_flag0", lb + "N361_fp32x_flag0"):
        emit({"phase": "composition", "name": "ln_qkv_attention (ln_qkv + qkv_attention)",
              "shape": shape, "replaces": f"{TPU_KERNEL}:167",
              "max_abs_err": worst["ln_qkv_attention"], **times[shape]["ln_qkv_attention"],
              "library": "F.layer_norm + F.linear + SDPA"})
    for num, line in (("#5", 433), ("#4", 291), ("#6", 489)):
        for shape, table in q8_times.items():
            for name, t in table.items():
                if name.startswith(num):
                    emit({"phase": "composition", "name": name, "shape": shape,
                          "replaces": f"{TPU_KERNEL}:{line}", "max_abs_err": q8_worst[name],
                          **t})
    # kernel #7's two launches, each alone, and kernel #3 at N=128
    for shape, name in ((f"{p}{n}", f"ln_mlp[{x}-bf16w] {launch}")
                        for p in ("", lb) for n, x in (("N321_bf16x", "bf16x"),
                                                       ("N361_fp32x", "fp32x"))
                        for launch in ("ln_fc1_gelu", "fc2_bias")):
        emit({"phase": "per_launch", "shape": shape, "name": name,
              "max_abs_err": fused_worst[name.split()[-1]], **fused_times[shape][name]})
    # the fp32 MLP's two launches, each alone
    for shape in (f"{p}N361_C{c}" for p in ("", lb) for c in (768, L_WIDTH)):
        for launch in ("ln_fc1_gelu", "fc2_bias"):
            name = f"{F32W_NAMES[2]} {launch}"
            emit({"phase": "per_launch", "shape": shape, "name": name,
                  "max_abs_err": f32_worst[f"{launch}[fp32]"], **f32_times[shape][name]})
    emit({"phase": "per_launch", "shape": "N128_bert", "name": "attention[bf16]",
          "max_abs_err": fused_worst["attention"], **fused_times["N128_bert"]["attention[bf16]"]})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
