"""Latency/FPS profiler CLI of the port (port of uvltrack_tpu/cli/profile.py;
parity: tracking/profile_model.py:30-47).

    python -m uvltrack_tpu_torch.cli.profile --config baseline_base \\
        [--what forward|step] [--batch B] [--quant int8] [--pallas | --xla] \\
        [--trace_dir DIR] [--device cpu]

Two measurements:
  --what forward : the model's forward_test only (models/uvltrack.py::
                   forward_test_fn, eager, on the inference weights) at
                   --batch, comparable to the reference's 500-warmup /
                   1000-iter profile that produced the 60/34 FPS README numbers
  --what step    : the full tracking step of a Tracker (crop, forward, decode;
                   on the card the replay of its CUDA graphs, which the JAX
                   Tracker's jitted step corresponds to) on a 720p frame

Every latency is read after the card has finished (torch.cuda.synchronize;
the step reads its box back). --what forward also prints the work of one
call, counted as it runs (utils/costs.py: FLOPs of the products, bytes of
each op's inputs and outputs; a kernel counts as its plain version).
--trace_dir writes a torch.profiler Chrome trace of the timed iterations
(trace.json) in place of the JAX CLI's XLA trace.

The model runs on the card unless --device cpu is given: without a card and
without that flag the CLI stops with an error before building anything.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--script", default="uvltrack")
    p.add_argument("--config", default="baseline_base")
    p.add_argument("--what", choices=["forward", "step"], default="forward")
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--iters", type=int, default=1000)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--trace_dir", default=None,
                   help="write a torch.profiler Chrome trace of the timed iterations "
                        "(DIR/trace.json)")
    p.add_argument("--pallas", action="store_true",
                   help="force the hand-written CUDA kernels (the \"cuda\" attention "
                        "backend: the cfg default)")
    p.add_argument("--quant", default=None, choices=("int8",),
                   help="weight-only int8 on the ViT matmul kernels "
                        "(cfg.TPU.WEIGHT_QUANT): the cost line then counts the "
                        "int8 weights; on every backend and weight type the "
                        "projection, fc1 and fc2 count as their operands read "
                        "once and their fp32 results written once "
                        "(ops/attention.py::weight_dot_work), no upcast copies")
    p.add_argument("--xla", action="store_true",
                   help="force the plain PyTorch backend (the JAX package's XLA "
                        "backend's counterpart: no kernel launches)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions)")
    args = p.parse_args(argv)

    import torch

    from ..config import load_cfg
    from ..eval.environment import env_settings, experiment_cfg_path
    from ..models.uvltrack import (build_model, example_test_inputs, forward_test_fn,
                                   prepare_inference_model, resolve_device)
    from ..utils.costs import program_cost

    device = resolve_device(args.device)  # no card, no --device cpu: stop here
    cfg = load_cfg(experiment_cfg_path(env_settings(), args.script, args.config))
    # the kernels are the cfg default; --xla forces the plain backend
    if args.pallas:
        cfg.TPU.USE_PALLAS_ATTENTION = True
    if args.xla:
        cfg.TPU.USE_PALLAS_ATTENTION = False
    if args.quant:
        cfg.TPU.WEIGHT_QUANT = args.quant
    model = build_model(cfg, device=device)
    cuda = device.type == "cuda"
    if cuda:
        print(f"device: {torch.cuda.get_device_name(device)}")

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    if args.what == "forward":
        # the inference weights (bf16 cast, int8 with --quant), as a Tracker
        # prepares them, so the cost line sees the bytes the card reads
        model = prepare_inference_model(cfg, model)
        fn = forward_test_fn(model)
        inputs = example_test_inputs(cfg, model, batch=args.batch)
        cost = program_cost(fn, *inputs)
        print(f"counted cost: {cost['flops'] / 1e9:.2f} GFLOPs, "
              f"{cost['bytes'] / 1e6:.0f} MB accessed")

        @torch.no_grad()
        def once():
            out = fn(*inputs)
            sync()
            return out
    else:
        from ..track.tracker import Tracker

        cfg.TEST.MODE = "BBOX"
        tracker = Tracker(cfg, model, tokenizer=None)
        rng = np.random.default_rng(0)
        frame = rng.integers(0, 255, size=(720, 1280, 3)).astype(np.uint8)
        tracker.initialize(frame, {"init_bbox": [600.0, 300.0, 120.0, 160.0]})

        def once():
            return tracker.track(frame)  # reads the box back: synchronized

    for _ in range(args.warmup):
        once()

    tracing = contextlib.nullcontext()
    if args.trace_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        tracing = profile(activities=acts)
    lat = []
    with tracing as prof:
        for _ in range(args.iters):
            t0 = time.perf_counter()
            once()
            lat.append(time.perf_counter() - t0)
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        path = os.path.join(args.trace_dir, "trace.json")
        prof.export_chrome_trace(path)
        print(f"trace written to {path}")

    lat = np.asarray(lat)
    print(f"{args.what} (batch={args.batch}): mean={lat.mean()*1e3:.2f}ms "
          f"p50={np.percentile(lat,50)*1e3:.2f}ms p90={np.percentile(lat,90)*1e3:.2f}ms "
          f"fps={args.batch/lat.mean():.1f}")


if __name__ == "__main__":
    main()
