"""Export the per-frame inference program as a serialized torch.export
artifact (port of uvltrack_tpu/cli/export.py, which writes StableHLO).

`torch.export.export` captures models/uvltrack.py::forward_test_fn (the
program cli/profile.py times) at TPU.COMPUTE_DTYPE=float32 as an
ExportedProgram: an ATen graph with the weights lifted as its inputs, saved
with `torch.export.save` (a zip) and loaded back with `torch.export.load`
by any Python process with torch and this package (the kernels are custom
ops, `uvltrack::*`, ops/library.py, registered by importing it). On the card
the graph holds the kernels as those ops, where the kernels run; on the CPU,
the plain versions' ATen ops.

    python -m uvltrack_tpu_torch.cli.export --config baseline_base \\
        [--checkpoint UVLTrack_ep0300.pth.tar] --out uvltrack_b.pt2 \\
        [--platforms cuda] [--batch 1] [--check] [--device cpu]

Writes `<out>` and `<out>.json`, a manifest with the JAX manifest's keys
where they have a meaning in torch: config, checkpoint, batch, platforms
(the one device the program was traced on), n_args_flat (the program's
inputs: lifted parameters and buffers, then the six example arguments),
example_arg_shapes, outputs, bytes; calling_convention_version (StableHLO's)
has none and is left out, and kernel_ops (the uvltrack ops in the graph by
name) is added. --platforms takes one device ("cuda" or "cpu", the JAX
names "gpu" and "tpu" as "cuda"); more than one is refused: an
ExportedProgram is traced on one device. --check loads the file back, runs
it on the example inputs and asserts it reproduces the direct call to 1e-5
rtol/atol (same device; not asserted bit-identical).

The model runs on the card unless --device cpu is given: without a card and
without that flag the CLI stops with an error before building anything.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

PLATFORM_NAMES = {"cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}


def export_forward(cfg, model, batch: int = 1):
    """(exported, args): the torch.export'd forward_test_fn program on
    `batch`-sized example inputs (models/uvltrack.py::example_test_inputs)
    and those inputs. The parameters are set to need no gradient first: the
    program is inference."""
    import torch

    from ..models.uvltrack import example_test_inputs, forward_test_fn

    for prm in model.parameters():
        prm.requires_grad_(False)
    fn = forward_test_fn(model).eval()
    args = example_test_inputs(cfg, model, batch=batch)
    return torch.export.export(fn, args, strict=False), args


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="baseline_base")
    p.add_argument("--checkpoint", default=None,
                   help="optional .pth.tar / ep%%04d.pt / ep%%04d.msgpack checkpoint; "
                        "random init when omitted (artifact-shape testing)")
    p.add_argument("--out", default="uvltrack.pt2")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--platforms", default=None,
                   help="the one device to trace on (cuda or cpu); default: --device. "
                        "An exported program holds one device: a list is refused")
    p.add_argument("--check", action="store_true",
                   help="load the written file and assert it reproduces the direct "
                        "call on the example inputs")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions)")
    args = p.parse_args(argv)
    device = args.device
    if args.platforms:
        names = [s.strip() for s in args.platforms.split(",") if s.strip()]
        if len(names) != 1 or names[0] not in PLATFORM_NAMES:
            p.error(f"--platforms {args.platforms!r}: one device, cuda or cpu (an exported "
                    "program is traced on one device)")
        device = PLATFORM_NAMES[names[0]]

    import torch

    from ..config import load_cfg
    from ..eval.environment import env_settings, experiment_cfg_path
    from ..models.uvltrack import resolve_device
    from ..ops import library
    from .test import build_tracker

    device = resolve_device(device)  # no card, no --device cpu: stop here
    cfg = load_cfg(experiment_cfg_path(env_settings(), "uvltrack", args.config))
    cfg.TPU.COMPUTE_DTYPE = "float32"  # the artifact is precision-explicit
    model = build_tracker(cfg, args.checkpoint, device=device).model

    exported, ex_args = export_forward(cfg, model, batch=args.batch)
    torch.export.save(exported, args.out)
    size = os.path.getsize(args.out)
    manifest = {
        "config": args.config,
        "checkpoint": args.checkpoint,
        "batch": args.batch,
        "platforms": [device.type],
        "n_args_flat": len(exported.graph_signature.input_specs),
        "example_arg_shapes": [list(a.shape) for a in ex_args],
        "outputs": ["bbox_map", "cls_score_test", "cont_score"],
        "kernel_ops": library.op_counts(exported),
        "bytes": size,
    }
    with open(args.out + ".json", "w") as f:
        json.dump(manifest, f, indent=1)
    print(f"wrote {args.out} ({size / 1e6:.1f} MB, platforms={manifest['platforms']}, "
          f"kernel ops {manifest['kernel_ops']}) + manifest")

    if args.check:
        restored = torch.export.load(args.out).module()
        with torch.no_grad():
            got = restored(*ex_args)
            ref = model.forward_test(*ex_args)
        ref = (ref["bbox_map"], ref["cls_score_test"], ref["cont_score"])
        for g, w, name in zip(got, ref, manifest["outputs"]):
            np.testing.assert_allclose(g.float().cpu().numpy(), w.float().cpu().numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
        print("check: loaded program matches the direct call")


if __name__ == "__main__":
    main()
