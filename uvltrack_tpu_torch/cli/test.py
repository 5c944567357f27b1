"""Evaluation CLI of the port: run a tracker over a benchmark and save result
files (port of uvltrack_tpu/cli/test.py; parity with tracking/test.py).

    python -m uvltrack_tpu_torch.cli.test uvltrack baseline_base \\
        --dataset_name otb99 [--streams 8] [--device cpu]

Results land in <results>/<tracker>/<param>[_NNN]/<dataset>_<MODE>_<EPOCH>/
<seq>.txt and are scored locally unless the split is server-evaluated.

The model runs on the card unless --device cpu is given: without a card and
without that flag the run stops with an error. Weights are seeded random
(seed 0), a reference checkpoint (.pth, .pth.tar, .bin), or a trainer
checkpoint: the port's ep%04d.pt or the JAX trainer's ep%04d.msgpack
(build_tracker). The single-stream runner
steps the JitTracker's CUDA graphs (Tracker.track, or Tracker.track_many
with --chunk); --streams S runs S sequences in lockstep, one BatchTracker per
group size, all on the prototype's JitTracker, so every group shares its
graphs and their memory pool. --multichip (with --streams) shards each
group's streams over every visible card (parallel/mesh.py make_mesh; the
CPU under --device cpu): one replica a card, each with its own JitTracker
and a copy of the weights (track/batch.py BatchTracker(mesh=)).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..core.tokenizer import BertTokenizer
from ..eval.environment import env_settings, resolve_path
from ..models.convert import from_jax_variables, load_reference_state, load_torch_file
from ..models.uvltrack import build_model
from ..track.tracker import Tracker


def checkpoint_state(checkpoint: str) -> dict:
    """The reference-keyed state dict of a checkpoint file, by its suffix:
    a reference checkpoint (.pth, .pth.tar, .bin: the network under 'net'),
    the port's trainer checkpoint (ep%04d.pt: the model's state dict,
    train/checkpoint.py) or the JAX trainer's (ep%04d.msgpack: its flax
    params and batch_stats, read without the msgpack package and converted
    by from_jax_variables). Any other suffix raises."""
    if checkpoint.endswith((".pth", ".pth.tar", ".bin")):
        return load_torch_file(checkpoint)
    if checkpoint.endswith(".pt"):
        from ..train.checkpoint import CheckpointManager

        state, _, _ = CheckpointManager(os.path.dirname(checkpoint)).restore_raw(checkpoint)
        if "model" not in state:
            raise ValueError(f"{checkpoint!r}: not a trainer checkpoint of the port "
                             "(no model state)")
        return state["model"]
    if checkpoint.endswith(".msgpack"):
        from ..utils.msgpack_native import read_checkpoint

        try:
            state, _, _ = read_checkpoint(checkpoint)
            params = state["params"]
        except (KeyError, TypeError) as e:
            raise ValueError(f"{checkpoint!r}: not a trainer checkpoint of the JAX "
                             f"package (no {e} entry)") from e
        return from_jax_variables(params, state.get("batch_stats", {}))
    raise ValueError(f"{checkpoint!r}: unknown checkpoint type (reference .pth, .pth.tar, "
                     ".bin; trainer ep%04d.pt or ep%04d.msgpack)")


def build_tracker(cfg, checkpoint: str | None = None, device=None) -> Tracker:
    """A Tracker of the model `cfg` describes, on `device` ("cuda" by
    default), with random weights from seed 0 (build_model) or the weights
    of a checkpoint (checkpoint_state) through load_reference_state. The
    tokenizer's vocab is resolved against the repo and the pretrained
    directory (eval/environment.py::resolve_path); NL and NLBBOX modes warn
    when it is missing and then track with empty text, as the JAX package
    does."""
    model = build_model(cfg, device=device)
    if checkpoint:
        unused = load_reference_state(model, checkpoint_state(checkpoint))
        if unused:
            print(f"converter: {len(unused)} unused keys (e.g. {unused[:3]})")
    tok = None
    vocab = resolve_path(env_settings(), cfg.MODEL.BACKBONE.LANGUAGE.VOCAB_PATH)
    if vocab and os.path.exists(vocab):
        tok = BertTokenizer(vocab)
    elif cfg.TEST.MODE in ("NL", "NLBBOX"):
        print(f"WARNING: vocab not found at {vocab!r} — {cfg.TEST.MODE} "
              "mode will run with empty text")
    return Tracker(cfg, model, tokenizer=tok)


def main(argv=None):
    p = argparse.ArgumentParser(description="Run tracker on a benchmark dataset")
    p.add_argument("tracker_name", nargs="?", default="uvltrack")
    p.add_argument("tracker_param", nargs="?", default="baseline_base")
    p.add_argument("--dataset_name", default="otb99")
    p.add_argument("--test_checkpoint", default=None)
    p.add_argument("--runid", type=int, default=None)
    p.add_argument("--sequence", default=None, help="run a single sequence")
    p.add_argument("--rerun", action="store_true")
    p.add_argument("--multichip", action="store_true",
                   help="shard the lockstep streams (--streams) over all local cards")
    p.add_argument("--streams", type=int, default=0,
                   help="batched evaluation with N lockstep streams on the card "
                        "(replaces the reference's GPU process pool)")
    p.add_argument("--chunk", type=int, default=0,
                   help="chunked single-stream tracking (Tracker.track_many: the "
                        "boxes read back once per chunk)")
    p.add_argument("--save_vis", default=None, metavar="DIR",
                   help="debug: save pred(green)/gt(red) overlay frames per "
                        "sequence under DIR (single-stream runner only)")
    p.add_argument("--vis_stride", type=int, default=1,
                   help="save every Nth overlay frame with --save_vis")
    p.add_argument("--vis_response", action="store_true",
                   help="with --save_vis: also dump cls/merged response-map "
                        "heatmaps per frame (the eager debug step; debug-grade "
                        "per-frame times)")
    p.add_argument("--quant", default=None, choices=("int8",),
                   help="weight-only quantization of the ViT matmul kernels "
                        "at tracker build (cfg.TPU.WEIGHT_QUANT; ops/quant.py)")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="config override (repeatable), e.g. --set TEST.MODE=NL "
                        "(strict keys, typed against the default leaf)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model (cpu runs the eager step)")
    args = p.parse_args(argv)

    from ..config import load_cfg
    from ..eval.datasets import get_dataset
    from ..eval.environment import experiment_cfg_path
    from ..eval.metrics import evaluate_results_dir
    from ..eval.running import run_dataset

    settings = env_settings()
    cfg = load_cfg(experiment_cfg_path(settings, args.tracker_name,
                                       args.tracker_param))
    cfg.merge_from_list(args.overrides)
    if args.quant:
        cfg.TPU.WEIGHT_QUANT = args.quant

    if args.test_checkpoint is None:
        # default checkpoint discovery (parity: lib/test/parameter/uvltrack.py's
        # checkpoints/train/uvltrack/<cfg>/UVLTrack_ep%04d.pth.tar pattern)
        ckpt_dir = os.path.join(settings.repo_dir, "checkpoints", "train",
                                args.tracker_name, args.tracker_param)
        for cand in (
            os.path.join(ckpt_dir, f"ep{cfg.TEST.EPOCH:04d}.msgpack"),
            os.path.join(ckpt_dir, f"UVLTrack_ep{cfg.TEST.EPOCH:04d}.pth.tar"),
        ):
            if os.path.exists(cand):
                args.test_checkpoint = cand
                print(f"using checkpoint {cand}")
                break
        else:
            print("no checkpoint found; running with random weights")

    dataset = get_dataset(args.dataset_name)
    if args.sequence:
        dataset = type(dataset)([s for s in dataset if s.name == args.sequence])

    report = f"{args.dataset_name}_{cfg.TEST.MODE}_{cfg.TEST.EPOCH:04d}"
    # --runid N writes under <param>_NNN (reference run_id convention,
    # lib/test/evaluation/tracker.py results_dir) — analyze --run_ids
    # reads these sibling dirs back for multi-run merging
    param_dir = (args.tracker_param if args.runid is None
                 else f"{args.tracker_param}_{args.runid:03d}")
    results_dir = os.path.join(settings.results_path, args.tracker_name,
                               param_dir, report)
    # built before any sequence runs, so a missing card stops the run here
    proto = build_tracker(cfg, args.test_checkpoint, device=args.device)
    if args.streams > 1:
        from ..eval.running_batched import run_dataset_batched
        from ..track.batch import BatchTracker

        mesh = None
        if args.multichip:
            from ..parallel.mesh import local_devices, make_mesh

            mesh = make_mesh(data=-1, model=1, devices=local_devices(proto.device))
        trackers_by_s = {}

        def factory(S):
            # cached by stream count: initialize() resets all per-group
            # state, and every BatchTracker steps the prototype's
            # JitTracker, so groups of one size share their graphs
            if S not in trackers_by_s:
                trackers_by_s[S] = BatchTracker(cfg, None, S, tokenizer=proto.tokenizer,
                                                jit_tracker=proto.jt, mesh=mesh)
            return trackers_by_s[S]

        if args.save_vis:
            print("--save_vis applies to the single-stream runner only; "
                  "ignoring it with --streams")
        run_dataset_batched(factory, dataset, results_dir,
                            num_streams=args.streams, rerun=args.rerun)
    else:
        run_dataset(lambda: proto, dataset, results_dir, rerun=args.rerun,
                    chunk=args.chunk, save_vis=args.save_vis,
                    vis_stride=args.vis_stride, vis_response=args.vis_response)
    # server-evaluated splits (GOT-10k test, TrackingNet test) ship a
    # 1-row groundtruth.txt: scoring them locally forces pred[0]=anno[0]
    # and prints a bogus perfect 100 — point at the packagers instead
    if all(np.asarray(s.ground_truth_rect).shape[0] <= 1 for s in dataset):
        print(f"{args.dataset_name}: ground truth holds only the first "
              "frame (server-evaluated split) — cannot score locally; "
              "package with `python -m uvltrack_tpu_torch.cli.pack` and submit "
              "to the evaluation server")
        return
    try:
        evaluate_results_dir(results_dir, dataset)
    except FileNotFoundError:
        pass


if __name__ == "__main__":
    main()
