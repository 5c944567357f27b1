"""Training CLI of the port (port of uvltrack_tpu/cli/train.py; parity with
tracking/train.py + lib/train/run_training.py), on one device.

    python -m uvltrack_tpu_torch.cli.train --script uvltrack \\
        --config baseline_base --synthetic N [--device cpu]

--synthetic N trains on N synthetic batches an epoch (data/synthetic.py),
drawn from numpy.random.default_rng(--seed); the real-data pipeline is not
ported yet, and a run without --synthetic stops with an error that says so.
The model runs on the card unless --device cpu is given: without a card and
without that flag the run stops with an error. --multihost is parsed and
refused: the port trains on one device. Logs go to <save_dir or output>/
logs/<script>-<config>.log(.jsonl); checkpoints (ep%04d.pt, one an epoch)
to <save_dir>/checkpoints/train/<script>/<config>, or the repo's
checkpoints/ tree without --save_dir, and a rerun resumes from the latest.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--script", default="uvltrack")
    p.add_argument("--config", default="baseline_base")
    p.add_argument("--save_dir", default=None,
                   help="workspace root for logs AND checkpoints/train/<script>/<config>; "
                        "when omitted, logs go under ./output and checkpoints under "
                        "<repo>/checkpoints, where cli/test resolves them")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic batches/epoch instead of real data")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--multihost", action="store_true",
                   help="multi-process training (not in the port yet: refused)")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="config override, e.g. --set TPU.GRAD_ACCUM=2 (repeatable; "
                        "applied after the experiment YAML)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions)")
    args = p.parse_args(argv)
    if args.multihost:
        raise SystemExit("--multihost: the port trains on one device; DDP, ZeRO-1 and "
                         "multihost are ROADMAP.md queue 1 item 4 (parallel)")
    if not args.synthetic:
        raise SystemExit("the port's real-data pipeline (data/: datasets, sampler, "
                         "processing, loader) is not ported yet (ROADMAP.md queue 1 item "
                         "3, the data slice); train on synthetic batches with --synthetic N")

    from ..config import load_cfg
    from ..data.synthetic import synthetic_batch_from_cfg
    from ..eval.environment import env_settings, experiment_cfg_path, train_checkpoint_dir
    from ..models.convert import load_pretrained
    from ..models.uvltrack import resolve_device
    from ..train.step import make_eval_step, setup_training
    from ..train.trainer import Trainer

    device = resolve_device(args.device)
    settings = env_settings()
    cfg = load_cfg(experiment_cfg_path(settings, args.script, args.config))
    if args.overrides:
        cfg.merge_from_list(args.overrides)
    if args.epochs:
        cfg.TRAIN.EPOCH = args.epochs
    if args.batch_size:
        cfg.TRAIN.BATCH_SIZE = args.batch_size
    batch_size = int(cfg.TRAIN.BATCH_SIZE)
    steps_per_epoch = args.synthetic

    def loader():
        rng = np.random.default_rng(args.seed)
        for _ in range(steps_per_epoch):
            yield synthetic_batch_from_cfg(rng, cfg, batch_size)

    def to_device(batch):
        return {k: torch.from_numpy(v).to(device, non_blocking=True) for k, v in batch.items()}

    model, state, train_step = setup_training(
        cfg, steps_per_epoch, device=device, seed=args.seed,
        prepare_model=lambda m: load_pretrained(cfg, m, settings))
    if args.save_dir is not None:
        ckpt_dir = os.path.join(args.save_dir, "checkpoints", "train", args.script, args.config)
    else:
        ckpt_dir = train_checkpoint_dir(settings, args.script, args.config)
    log_root = args.save_dir if args.save_dir is not None else "output"
    trainer = Trainer(cfg, train_step, state, _Reiterable(loader), {},
                      eval_step=make_eval_step(model, cfg), checkpoint_dir=ckpt_dir,
                      log_path=os.path.join(log_root, "logs", f"{args.script}-{args.config}.log"),
                      to_device=to_device)
    trainer.train(int(cfg.TRAIN.EPOCH), load_latest=True, fail_safe=True)
    return trainer


class _Reiterable:
    def __init__(self, gen_fn):
        self.gen_fn = gen_fn

    def __iter__(self):
        return self.gen_fn()


if __name__ == "__main__":
    main()
