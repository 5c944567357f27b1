"""Training CLI of the port (port of uvltrack_tpu/cli/train.py; parity with
tracking/train.py + lib/train/run_training.py), on one device.

    python -m uvltrack_tpu_torch.cli.train --script uvltrack \\
        --config baseline_base [--synthetic N] [--device cpu] [--set KEY=VALUE ...]

Without --synthetic it trains on the datasets that DATA.TRAIN names
(data/builders.py reads their roots from local_paths.yaml or
UVLTRACK_<NAME>_PATH), through data/loader.py's build_train_loader, and
validates every TRAIN.VAL_EPOCH_INTERVAL epochs on the three families of
build_val_loaders (VALTRACK, VAL's grounding, VALVL) whose datasets
resolve. The loader's workers are TRAIN.NUM_WORKER threads or processes
(TPU.LOADER_WORKER_MODE); the data draws come from numpy SeedSequences of
--seed (validation from --seed + 1000003), the model's from a
torch.Generator of --seed. Each batch reaches the device through pinned
host buffers and non-blocking copies. A loader worker's exception reaches
the training loop (Trainer's fail-safe restarts the epoch from the last
checkpoint, then gives up and raises).

--synthetic N trains on N synthetic batches an epoch (data/synthetic.py),
drawn from numpy.random.default_rng(--seed), and validates on none.
The model runs on the card unless --device cpu is given: without a card and
without that flag the run stops with an error before any loader starts.
--multihost is parsed and refused: the port trains on one device. Logs go
to <save_dir or output>/logs/<script>-<config>.log(.jsonl); checkpoints
(ep%04d.pt, one an epoch) to <save_dir>/checkpoints/train/<script>/<config>,
or the repo's checkpoints/ tree without --save_dir, and a rerun resumes
from the latest.
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

    from ..config import load_cfg
    from ..data.synthetic import synthetic_batch_from_cfg
    from ..eval.environment import env_settings, experiment_cfg_path, train_checkpoint_dir
    from ..models.convert import load_pretrained
    from ..models.uvltrack import resolve_device
    from ..utils.pinned import PinnedStage
    from ..train.step import make_eval_step, setup_training
    from ..train.trainer import Trainer

    device = resolve_device(args.device)  # before any loader starts
    settings = env_settings()
    cfg = load_cfg(experiment_cfg_path(settings, args.script, args.config))
    if args.overrides:
        cfg.merge_from_list(args.overrides)
    if args.epochs:
        cfg.TRAIN.EPOCH = args.epochs
    if args.batch_size:
        cfg.TRAIN.BATCH_SIZE = args.batch_size
    batch_size = int(cfg.TRAIN.BATCH_SIZE)
    if args.synthetic:
        steps_per_epoch = args.synthetic

        def loader():
            rng = np.random.default_rng(args.seed)
            for _ in range(steps_per_epoch):
                yield synthetic_batch_from_cfg(rng, cfg, batch_size)

        train_loader, val_loaders = _Reiterable(loader), {}
    else:
        from ..data.loader import build_train_loader, build_val_loaders

        # validation draws from a fixed offset of the seed, so its batches
        # stay comparable from epoch to epoch
        train_loader = build_train_loader(cfg, batch_size, seed=args.seed)
        val_loaders = build_val_loaders(cfg, batch_size, seed=args.seed + 1_000_003)
        steps_per_epoch = len(train_loader)

    stage = PinnedStage()

    def to_device(batch):
        out = {}
        for k, v in batch.items():
            out[k] = torch.empty(v.shape, dtype=torch.from_numpy(v[:0]).dtype, device=device)
            stage.upload(v, out[k])
        return out

    model, state, train_step = setup_training(
        cfg, steps_per_epoch, device=device, seed=args.seed,
        prepare_model=lambda m: load_pretrained(cfg, m, settings))
    if args.save_dir is not None:
        ckpt_dir = os.path.join(args.save_dir, "checkpoints", "train", args.script, args.config)
    else:
        ckpt_dir = train_checkpoint_dir(settings, args.script, args.config)
    log_root = args.save_dir if args.save_dir is not None else "output"
    trainer = Trainer(cfg, train_step, state, train_loader, val_loaders,
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
