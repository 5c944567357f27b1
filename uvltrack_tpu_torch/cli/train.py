"""Training CLI of the port (port of uvltrack_tpu/cli/train.py; parity with
tracking/train.py + lib/train/run_training.py).

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
--multihost trains data parallel, one process a card, launched by torchrun
(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK; parallel/mesh.py
init_distributed): NCCL on cuda:LOCAL_RANK, gloo under --device cpu. The
mesh is TPU.MESH_DATA x TPU.MESH_MODEL over the processes (MESH_MODEL > 1
replicates the parameters and gives the ranks of one data index the same
rows), the global batch is TRAIN.BATCH_SIZE x the data shards, every rank
draws it from --seed and keeps its rows (parallel/mesh.shard_batch), and
TPU.ZERO1 shards the Adam moments when there is more than one data shard.
Only process 0 logs and writes checkpoints. Without --multihost the run is
one process on one device. Logs go
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
                   help="data-parallel training, one process a card, launched by torchrun "
                        "(its MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK)")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="config override, e.g. --set TPU.GRAD_ACCUM=2 (repeatable; "
                        "applied after the experiment YAML)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions)")
    args = p.parse_args(argv)

    from ..models.uvltrack import resolve_device

    device = resolve_device(args.device)  # before any loader starts
    if not args.multihost:
        return _train(args, device, multihost=False)
    import torch.distributed as dist

    from ..parallel.mesh import init_distributed

    device = init_distributed(device)
    try:
        return _train(args, device, multihost=True)
    finally:
        dist.destroy_process_group()


def _train(args, device, multihost: bool):
    """The run, in one process or as one rank of the process group."""
    from ..config import load_cfg
    from ..data.synthetic import synthetic_batch_from_cfg
    from ..eval.environment import env_settings, experiment_cfg_path, train_checkpoint_dir
    from ..models.convert import load_pretrained
    from ..parallel.dp import DataParallel
    from ..parallel.mesh import make_mesh, shard_batch
    from ..utils.pinned import PinnedStage
    from ..train.step import make_eval_step, setup_sharded_training
    from ..train.trainer import Trainer

    settings = env_settings()
    cfg = load_cfg(experiment_cfg_path(settings, args.script, args.config))
    if args.overrides:
        cfg.merge_from_list(args.overrides)
    if args.epochs:
        cfg.TRAIN.EPOCH = args.epochs
    if args.batch_size:
        cfg.TRAIN.BATCH_SIZE = args.batch_size
    mesh = None
    if multihost:
        mesh = make_mesh(data=int(cfg.TPU.MESH_DATA), model=int(cfg.TPU.MESH_MODEL),
                         devices=[device])
    elif int(cfg.TPU.MESH_DATA) > 1 or int(cfg.TPU.MESH_MODEL) > 1:
        raise SystemExit(f"TPU.MESH_DATA={cfg.TPU.MESH_DATA}, TPU.MESH_MODEL="
                         f"{cfg.TPU.MESH_MODEL}: a mesh of processes needs --multihost "
                         "under torchrun (one process a card)")
    n_data = mesh.data if mesh is not None else 1
    accum = int(cfg.TPU.GRAD_ACCUM or 1)
    batch_size = int(cfg.TRAIN.BATCH_SIZE) * n_data  # the global batch
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
        if mesh is not None:  # this data index's rows, cut on the host
            batch = shard_batch(mesh, batch, accum)
        out = {}
        for k, v in batch.items():
            out[k] = torch.empty(v.shape, dtype=torch.from_numpy(v[:0]).dtype, device=device)
            stage.upload(v, out[k])
        return out

    model, state, train_step = setup_sharded_training(
        cfg, mesh, steps_per_epoch, device=device, seed=args.seed,
        prepare_model=lambda m: load_pretrained(cfg, m, settings),
        zero1=bool(cfg.TPU.ZERO1) and n_data > 1)
    if args.save_dir is not None:
        ckpt_dir = os.path.join(args.save_dir, "checkpoints", "train", args.script, args.config)
    else:
        ckpt_dir = train_checkpoint_dir(settings, args.script, args.config)
    log_root = args.save_dir if args.save_dir is not None else "output"
    trainer = Trainer(cfg, train_step, state, train_loader, val_loaders,
                      eval_step=make_eval_step(model, cfg,
                                               DataParallel.of(mesh) if mesh else None),
                      checkpoint_dir=ckpt_dir,
                      log_path=os.path.join(log_root, "logs", f"{args.script}-{args.config}.log"),
                      to_device=to_device, mesh=mesh)
    trainer.train(int(cfg.TRAIN.EPOCH), load_latest=True, fail_safe=True)
    return trainer


class _Reiterable:
    def __init__(self, gen_fn):
        self.gen_fn = gen_fn

    def __iter__(self):
        return self.gen_fn()


if __name__ == "__main__":
    main()
