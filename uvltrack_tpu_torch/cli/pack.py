"""Submission packaging CLI of the port (a copy of uvltrack_tpu/cli/pack.py;
parity: lib/test/utils/transform_got10k.py and transform_trackingnet.py
invocations): python -m uvltrack_tpu_torch.cli.pack got10k|trackingnet."""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("benchmark", choices=["got10k", "trackingnet"])
    p.add_argument("--tracker_name", default="uvltrack")
    p.add_argument("--tracker_param", default="baseline_base")
    p.add_argument("--dataset_name", default=None)
    p.add_argument("--mode", default=None)
    p.add_argument("--epoch", type=int, default=None)
    p.add_argument("--out_dir", default=None)
    args = p.parse_args(argv)

    from ..config import load_cfg
    from ..eval.environment import env_settings, experiment_cfg_path
    from ..eval.packagers import transform_got10k, transform_trackingnet

    settings = env_settings()
    cfg = load_cfg(experiment_cfg_path(settings, args.tracker_name,
                                       args.tracker_param))
    dataset = args.dataset_name or ("got10k_test" if args.benchmark == "got10k"
                                    else "trackingnet")
    mode = args.mode or cfg.TEST.MODE
    epoch = args.epoch or cfg.TEST.EPOCH
    results_dir = os.path.join(settings.results_path, args.tracker_name,
                               args.tracker_param,
                               f"{dataset}_{mode}_{epoch:04d}")
    out_dir = args.out_dir or os.path.join(settings.results_path, "submissions")
    os.makedirs(out_dir, exist_ok=True)
    fn = transform_got10k if args.benchmark == "got10k" else transform_trackingnet
    zip_path = fn(results_dir, out_dir,
                  zip_name=f"{args.tracker_name}_{args.tracker_param}_{dataset}")
    print(f"submission written: {zip_path}")


if __name__ == "__main__":
    main()
