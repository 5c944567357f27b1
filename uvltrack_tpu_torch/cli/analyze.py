"""Result analysis CLI of the port (a copy of uvltrack_tpu/cli/analyze.py;
parity: tracking/analysis_results.py). Host-only: it reads result files.

    python -m uvltrack_tpu_torch.cli.analyze --tracker_param baseline_base \\
        --dataset_name otb99 [--per_seq] [--run_ids 0,1 --merge]

Checks result-file completeness per dataset, then prints AUC / OP50 / OP75 /
Precision / Normalized Precision.
"""

from __future__ import annotations

import argparse
import glob
import os

# expected <seq>.txt counts per benchmark (tracking/analysis_results.py:21-31)
EXPECTED_COUNTS = {
    "otb99": 96,
    "tnl2k": 700,
    "lasot": 280,
    "lasotext": 150,
    "trackingnet": 511,
    "got10k_test": 180,
}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--tracker_name", default="uvltrack")
    p.add_argument("--tracker_param", default="baseline_base")
    p.add_argument("--dataset_name", default="otb99")
    p.add_argument("--mode", default=None, help="override TEST.MODE for the report dir")
    p.add_argument("--epoch", type=int, default=None)
    p.add_argument("--per_seq", action="store_true",
                   help="print the per-sequence AO table "
                        "(plot_results.py:442 print_per_sequence_results)")
    p.add_argument("--filter", default=None, metavar="MODE:THRESHOLD",
                   help="per-seq filter, e.g. ao_min:50, ao_max:30, delta_ao:10")
    p.add_argument("--got_json", nargs="*", default=None, metavar="NAME=PATH",
                   help="plot GOT-10k leaderboard json reports "
                        "(plot_results.py:381 plot_got_success)")
    p.add_argument("--plot_dir", default=None,
                   help="output dir for plots (default: the results dir)")
    p.add_argument("--save_file", default=None,
                   help="also write the report text to this file "
                        "(plot_results.py:318 print_results save_file)")
    p.add_argument("--run_ids", default=None,
                   help="comma-separated run ids: score sibling result dirs "
                        "<param>_<id:03d> as separate runs "
                        "(tracking/analysis_results.py trackerlist)")
    p.add_argument("--merge", action="store_true",
                   help="average the curves across runs of the same "
                        "name/param (plot_results.py:45 merge_multiple_runs)")
    p.add_argument("--force_evaluation", action="store_true",
                   help="ignore the precomputed eval_data.pkl cache")
    args = p.parse_args(argv)

    from ..config import load_cfg
    from ..eval.datasets import get_dataset
    from ..eval.environment import env_settings, experiment_cfg_path
    from ..eval.metrics import evaluate_results_dir

    settings = env_settings()
    cfg = load_cfg(experiment_cfg_path(settings, args.tracker_name,
                                       args.tracker_param))
    mode = args.mode or cfg.TEST.MODE
    epoch = args.epoch or cfg.TEST.EPOCH
    report = f"{args.dataset_name}_{mode}_{epoch:04d}"
    results_dir = os.path.join(settings.results_path, args.tracker_name,
                               args.tracker_param, report)

    # completeness check runs against every directory actually scored: with
    # --run_ids the results live in <param>_NNN sibling dirs, not the plain
    # <param> dir
    if args.run_ids is not None:
        check_dirs = [os.path.join(
            f"{os.path.dirname(results_dir)}_{int(r):03d}", report)
            for r in args.run_ids.split(",")]
    else:
        check_dirs = [results_dir]
    expected = EXPECTED_COUNTS.get(args.dataset_name)
    for d in check_dirs:
        n = len([f for f in glob.glob(os.path.join(d, "*.txt"))
                 if not f.endswith("_time.txt")])
        if expected is not None and n < expected:
            print(f"WARNING: incomplete results: {n}/{expected} sequences in {d}")

    if args.got_json:
        from ..eval.plots import plot_got_success

        files = dict(kv.split("=", 1) for kv in args.got_json)
        out = plot_got_success(files, args.plot_dir or results_dir)
        print("wrote " + ", ".join(out))
        return

    dataset = get_dataset(args.dataset_name)
    if args.per_seq:
        from ..eval.metrics import per_sequence_results

        criteria = None
        if args.filter:
            mode, thr = args.filter.split(":")
            criteria = {"mode": mode, "threshold": float(thr)}
        text = per_sequence_results({f"{args.tracker_name}/{args.tracker_param}":
                                     results_dir}, dataset, criteria)
        if args.save_file:
            with open(args.save_file, "w") as f:
                f.write(text)
        return

    if args.run_ids is not None or args.merge:
        # multi-run path: eval_data cache + optional run-averaging
        from ..eval.metrics import (check_and_load_precomputed_results,
                                    eval_data_scores, generate_formatted_report,
                                    merge_multiple_runs)

        param_root = os.path.dirname(results_dir)
        if args.run_ids is not None:
            run_ids = [int(x) for x in args.run_ids.split(",")]
            trackers = [{"name": args.tracker_name, "param": args.tracker_param,
                         "run_id": r,
                         "results_dir": os.path.join(
                             f"{param_root}_{r:03d}", report)}
                        for r in run_ids]
        else:
            trackers = [{"name": args.tracker_name, "param": args.tracker_param,
                         "run_id": None, "results_dir": results_dir}]
        plot_dir = args.plot_dir or os.path.join(
            settings.results_path, "plots", args.tracker_name,
            args.tracker_param, report)
        eval_data = check_and_load_precomputed_results(
            trackers, dataset, plot_dir,
            force_evaluation=args.force_evaluation, skip_missing_seq=True)
        if args.merge:
            eval_data = merge_multiple_runs(eval_data)
        labels = []
        for t in eval_data["trackers"]:
            d = t.get("disp_name") or (
                f"{t['name']}_{t['param']}" if t.get("run_id") is None
                else f"{t['name']}_{t['param']}_{t['run_id']:03d}")
            labels.append(d)
        text = generate_formatted_report(
            labels, eval_data_scores(eval_data),
            table_name=f"{args.dataset_name}")
        print(text)
        if args.save_file:
            with open(args.save_file, "w") as f:
                f.write(text)
        return

    scores = evaluate_results_dir(results_dir, dataset)
    line = (f"{args.tracker_name}/{args.tracker_param} on {args.dataset_name}: "
            f"AUC={scores['AUC']:.2f} OP50={scores['OP50']:.2f} "
            f"OP75={scores['OP75']:.2f} P={scores['Precision']:.2f} "
            f"Pnorm={scores['NormPrec']:.2f}")
    print(line)
    if args.save_file:
        with open(args.save_file, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
