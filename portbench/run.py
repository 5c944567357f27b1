"""The benchmark of uvltrack_tpu_torch, one run of one cell:

    python3 -m portbench.run --workload B-S8-mixed --seed 7 --seconds 30 --trace 0

from the root of a checkout (BENCHMARK.json beside portbench/). It needs as
many CUDA cards as the cell asks for, builds the port's kernels into the
checkout's build/kernels/ on its first run there, and prints one JSON line
last on standard output: correct, attempted, failed, metrics (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace 1),
device, with --trace 1 a breakdown, and last `checks`, each number the
comparison with the reference read beside its limit (also the last lines of
standard error). Exit codes: 0 a result printed; 2 no card or too few; 3 a
forbidden module (JAX, jaxlib, flax, the JAX package) was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from . import cell as run_cell
    from .guard import forbidden_loaded
    from .spec import load_cell, reader

    spec = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {spec.chips} CUDA card(s), {n} found",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = run_cell.run(spec, args.seed, args.seconds, bool(args.trace), device, T_START)
    rec, tally = out["record"], out["tally"]
    metrics = {}
    for m in (spec.per_layer if args.trace else spec.end_to_end):
        value = reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {k: {"value": tally.values[k], "limit": spec.limits[k], "rows": tally.rows[k]}
              for k in tally.values}
    # a number whose limit is null is reported, not compared (PERF.md says why)
    correct = out["samples"] > 0 and all(
        tally.values[k] <= spec.limits[k] for k in tally.values if spec.limits[k] is not None)
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": spec.chips,
                   "memory_peak_bytes": out["memory_peak_bytes"],
                   "power_limit": run_cell.nvidia_smi()}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_info}
    if args.trace:
        s = rec.trace
        device_info.update(busy_s=s["busy_s"], window_s=s["window_s"])
        result["breakdown"] = {"device_ops": [[k[:160], v] for k, v in s["device_ops"]],
                               "idle_gaps": s["idle_gaps"]}
        print(run_cell.dump({"trace_events": s["events"], "skew_ns": s["skew_ns"]}),
              file=sys.stderr)
    result["checks"] = checks
    found = forbidden_loaded()
    if found:
        print(f"portbench: forbidden modules loaded in this process: {found}", file=sys.stderr)
        return 3
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r}, {v['rows']} rows)",
              file=sys.stderr)
    print(run_cell.dump(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
