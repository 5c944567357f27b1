"""The readings the comparison's limits are set from: sound runs of the
port on many seeds, the port's int8 weight path (TPU.WEIGHT_QUANT=int8),
the reference in float8 put in the program's place (over the same sampled
states as each sound run), and runs with a fault of faults.py planted, at
the cell's own size and load, in one process:

    python3 -m portbench.readings --workload B-S8-mixed --seeds 1,2,3 \\
        --seconds 4 --out readings_B-S8-mixed.json

Each run's numbers (and every row's reading) go to --out as JSON; a line a
run goes to standard output. The benchmark's own runs never run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--int8-seeds", default="", help="seeds of the int8 weight path's runs")
    p.add_argument("--fault", action="append", default=[],
                   help="NAME:SEED,SEED: runs with a fault of faults.py planted")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    import torch

    from . import cell as run_cell
    from .faults import FAULTS
    from .spec import load_cell

    spec = load_cell(args.workload)
    device = torch.device("cuda", 0)
    runs = []
    plan = [("sound", int(s)) for s in args.seeds.split(",") if s]
    plan += [("int8", int(s)) for s in args.int8_seeds.split(",") if s]
    for f in args.fault:
        name, _, seeds = f.partition(":")
        plan += [(name, int(s)) for s in seeds.split(",") if s]
    for variant, seed in plan:
        t0 = time.perf_counter()
        out = run_cell.run(spec, seed, args.seconds, False, device, t0,
                           variant="control" if variant == "int8" else "sound",
                           fp8_control=variant == "sound", fault=FAULTS.get(variant))
        tallies = {variant: out["tally"]}
        if out["fp8_tally"] is not None:
            tallies["fp8"] = out["fp8_tally"]
        for name, t in tallies.items():
            rec = {"variant": name, "seed": seed, "values": t.values, "rows": t.rows,
                   "per_row": t.per_row, "samples": out["samples"]}
            runs.append(rec)
            print(json.dumps({k: rec[k] for k in ("variant", "seed", "values")}), flush=True)
        torch.cuda.empty_cache()
    with open(args.out, "w") as f:
        json.dump({"workload": args.workload, "seconds": args.seconds, "runs": runs}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
