"""The port's own trace on a cell's runs, read with the harness as it is:

    python3 -m portbench.traced --workload B-S8-mixed --seeds 101 102 103 --seconds 20
    python3 -m portbench.traced --workload B-S8-mixed --seeds 101 102 103 --seconds 20 --oncost

from the root of a checkout with a CUDA card. Each run is cell.run with the
port's tracer (uvltrack_tpu_torch/utils/tracing.py) started before the port
is built. `attached()` adds what the tracer's readers need and cell.run does
not yet give them (PERF.md §7): the untraced window's bounds on
time.time_ns(), taken where the run draws its reservoir (just before the
window) and where the profile starts (just after it); and the profile's
summary given `idle_in_program_s`, the device's idle time by innermost
program span (program.idle_by_span). The record then carries
`program = program.export(tracing, window_ns)`.

Without --oncost each seed is one `--trace 1` run, printed as one JSON line:
every metric of portbench/metrics/ that reads a number, `correct`,
`spans_ms` (host ms a window step by span name, trace.read among them),
`idle_ms` (device idle ms a profiled step by innermost program span),
`ratios` (the relations between the host spans, the regions and the
profile that PERF.md §6 states), the tracer's `dropped`, and the card.
With --oncost each seed runs cell.run twice with trace=False, the tracer
off and on, in turns (off first on even seeds' places), a line each; a last
line gives the median stream_fps both ways and its change. Runs after the
first in a process do not count the imports or the CUDA context in
setup_s.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402


@contextlib.contextmanager
def attached(tracing):
    """While inside: cell.run's window bounds stamped into the yielded dict
    ("w0", and "w1" where a profile follows), and profile.summarize's
    summary given `idle_in_program_s` from the tracer's spans."""
    from . import profile, program
    from .traffic import generator

    bounds = {}
    reservoir, summarize = generator.reservoir, profile.summarize

    def at_window(*args, **kwargs):
        bounds["w0"] = time.time_ns()
        return reservoir(*args, **kwargs)

    def with_program(events, window_ns, spans, top=10):
        bounds["w1"] = window_ns[0]
        out = summarize(events, window_ns, spans, top)
        out["idle_in_program_s"] = program.idle_by_span(events, window_ns,
                                                        tracing.export()["spans"])
        return out

    generator.reservoir, profile.summarize = at_window, with_program
    try:
        yield bounds
    finally:
        generator.reservoir, profile.summarize = reservoir, summarize


def traced_run(spec, seed: int, seconds: float, trace: bool, device, t_start: float,
               tracer: bool = True, **kwargs) -> dict:
    """cell.run, with the tracer on from before the port is built (tracer
    False: off, as the benchmark runs); its record carries `program`."""
    from uvltrack_tpu_torch.utils import tracing

    from . import cell, program

    if not tracer:
        return cell.run(spec, seed, seconds, trace, device, t_start, **kwargs)
    tracing.start()
    try:
        with attached(tracing) as bounds:
            out = cell.run(spec, seed, seconds, trace, device, t_start, **kwargs)
        out["record"].program = program.export(
            tracing, (bounds["w0"], bounds.get("w1", time.time_ns())))
    finally:
        tracing.stop()
    return out


def ratios(rec) -> dict:
    """PERF.md §6's relations: (stage + replay) / step, step / enqueue,
    the regions (a re-mine at its share of the window's steps) over
    step.device_ms, and device.idle_stage_ms over the idle time a profiled
    step."""
    from . import program
    from .spec import reader

    m = {n: reader(n)(rec) for n in ("host.step_ms", "host.stage_ms", "host.replay_ms",
                                     "host.enqueue_ms", "model.crop_ms", "model.backbone_ms",
                                     "model.head_ms", "remine.device_ms", "step.device_ms",
                                     "device.idle_stage_ms")}
    out = {}
    if None not in (m["host.step_ms"], m["host.stage_ms"], m["host.replay_ms"]):
        out["stage_replay_over_step"] = (m["host.stage_ms"] + m["host.replay_ms"]) / m["host.step_ms"]
        out["step_over_enqueue"] = m["host.step_ms"] / m["host.enqueue_ms"]
    regions = (m["model.crop_ms"], m["model.backbone_ms"], m["model.head_ms"])
    if None not in regions and m["step.device_ms"]:
        steps = program.window_steps(rec.program)
        ids = {s[program.ID] for s in steps}
        remines = sum(1 for r in rec.program["regions"]
                      if r[program.KIND] == "remine" and r[3] in ids)
        per_step = (m["remine.device_ms"] or 0.0) * remines / len(steps)
        out["regions_over_device"] = (sum(regions) + per_step) / m["step.device_ms"]
    if m["device.idle_stage_ms"] is not None:
        t = rec.trace
        idle_ms = (t["window_s"] - t["busy_s"]) / rec.trace_steps * 1e3
        out["idle_stage_over_idle"] = m["device.idle_stage_ms"] / idle_ms
    return out


def line(spec, seed: int, tracer: bool, trace: bool, out: dict) -> dict:
    from . import cell, program
    from .spec import PKG, reader

    rec, tally = out["record"], out["tally"]
    metrics = {}
    for path in sorted((PKG / "metrics").glob("*.py")):
        value = reader(path.stem)(rec)
        if value is not None:
            metrics[path.stem] = value
    correct = out["samples"] > 0 and all(
        tally.values[k] <= spec.limits[k] for k in tally.values if spec.limits[k] is not None)
    got = {"workload": spec.name, "seed": seed, "tracer": tracer, "trace": int(trace),
           "correct": correct, "metrics": metrics, "card": cell.nvidia_smi()}
    if tracer:
        got["dropped"] = rec.program["dropped"]
        names = {s[program.NAME] for s in rec.program["spans"]}
        got["spans_ms"] = {n: program.per_step_ms(rec, n) for n in sorted(names)
                           if not n.startswith("setup.")}
        if trace:
            got["idle_ms"] = {n: v / rec.trace_steps * 1e3
                              for n, v in rec.trace["idle_in_program_s"].items()}
            got["ratios"] = ratios(rec)
    return got


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--oncost", action="store_true")
    args = p.parse_args(argv)

    import gc

    import torch

    from . import cell
    from .spec import load_cell

    spec = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench.traced: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    fps = {False: [], True: []}
    t_start = T_START
    for i, seed in enumerate(args.seeds):
        turns = [(False, False), (True, False)] if args.oncost else [(True, True)]
        if i % 2:
            turns.reverse()
        for tracer, trace in turns:
            out = traced_run(spec, seed, args.seconds, trace, device, t_start, tracer=tracer)
            got = line(spec, seed, tracer, trace, out)
            fps[tracer].append(got["metrics"]["stream_fps"])
            print(cell.dump(got), flush=True)
            del out
            gc.collect()
            torch.cuda.empty_cache()
            t_start = time.perf_counter()
    if args.oncost:
        off, on = statistics.median(fps[False]), statistics.median(fps[True])
        print(cell.dump({"workload": spec.name, "stream_fps_off": off, "stream_fps_on": on,
                         "change_pct": 100.0 * (on / off - 1.0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
