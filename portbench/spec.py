"""What a cell is made of, found by name: BENCHMARK.json at the root of the
checkout names the cell's configuration and traffic mix and the metrics it
reports; portbench/configs/<config>.json, portbench/traffic/<traffic>.json
and portbench/workloads/<cell>.json hold them, and each metric's reader is
portbench/metrics/<metric>.py. Adding a cell, a mix or a metric adds files
and edits none."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    from .traffic.generator import load as load_traffic

    config = json.loads((PKG / "configs" / f"{entry['config']}.json").read_text())
    cell_file = json.loads((PKG / "workloads" / f"{name}.json").read_text())
    return Cell(name=name, chips=int(entry["chips"]), config=config,
                traffic=load_traffic(entry["traffic"]), limits=cell_file["limits"],
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def reader(metric: str):
    """The read(run) function of portbench/metrics/<metric>.py."""
    path = PKG / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
