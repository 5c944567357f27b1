"""Shared set-up of the CPU tests: the tiny configuration (uvltrack-b's
code path cut to C=64, 4 blocks, 2 heads, a 2-head BERT of width 64, 32/64
px crops, a re-mine every 4 frames), the tiny mixes (3 lockstep streams or
one, 96x160 frames), the port patched to those widths, and the stand-in for
a CUDA graph capture on the CPU (each replay calls the body again)."""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch

from portbench import cell as run_cell
from portbench.spec import PKG, Cell

DATA = Path(__file__).resolve().parent / "data"


def tiny_port(monkeypatch) -> None:
    from uvltrack_tpu_torch.models import uvltrack as U
    from uvltrack_tpu_torch.models import vit
    from uvltrack_tpu_torch.models.bert import BertConfig
    from uvltrack_tpu_torch.track.tracker import JitTracker

    monkeypatch.setitem(vit.VIT_VARIANTS, "base", dict(embed_dim=64, depth=4, num_heads=2))
    monkeypatch.setattr(U, "bert_config_from_type", lambda t: BertConfig(
        hidden_size=64, num_layers=12, num_heads=2, intermediate_size=128))

    def eager_capture(self, fn):
        out = dict(fn())
        return (lambda: out.update(fn())), out

    monkeypatch.setattr(JitTracker, "_capture", eager_capture)


def tiny_cell(mix: str = "tiny-S3", limits_of: str = "B-S8-mixed", **dims) -> Cell:
    cfg = json.loads((DATA / "tiny.json").read_text())
    cfg["dims"].update(dims)
    limits = json.loads((PKG / "workloads" / f"{limits_of}.json").read_text())["limits"]
    return Cell("tiny", 1, cfg, json.loads((DATA / f"{mix}.json").read_text()), limits, [], [])


def tiny_run(cell: Cell, seed: int = 5, seconds: float = 0.5, **kw) -> dict:
    return run_cell.run(cell, seed, seconds, False, torch.device("cpu"), time.perf_counter(),
                        force_graphs=True, **kw)
