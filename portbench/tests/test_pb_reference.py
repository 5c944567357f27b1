"""The reference (reference/model.py) against the port's plain backend:
the tiny configuration at fp32 compute (TPU.COMPUTE_DTYPE=float32, so both
sides compute the same function in the same precision), driven through the
whole harness on the CPU: initialize, the stagger, warm-up, a window, the
sampled steps' maps, boxes, best features and re-mined prompts."""

import json

import pytest

from portbench.check import ORDER

from .helpers import DATA, tiny_cell, tiny_port, tiny_run

FP32_TOL = {"prompt_err": 1e-4, "map_err": 1e-4, "pick_gap": 0.0, "box_err": 1e-5,
            "feat_err": 1e-4, "remine_wrong": 0, "failed": 0}


@pytest.mark.parametrize("mix", ["tiny-S3", "tiny-S1"])
def test_reference_matches_the_plain_backend_at_fp32(monkeypatch, mix):
    tiny_port(monkeypatch)
    cell = tiny_cell(mix, compute_dtype="float32")
    cell.config["overrides"] = cell.config["overrides"] + ["TPU.COMPUTE_DTYPE=float32",
                                                           "TPU.USE_PALLAS_ATTENTION=False"]
    out = tiny_run(cell, seed=11, seconds=1.5)
    t = out["tally"]
    assert out["samples"] >= 2
    for k in ORDER:
        assert t.values[k] <= FP32_TOL[k], (k, t.values[k])
    # every number was read on some rows: the re-mines refreshed, steps became best
    assert all(t.rows[k] > 0 for k in ORDER), t.rows
    assert t.rows["prompt_err"] > len(cell.traffic["modes"])


def test_tiny_config_is_uvltrack_b_cut():
    tiny = json.loads((DATA / "tiny.json").read_text())
    assert tiny["yaml"] == "baseline_base.yaml" and tiny["dims"]["embed_dim"] == 64
