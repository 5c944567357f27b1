"""A run with its timed path broken underneath must come out not correct.
The run is driven past the harness's look for a card (cell.run on the CPU,
the tiny configuration, the stand-in graph capture) under the limits of the
benchmark's cells, with each fault a tracking cell can have planted after
set-up (portbench/faults.py): a step that returns its state unchanged; half
of the batch left out, its rows given the mean of the rest; an answer
altered where it is produced. (The exchange between chips does not exist in
these one-chip cells.) Each fault must push a compared number to twice its
limit or more."""

import pytest

from portbench import spec
from portbench.faults import altered, half_left_out, unchanged

from .helpers import tiny_cell, tiny_port, tiny_run

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def raises(drv):
    """A step that raises: its stream-frames count as failed and the window ends."""
    def step(frames):
        raise RuntimeError("a planted failure")

    drv.step = step


@pytest.mark.parametrize("limits_of", CELLS)
@pytest.mark.parametrize("fault,mix", [(unchanged, "tiny-S1"), (unchanged, "tiny-S3"),
                                       (half_left_out, "tiny-S3"), (altered, "tiny-S1"),
                                       (altered, "tiny-S3"), (raises, "tiny-S3")])
def test_a_broken_step_is_not_correct(monkeypatch, fault, mix, limits_of):
    tiny_port(monkeypatch)
    cell = tiny_cell(mix, limits_of=limits_of)
    out = tiny_run(cell, seed=21, seconds=1.0, fault=fault)
    t = out["tally"]
    over = {k: t.values[k] for k in t.values
            if cell.limits[k] is not None and t.values[k] > 2 * cell.limits[k]}
    assert over, t.values
