"""On the card (`python -m pytest portbench/tests -m gpu`): the precision
control, the reference in float8 put in the program's place on the same
sampled states, comes out not correct at each cell's own size, on three
seeds, while the program on those seeds comes out correct."""

import time

import pytest
import torch

from portbench import cell as run_cell
from portbench import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_fp8_control_is_not_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run the port's CUDA-graph step")
    c = spec.load_cell(name)
    for seed in (31, 2**31 + 7, 424242):
        out = run_cell.run(c, seed, 3.0, False, torch.device("cuda", 0), time.perf_counter(),
                           fp8_control=True)
        sound, fp8 = out["tally"].values, out["fp8_tally"].values
        compared = [k for k in sound if c.limits[k] is not None]
        assert all(sound[k] <= c.limits[k] for k in compared), (seed, sound)
        assert any(fp8[k] > c.limits[k] for k in compared), (seed, fp8)
