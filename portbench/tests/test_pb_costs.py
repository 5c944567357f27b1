"""The frozen arithmetic against the port's own frame_cost at both widths,
and the roofline roles' bounds."""

import json

import pytest
import torch

from portbench.costs.arith import attention_bound_s, frame_flops, linear_bound_s
from portbench.spec import PKG


def port_model(name: str):
    import uvltrack_tpu_torch.models.uvltrack as U
    from uvltrack_tpu_torch.config import load_cfg

    saved = U.init_model
    U.init_model = lambda m, seed=0: m
    try:
        return U.build_model(load_cfg(str(PKG / "configs" / name)), device="meta")
    finally:
        U.init_model = saved


@pytest.mark.parametrize("config,yaml", [("uvltrack-b", "baseline_base.yaml"),
                                         ("uvltrack-l", "baseline_large.yaml")])
def test_frozen_frame_flops_equal_the_ports(config, yaml):
    from uvltrack_tpu_torch.track.tracker import frame_cost

    d = json.loads((PKG / "configs" / f"{config}.json").read_text())["dims"]
    assert frame_flops(d) == frame_cost(port_model(yaml), d["max_query_len"])["flops"]


def test_frame_flops_values():
    b = json.loads((PKG / "configs" / "uvltrack-b.json").read_text())["dims"]
    lg = json.loads((PKG / "configs" / "uvltrack-l.json").read_text())["dims"]
    assert frame_flops(b) == pytest.approx(67.02e9, rel=1e-3)
    assert 3.2 < frame_flops(lg) / frame_flops(b) < 3.5


def test_role_bounds():
    d = json.loads((PKG / "configs" / "uvltrack-b.json").read_text())["dims"]
    # B=8: every block's products bound by operations: 24 N C^2 each
    ops = sum(24 * 8 * n * 768 ** 2 for n in [321] * 6 + [361] * 6)
    assert linear_bound_s(d, 8) == pytest.approx(ops / 989e12, rel=1e-6)
    # the attention is bound by its bytes at N=361 (0.66 us a row at B=1)
    assert attention_bound_s(d, 1) / 12 == pytest.approx(0.63e-6, rel=0.1)
    assert attention_bound_s(d, 8) == pytest.approx(8 * attention_bound_s(d, 1), rel=1e-6)
    assert torch.isfinite(torch.tensor(linear_bound_s(d, 1)))
