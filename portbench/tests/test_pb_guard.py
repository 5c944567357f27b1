"""The whole-name check for JAX, jaxlib, flax and the JAX package."""

import subprocess
import sys

import pytest

from portbench.guard import forbidden_loaded
from portbench.spec import ROOT


@pytest.mark.parametrize("names,found", [
    (["uvltrack_tpu_torch", "uvltrack_tpu_torch.track.tracker", "torch"], []),
    (["uvltrack_tpu", "uvltrack_tpu_torch"], ["uvltrack_tpu"]),
    (["uvltrack_tpu.models.vit"], ["uvltrack_tpu"]),
    (["jax.numpy", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["jaxtyping", "flaxen", "uvltrack_tpu_tools", "myjax"], []),
])
def test_names_compared_whole(names, found):
    assert forbidden_loaded(names) == found


def test_the_port_loads_none():
    code = ("import uvltrack_tpu_torch.track.batch, uvltrack_tpu_torch.models.uvltrack\n"
            "import portbench.cell, portbench.run\n"
            "from portbench.guard import forbidden_loaded\n"
            "import sys\n"
            "assert 'uvltrack_tpu_torch' in sys.modules\n"
            "print(forbidden_loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_loaded_jax_package_is_flagged():
    code = ("import sys, types\n"
            "sys.modules['uvltrack_tpu'] = types.ModuleType('uvltrack_tpu')\n"
            "from portbench.guard import forbidden_loaded\n"
            "print(forbidden_loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.stdout.strip() == "['uvltrack_tpu']"
