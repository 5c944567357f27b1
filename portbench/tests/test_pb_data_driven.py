"""A cell, a traffic mix and a metric added as files to a copy of the
benchmark are found by name, with no file of the copy edited."""

import json
import shutil
import subprocess
import sys

from portbench.spec import PKG, ROOT


def test_added_files_are_found(tmp_path):
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    mix = json.loads((PKG / "traffic" / "S8-mixed.json").read_text())
    mix["modes"] = ["BBOX"] * 4
    (tmp_path / "portbench" / "traffic" / "S4-bbox.json").write_text(json.dumps(mix))
    limits = json.loads((PKG / "workloads" / "B-S8-mixed.json").read_text())
    (tmp_path / "portbench" / "workloads" / "B-S4-bbox.json").write_text(json.dumps(limits))
    (tmp_path / "portbench" / "metrics" / "host.steps.py").write_text(
        "def read(run):\n    return run.steps\n")
    bench["workloads"].append({"name": "B-S4-bbox", "config": "uvltrack-b", "traffic": "S4-bbox",
                               "chips": 1, "why": "added"})
    bench["per_layer"].append({"name": "host.steps", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "lockstep and tracker step",
                               "moves": "stream_fps"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("from types import SimpleNamespace\n"
            "from portbench.spec import load_cell, reader\n"
            "from portbench.traffic.generator import stagger\n"
            "c = load_cell('B-S4-bbox')\n"
            "print(c.config['name'], c.traffic['modes'], stagger(c.traffic),\n"
            "      [m['name'] for m in c.per_layer][-1], reader('host.steps')(SimpleNamespace(steps=3)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, env={"PYTHONPATH": str(tmp_path), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["uvltrack-b", "['BBOX',", "'BBOX',", "'BBOX',", "'BBOX']",
                                  "[0,", "5,", "10,", "15]", "host.steps", "3"]


def test_a_checkout_without_the_port_prints_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and portbench/ cannot run."""
    shutil.copytree(PKG, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "B-S1-bbox",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": str(tmp_path), "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
