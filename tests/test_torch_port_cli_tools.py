"""uvltrack_tpu_torch's tool CLIs (cli/profile.py, export.py, parity.py,
demo.py, setup_env.py) against the JAX package's, on the tiny model of
tests/test_torch_port_cli_test.py (VIT_VARIANTS["base"] at C=32, 2 blocks,
4 heads; a 1-layer BERT; 32/64 px crops; fp32), monkeypatched on both
packages, with one `.pth.tar` written from the JAX variables (perturbed from
a numpy seed) through from_jax_variables. The port runs with --device cpu.

Tolerances: parity dumps key by key within 1e-4 (fp32 on both sides, sums
in another order; the JAX port tests' 1e-4 of the model); demo boxes within
1 px of the JAX demo's, as the CLI test's result files. The export check is
the CLI's own (1e-5, the JAX CLI's).

Kernels under export: with `_on_card` monkeypatched true (as
tests/test_torch_port_fused.py does) and UVLTRACK_PALLAS_MIN_N under the
tiny sequences, the kernel entries go through the custom ops of
ops/library.py under torch.export (the exported graph holds uvltrack::ln_qkv
and the others; run, each op calls its wrapper, here the plain version),
while the eager path never passes through them.
"""

import io
import json
import os
import re
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

from test_torch_port_cli_test import WORDS, _tiny_models, _yaml
from uvltrack_tpu_torch.cli import demo as tdemo
from uvltrack_tpu_torch.cli import export as texport
from uvltrack_tpu_torch.cli import parity as tparity
from uvltrack_tpu_torch.cli import profile as tprofile
from uvltrack_tpu_torch.cli import setup_env as tsetup
from uvltrack_tpu_torch.eval import environment as tenv
from uvltrack_tpu_torch.ops import attention as tattn
from uvltrack_tpu_torch.ops import library

PARITY_TOL = 1e-4
BOX_PX = 1.0
CLIS = {"profile": tprofile, "export": texport, "parity": tparity, "demo": tdemo,
        "setup_env": tsetup}


def _reset_envs():
    from uvltrack_tpu.eval import environment as jenv

    jenv.reset_env_cache()
    tenv.reset_env_cache()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A repo root (UVLTRACK_REPO) with the tiny experiment yaml, a vocab,
    the .pth.tar and a 6-frame MJPG clip (tests/test_demo_functional.py's)."""
    import cv2
    import jax

    from test_torch_port_model import _np_tree, _perturb
    from uvltrack_tpu.config import load_cfg as jload
    from uvltrack_tpu.models import uvltrack as juv
    from uvltrack_tpu_torch.models.convert import from_jax_variables

    root = tmp_path_factory.mktemp("repo")
    vocab = root / "vocab.txt"
    vocab.write_text("\n".join(WORDS) + "\n")
    exp = root / "experiments" / "uvltrack"
    exp.mkdir(parents=True)
    (exp / "tiny.yaml").write_text(_yaml(str(vocab)))
    mp = pytest.MonkeyPatch()
    _tiny_models(mp)
    try:
        jcfg = jload(str(exp / "tiny.yaml"))
        jm = juv.build_model(jcfg)
        v = _perturb(_np_tree(juv.init_model(jm, jcfg, jax.random.PRNGKey(0))),
                     np.random.default_rng(21))
    finally:
        mp.undo()
    torch.save({"net": from_jax_variables(v["params"], v["batch_stats"]), "epoch": 1},
               root / "UVLTrack_ep0001.pth.tar")
    rng = np.random.default_rng(0)
    w, h = 320, 240
    writer = cv2.VideoWriter(str(root / "clip.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 10, (w, h))
    assert writer.isOpened(), "cv2 VideoWriter unavailable"
    for i in range(6):
        frame = rng.integers(0, 80, size=(h, w, 3)).astype(np.uint8)
        x = 60 + 6 * i
        frame[100:140, x:x + 40] = (30, 220, 30)  # a moving green square
        writer.write(frame)
    writer.release()
    return root


@pytest.fixture
def env(root, monkeypatch):
    """Both packages on the tiny model, pointed at the root; int8 quantizes
    at the tiny width (min_dim=1) in both."""
    from uvltrack_tpu.ops import quant as jquant
    from uvltrack_tpu_torch.ops import quant as tquant

    _tiny_models(monkeypatch)
    monkeypatch.setenv("UVLTRACK_REPO", str(root))
    for q in (jquant, tquant):
        monkeypatch.setattr(q, "quantize_vit_params", lambda m, _f=q.quantize_vit_params,
                            **k: _f(m, **{**k, "min_dim": 1}))
    _reset_envs()
    yield root
    _reset_envs()


def _run(mod, argv):
    """mod.main(argv); returns (its return value, its stdout)."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        ret = mod.main(argv)
    return ret, buf.getvalue()


@pytest.mark.parametrize("name", sorted(CLIS))
def test_help(name):
    out = io.StringIO()
    with redirect_stdout(out), pytest.raises(SystemExit) as e:
        CLIS[name].main(["--help"])
    assert e.value.code == 0 and out.getvalue().startswith("usage:")


@pytest.mark.parametrize("name,argv", [
    ("profile", []), ("export", []), ("parity", ["--checkpoint", "x.pth.tar"]),
    ("demo", ["--video", "x.avi", "--init_bbox", "1", "1", "4", "4"])])
def test_no_card_without_device_cpu_is_an_error(name, argv, env, monkeypatch):
    """Each CLI runs on cuda unless --device cpu is given: without a card it
    stops with an error before any model is built."""
    from uvltrack_tpu_torch.models import uvltrack as tuv

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tuv, "build_model", lambda *a, **k: pytest.fail("model built"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CLIS[name].main(["--config" if name != "demo" else "--tracker_param", "tiny", *argv])


LATENCY = re.compile(r"^(forward|step) \(batch=(\d+)\): mean=([\d.]+)ms p50=([\d.]+)ms "
                     r"p90=([\d.]+)ms fps=([\d.]+)$", re.M)


@pytest.mark.parametrize("what", ["forward", "step"])
def test_profile_runs_and_writes_a_trace(what, env, tmp_path):
    trace = tmp_path / "trace"
    _, out = _run(tprofile, ["--config", "tiny", "--what", what, "--iters", "3", "--warmup", "1",
                             "--batch", "2" if what == "forward" else "1", "--device", "cpu",
                             "--trace_dir", str(trace)])
    m = LATENCY.search(out)
    assert m and m.group(1) == what
    p50, fps = float(m.group(4)), float(m.group(6))
    assert p50 > 0 and fps > 0
    if what == "forward":
        assert m.group(2) == "2"
        cost = re.search(r"counted cost: ([\d.]+) GFLOPs, (\d+) MB accessed", out)
        assert cost and float(cost.group(1)) > 0
    events = json.loads((trace / "trace.json").read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)


def test_profile_plain_backend_and_int8(env):
    _, out = _run(tprofile, ["--config", "tiny", "--iters", "2", "--warmup", "1", "--xla",
                             "--quant", "int8", "--device", "cpu"])
    assert LATENCY.search(out) and tattn.get_backend() == "plain"
    tattn.set_backend("cuda")


JAX_MANIFEST_KEYS = {"config", "checkpoint", "batch", "platforms", "n_args_flat",
                     "example_arg_shapes", "outputs", "bytes"}


def test_export_round_trip(env, tmp_path):
    """The exported program, loaded back by --check, reproduces the direct
    call; the manifest has the JAX manifest's keys but
    calling_convention_version, plus kernel_ops."""
    out = tmp_path / "tiny.pt2"
    ckpt = str(env / "UVLTrack_ep0001.pth.tar")
    _, log = _run(texport, ["--config", "tiny", "--checkpoint", ckpt, "--out", str(out),
                            "--batch", "2", "--check", "--device", "cpu"])
    assert "check: loaded program matches the direct call" in log
    manifest = json.loads((tmp_path / "tiny.pt2.json").read_text())
    assert set(manifest) == JAX_MANIFEST_KEYS | {"kernel_ops"}
    assert manifest["platforms"] == ["cpu"] and manifest["kernel_ops"] == {}
    assert manifest["bytes"] == os.path.getsize(out)
    assert manifest["example_arg_shapes"] == [[2, 32, 32, 3], [2, 64, 64, 3], [2, 8], [2, 8],
                                              [2, 3, 32], [2]]
    err = io.StringIO()
    with redirect_stderr(err), pytest.raises(SystemExit) as e:
        texport.main(["--config", "tiny", "--platforms", "cuda,cpu", "--out", str(out)])
    assert e.value.code == 2 and "one device" in err.getvalue()


def test_kernel_route_goes_through_the_custom_ops_under_export(env, tmp_path, monkeypatch):
    """The kernel entries (gates open on the CPU) reach the uvltrack ops
    under torch.export: the graph holds ln_qkv and qkv_attention in both
    blocks and BERT's attention (kernel #3 past UVLTRACK_PALLAS_MIN_N), and
    the loaded program matches the direct call; the eager call of the same
    model never enters an op."""
    monkeypatch.setattr(tattn, "_on_card", lambda t: True)
    monkeypatch.setenv("UVLTRACK_PALLAS_MIN_N", "8")
    out = tmp_path / "k.pt2"
    _run(texport, ["--config", "tiny", "--out", str(out), "--check", "--device", "cpu"])
    counts = library.op_counts(torch.export.load(str(out)))
    assert counts == {"ln_qkv": 2, "qkv_attention": 2, "attention": 1}
    assert json.loads((tmp_path / "k.pt2.json").read_text())["kernel_ops"] == counts

    from uvltrack_tpu_torch.cli.test import build_tracker
    from uvltrack_tpu_torch.config import load_cfg
    from uvltrack_tpu_torch.models.uvltrack import example_test_inputs, forward_test_fn

    calls = []
    for name in library.OPS:
        op = getattr(library, name)
        monkeypatch.setattr(library, name, lambda *a, _op=op, _n=name: calls.append(_n) or _op(*a))
    cfg = load_cfg(str(env / "experiments" / "uvltrack" / "tiny.yaml"))
    model = build_tracker(cfg, None, device="cpu").model
    with torch.no_grad():
        forward_test_fn(model)(*example_test_inputs(cfg, model))
    assert calls == []


def _jax_parity(argv):
    from uvltrack_tpu.cli import parity as jparity

    jparity.main(argv)


@pytest.mark.parametrize("extra", [[], ["--language", "the red box moving"],
                                   ["--quant", "int8"]])
def test_parity_dump_matches_jax(extra, env, tmp_path):
    ckpt = str(env / "UVLTrack_ep0001.pth.tar")
    base = ["--config", "tiny", "--checkpoint", ckpt, "--seed", "3", *extra]
    _jax_parity(base + ["--out", str(tmp_path / "jax.npz")])
    _run(tparity, base + ["--out", str(tmp_path / "port.npz"), "--device", "cpu"])
    jd, td = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(td.files) == sorted(jd.files)
    for k in jd.files:
        np.testing.assert_allclose(td[k].astype(np.float64), jd[k].astype(np.float64),
                                   atol=PARITY_TOL, rtol=PARITY_TOL, err_msg=k)


def test_parity_dump_of_an_image_matches_jax(env, tmp_path):
    """--image/--bbox: the crops through each package's pipeline."""
    import cv2

    img = np.random.default_rng(5).integers(0, 255, size=(90, 120, 3)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "f.png"), img)
    ckpt = str(env / "UVLTrack_ep0001.pth.tar")
    base = ["--config", "tiny", "--checkpoint", ckpt, "--image", str(tmp_path / "f.png"),
            "--bbox", "30", "20", "40", "30"]
    _jax_parity(base + ["--out", str(tmp_path / "jax.npz")])
    _run(tparity, base + ["--out", str(tmp_path / "port.npz"), "--device", "cpu"])
    jd, td = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(td.files) == sorted(jd.files)
    for k in jd.files:
        np.testing.assert_allclose(td[k].astype(np.float64), jd[k].astype(np.float64),
                                   atol=PARITY_TOL, rtol=PARITY_TOL, err_msg=k)


def _frames(path):
    import cv2

    cap = cv2.VideoCapture(str(path))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


@pytest.mark.parametrize("mode", [["--init_bbox", "60", "100", "40", "40"],
                                  ["--init_bbox", "60", "100", "40", "40",
                                   "--language", "the red box"]])
def test_demo_matches_jax(mode, env, tmp_path, monkeypatch):
    """Frames out equal frames in; every box within 1 px of the JAX demo's
    (its boxes taken from its Tracker's init and track returns)."""
    from uvltrack_tpu.cli import demo as jdemo
    from uvltrack_tpu.track import tracker as jtracker

    jboxes = []
    for meth in ("initialize", "track"):
        orig = getattr(jtracker.Tracker, meth)

        def rec(self, *a, _orig=orig, **k):
            out = _orig(self, *a, **k)
            jboxes.append(list(out["target_bbox"]))
            return out

        monkeypatch.setattr(jtracker.Tracker, meth, rec)
    ckpt = str(env / "UVLTrack_ep0001.pth.tar")
    argv = ["--tracker_param", "tiny", "--video", str(env / "clip.avi"),
            "--test_checkpoint", ckpt, *mode]
    with redirect_stdout(io.StringIO()):
        jdemo.main(argv + ["--output", str(tmp_path / "jax.mp4")])
    boxes, log = _run(tdemo, argv + ["--output", str(tmp_path / "port.mp4"), "--device", "cpu"])
    assert "tracked 6 frames" in log
    assert _frames(tmp_path / "port.mp4") == _frames(env / "clip.avi") == 6
    assert len(boxes) == len(jboxes) == 6
    np.testing.assert_allclose(np.asarray(boxes, np.float64), np.asarray(jboxes, np.float64),
                               atol=BOX_PX, rtol=0)


def test_setup_env_writes_the_jax_clis_file(tmp_path, monkeypatch):
    """The same local_paths.yaml, byte for byte, for the same repo root; the
    port's environment reads it; --force is needed to overwrite."""
    import types

    from uvltrack_tpu.cli import setup_env as jsetup

    repo = tmp_path / "repo"
    repo.mkdir()
    monkeypatch.setenv("UVLTRACK_REPO", str(repo))
    _run(tsetup, [])
    port = (repo / "local_paths.yaml").read_text()
    _, again = _run(tsetup, [])
    assert "already exists" in again
    (repo / "local_paths.yaml").unlink()
    # the JAX CLI takes the root from its own file's path: point it at repo
    fake_os = types.SimpleNamespace(path=types.SimpleNamespace(
        dirname=os.path.dirname, join=os.path.join, exists=os.path.exists,
        abspath=lambda p: str(repo / "pkg" / "cli" / "setup_env.py")))
    monkeypatch.setattr(jsetup, "os", fake_os)
    with redirect_stdout(io.StringIO()):
        jsetup.main([])
    assert (repo / "local_paths.yaml").read_text() == port
    (repo / "local_paths.yaml").write_text(port.replace("otb99_path: ''", "otb99_path: /data/otb"))
    tenv.reset_env_cache()
    assert tenv.env_settings().otb99_path == "/data/otb"
    tenv.reset_env_cache()
