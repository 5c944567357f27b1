"""uvltrack_tpu_torch's evaluation CLIs (cli/test.py, cli/analyze.py,
cli/pack.py) against the JAX package's on the same inputs.

`cli.test.main` runs end to end on both packages: argparse, the experiment
yaml under UVLTRACK_REPO, --set, the checkpoint, the dataset adapter over an
OTB99 layout of JPEG frames, the single-stream or lockstep runner, the
result files and local scoring. The model is UVLTrack's tiny stand-in
(VIT_VARIANTS["base"] at C=32, 2 blocks, 4 heads; a 1-layer BERT;
32/64 px crops; fp32), monkeypatched on both packages as
tests/test_cli_smoke.py does, and both load one `.pth.tar` written from the
JAX variables (perturbed from a numpy seed) through from_jax_variables. The
port runs with --device cpu (the eager step).

Tolerances: result files hold rounded boxes, so each coordinate within 1 px
of the JAX CLI's; the unrounded boxes (taken where the runners save them)
within 1e-3 px, tests/test_torch_port_serve.py's bound. analyze prints and
writes the JAX CLI's text on the same result files; pack writes the same
zip members byte for byte.
"""

import io
import os
import shutil
import sys
import zipfile
from contextlib import redirect_stderr, redirect_stdout
from functools import partial

import numpy as np
import pytest
import torch

from uvltrack_tpu_torch.cli import analyze as tanalyze
from uvltrack_tpu_torch.cli import pack as tpack
from uvltrack_tpu_torch.cli import test as ttest
from uvltrack_tpu_torch.eval import environment as tenv

BOX_TOL = 1e-3
SEQS = {"Basket": 4, "Car": 3, "Dog": 5, "Eagle": 3, "Fish": 4}  # ragged: streams freeze
WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "the", "red", "box", "moving", "left",
         "basket", "car", "dog", "eagle", "fish"]


def _jax():
    """The JAX package's CLIs and environment module (imported on the CPU)."""
    from uvltrack_tpu.cli import analyze, pack, test
    from uvltrack_tpu.eval import environment

    return test, analyze, pack, environment


def _reset_envs():
    _jax()[3].reset_env_cache()
    tenv.reset_env_cache()


def _yaml(vocab: str) -> str:
    return ("DATA: {TEMPLATE: {SIZE: 32}, SEARCH: {SIZE: 64}}\n"
            "MODEL:\n"
            "  HIDDEN_DIM: 32\n"
            "  HEAD: {HEAD_DIM: 32}\n"
            "  BACKBONE:\n"
            "    FUSION_LAYER: [1]\n"
            "    CONT_LOSS_LAYER: [1]\n"
            f"    LANGUAGE: {{VOCAB_PATH: '{vocab}', BERT: {{MAX_QUERY_LEN: 8}}}}\n"
            "TEST: {TEMPLATE_SIZE: 32, SEARCH_SIZE: 64, TEMPLATE_FACTOR: 2.0,\n"
            "       SEARCH_FACTOR: 4.0, MODE: BBOX, EPOCH: 1, UPDATE_INTERVAL: 2,\n"
            "       THRESHOLD: -1.0}\n"
            "TPU: {COMPUTE_DTYPE: float32}\n")


def _tiny_models(mp):
    """The tiny stand-in on both packages' build_model."""
    from uvltrack_tpu.models import bert as jbert
    from uvltrack_tpu.models import uvltrack as juv
    from uvltrack_tpu.models.vit import VIT_VARIANTS as JV
    from uvltrack_tpu_torch.models import bert as tbert
    from uvltrack_tpu_torch.models import uvltrack as tuv
    from uvltrack_tpu_torch.models.vit import VIT_VARIANTS as TV

    for variants in (JV, TV):
        mp.setitem(variants, "base", dict(embed_dim=32, depth=2, num_heads=4))
    bert = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=4,
                intermediate_size=64, max_position=64)
    mp.setattr(juv, "bert_config_from_type", lambda t: jbert.BertConfig(**bert))
    mp.setattr(tuv, "bert_config_from_type", lambda t: tbert.BertConfig(**bert))


def _frame(rng, t, h=72, w=96):
    """A textured frame with a 20x18 target drifting right."""
    img = (rng.integers(0, 120, size=(h // 8, w // 8, 3)).repeat(8, 0).repeat(8, 1)
           + rng.integers(0, 60, size=(h, w, 3))).astype(np.uint8)
    x0, y0 = 30 + 2 * t, 24 + t
    img[y0:y0 + 18, x0:x0 + 20] = (220, 40, 40)
    return img, [float(x0), float(y0), 20.0, 18.0]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A repo root (UVLTRACK_REPO) holding the tiny experiment yaml, a
    vocab, an OTB99 layout of 5 ragged JPEG sequences with sentences, a
    GOT-10k test split (1-row ground truth), and the .pth.tar."""
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
    for name in ("tiny_cli", "tiny_found", "tiny_msgpack"):
        (exp / f"{name}.yaml").write_text(_yaml(str(vocab)))
    rng = np.random.default_rng(0)
    otb = root / "otb99"
    for k, (name, n) in enumerate(SEQS.items()):
        d = otb / "OTB_videos" / name / "img"
        d.mkdir(parents=True)
        gt = []
        for t in range(n):
            img, box = _frame(rng, t + k)
            cv2.imwrite(str(d / f"{t + 1:04d}.jpg"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
            gt.append(box)
        np.savetxt(otb / "OTB_videos" / name / "groundtruth_rect.txt", gt, delimiter=",",
                   fmt="%.1f")
        (otb / "OTB_query_test").mkdir(exist_ok=True)
        (otb / "OTB_query_test" / f"{name}.txt").write_text(f"the red {name.lower()} moving\n")
    got = root / "got10k" / "test"
    names = ["GOT-10k_Test_000001", "GOT-10k_Test_000002"]
    (got).mkdir(parents=True)
    (got / "list.txt").write_text("\n".join(names) + "\n")
    for name in names:
        (got / name).mkdir()
        box = None
        for t in range(3):
            img, b = _frame(rng, t)
            box = box or b
            cv2.imwrite(str(got / name / f"{t + 1:08d}.jpg"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        np.savetxt(got / name / "groundtruth.txt", [box], delimiter=",", fmt="%.4f")
    # the weights: the JAX model's, perturbed, as a reference .pth.tar
    mp = pytest.MonkeyPatch()
    _tiny_models(mp)
    try:
        jcfg = jload(str(exp / "tiny_cli.yaml"))
        jm = juv.build_model(jcfg)
        v = _perturb(_np_tree(juv.init_model(jm, jcfg, jax.random.PRNGKey(0))),
                     np.random.default_rng(21))
    finally:
        mp.undo()
    ckpt = root / "UVLTrack_ep0001.pth.tar"
    torch.save({"net": from_jax_variables(v["params"], v["batch_stats"]), "epoch": 1}, ckpt)
    found = root / "checkpoints" / "train" / "uvltrack" / "tiny_found"
    found.mkdir(parents=True)
    shutil.copy(ckpt, found / "UVLTrack_ep0001.pth.tar")
    stale = root / "checkpoints" / "train" / "uvltrack" / "tiny_msgpack"
    stale.mkdir(parents=True)
    (stale / "ep0001.msgpack").write_bytes(b"\x80")
    return root


@pytest.fixture
def env(root, monkeypatch):
    """Both packages on the tiny model, pointed at the root; the boxes each
    runner saves, unrounded, recorded by (package, sequence); int8 weights
    quantized at the tiny width (min_dim=1) by both."""
    from uvltrack_tpu.eval import running as jrun
    from uvltrack_tpu.eval import running_batched as jrunb
    from uvltrack_tpu.ops import quant as jquant
    from uvltrack_tpu_torch.eval import running as trun
    from uvltrack_tpu_torch.eval import running_batched as trunb
    from uvltrack_tpu_torch.ops import quant as tquant

    _tiny_models(monkeypatch)
    monkeypatch.setenv("UVLTRACK_REPO", str(root))
    monkeypatch.setenv("UVLTRACK_OTB99_PATH", str(root / "otb99"))
    monkeypatch.setenv("UVLTRACK_GOT10K_PATH", str(root / "got10k"))
    for q in (jquant, tquant):
        monkeypatch.setattr(q, "quantize_vit_params",
                            partial(q.quantize_vit_params, min_dim=1))
    saved = {}
    for pkg, mods in (("jax", (jrun, jrunb)), ("port", (trun, trunb))):
        for mod in mods:
            def record(results_dir, name, boxes, times, _orig=mod.save_results, _pkg=pkg):
                saved[(_pkg, name)] = np.asarray(boxes, np.float64).copy()
                _orig(results_dir, name, boxes, times)

            monkeypatch.setattr(mod, "save_results", record)
    yield saved
    _reset_envs()


def _main(mod, argv, results, monkeypatch):
    """mod.main(argv) with results under `results`; returns its stdout."""
    monkeypatch.setenv("UVLTRACK_RESULTS_PATH", str(results))
    _reset_envs()
    buf = io.StringIO()
    with redirect_stdout(buf):
        mod.main(argv)
    return buf.getvalue()


def _txt(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".txt") and not f.endswith("_time.txt"))


CASES = {
    "single": [],
    "chunk4": ["--chunk", "4"],
    "streams2": ["--streams", "2"],
    "nlbbox_streams2": ["--set", "TEST.MODE=NLBBOX", "--streams", "2"],
    "nlbbox": ["--set", "TEST.MODE=NLBBOX"],
    "int8": ["--quant", "int8"],
    "runid3": ["--runid", "3", "--set", "TEST.UPDATE_INTERVAL=3"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_test_matches_the_jax_cli(case, root, env, tmp_path, monkeypatch):
    """The same result files (within 1 px) and unrounded boxes (within
    1e-3 px) as the JAX CLI's on the same sequences and weights; the scores
    printed; --streams 2 makes one BatchTracker per group size, each on the
    prototype's JitTracker."""
    from uvltrack_tpu_torch.track import batch as tbatch

    made, built = [], []
    orig_init, orig_build = tbatch.BatchTracker.__init__, ttest.build_tracker

    def spy_init(self, *a, **kw):
        orig_init(self, *a, **kw)
        made.append(self)

    def spy_build(*a, **kw):
        built.append(orig_build(*a, **kw))
        return built[-1]

    monkeypatch.setattr(tbatch.BatchTracker, "__init__", spy_init)
    monkeypatch.setattr(ttest, "build_tracker", spy_build)
    argv = ["uvltrack", "tiny_cli", "--dataset_name", "otb99",
            "--test_checkpoint", str(root / "UVLTrack_ep0001.pth.tar")] + CASES[case]
    jout = _main(_jax()[0], argv, tmp_path / "jax", monkeypatch)
    tout = _main(ttest, argv + ["--device", "cpu"], tmp_path / "port", monkeypatch)
    mode = "NLBBOX" if "nlbbox" in case else "BBOX"
    param = "tiny_cli_003" if case == "runid3" else "tiny_cli"
    rel = os.path.join("uvltrack", param, f"otb99_{mode}_0001")
    jdir, tdir = tmp_path / "jax" / rel, tmp_path / "port" / rel
    assert _txt(tdir) == _txt(jdir) == [f"{s}.txt" for s in SEQS]
    for name, n in SEQS.items():
        got = np.loadtxt(tdir / f"{name}.txt", delimiter="\t", ndmin=2)
        want = np.loadtxt(jdir / f"{name}.txt", delimiter="\t", ndmin=2)
        assert got.shape == (n, 4)
        assert np.abs(got - want).max() <= 1.0, name
        np.testing.assert_allclose(env[("port", name)], env[("jax", name)], atol=BOX_TOL,
                                   rtol=0, err_msg=name)
    assert "AUC=" in tout and "AUC=" in jout
    assert "ERROR" not in tout and "failed" not in tout
    assert len(built) == 1 and built[0].device.type == "cpu"
    if "streams2" in case:
        assert sorted(bt.S for bt in made) == [1, 2]  # groups of 2, 2, 1
        assert all(bt.jt is built[0].jt for bt in made)
    else:
        assert made == []
    if case == "int8":
        from uvltrack_tpu_torch.ops import quant

        assert quant.count_quantized(built[0].model) > 0


def test_cli_test_save_vis_writes_the_jax_files(root, env, tmp_path, monkeypatch):
    """--save_vis with --vis_stride 2 and --vis_response (the debug step):
    the overlay and response-map files the JAX CLI writes, and its boxes."""
    argv = ["uvltrack", "tiny_cli", "--test_checkpoint", str(root / "UVLTrack_ep0001.pth.tar"),
            "--sequence", "Dog", "--vis_stride", "2", "--vis_response"]
    _main(_jax()[0], argv + ["--save_vis", str(tmp_path / "jvis")], tmp_path / "jax", monkeypatch)
    _main(ttest, argv + ["--save_vis", str(tmp_path / "tvis"), "--device", "cpu"],
          tmp_path / "port", monkeypatch)
    files = sorted(os.listdir(tmp_path / "tvis" / "Dog"))
    assert files == sorted(os.listdir(tmp_path / "jvis" / "Dog"))
    assert "0000.jpg" in files and "0002_merged.png" in files
    np.testing.assert_allclose(env[("port", "Dog")], env[("jax", "Dog")], atol=BOX_TOL, rtol=0)


def test_server_split_message_and_pack(root, env, tmp_path, monkeypatch):
    """A 1-row ground truth (GOT-10k test): no local score, the message
    names the port's pack CLI; pack then zips one file per sequence, the
    same members as the JAX pack CLI on the same results."""
    argv = ["uvltrack", "tiny_cli", "--dataset_name", "got10k_test",
            "--test_checkpoint", str(root / "UVLTrack_ep0001.pth.tar")]
    out = _main(ttest, argv + ["--device", "cpu", "--streams", "2"], tmp_path, monkeypatch)
    assert "cannot score locally" in out and "AUC=" not in out
    assert "python -m uvltrack_tpu_torch.cli.pack" in out
    zips = {}
    for name, mod in (("port", tpack), ("jax", _jax()[2])):
        _main(mod, ["got10k", "--tracker_param", "tiny_cli", "--dataset_name", "got10k_test",
                    "--out_dir", str(tmp_path / name)], tmp_path, monkeypatch)
        path = tmp_path / name / "uvltrack_tiny_cli_got10k_test.zip"
        with zipfile.ZipFile(path) as z:
            zips[name] = {n: z.read(n) for n in z.namelist()}
    assert zips["port"] == zips["jax"]
    files = sorted(n for n in zips["port"] if n.endswith("_001.txt"))
    assert files == [f"GOT-10k_Test_00000{i}/GOT-10k_Test_00000{i}_001.txt" for i in (1, 2)]


def test_checkpoint_discovery(root, env, tmp_path, monkeypatch):
    """UVLTrack_ep%04d.pth.tar under checkpoints/train/<name>/<param> is
    found and loaded (the boxes of the explicit checkpoint's run); an
    ep%04d.msgpack found first gets build_tracker's error."""
    out = _main(ttest, ["uvltrack", "tiny_found", "--sequence", "Car", "--device", "cpu"],
                tmp_path / "found", monkeypatch)
    assert "using checkpoint" in out and "UVLTrack_ep0001.pth.tar" in out
    found = env[("port", "Car")]
    _main(ttest, ["uvltrack", "tiny_cli", "--sequence", "Car", "--device", "cpu",
                  "--test_checkpoint", str(root / "UVLTrack_ep0001.pth.tar")],
          tmp_path / "given", monkeypatch)
    np.testing.assert_array_equal(found, env[("port", "Car")])
    with pytest.raises(ValueError, match="not a trainer checkpoint of the JAX package"):
        _main(ttest, ["uvltrack", "tiny_msgpack", "--device", "cpu"], tmp_path / "m",
              monkeypatch)


def test_multichip_is_refused(root, env, tmp_path, monkeypatch):
    """--multichip, refused while the port had no device mesh, now shards
    each lockstep group over the visible devices (two CPU replicas here, the
    device list of parallel/mesh.local_devices stood in): --multichip
    --streams 2 writes the result files of --streams 2 without it, and the
    unrounded boxes within 1e-3 px."""
    from uvltrack_tpu_torch.parallel import mesh as tmesh
    from uvltrack_tpu_torch.track import batch as tbatch

    argv = ["uvltrack", "tiny_cli", "--device", "cpu", "--streams", "2",
            "--test_checkpoint", str(root / "UVLTrack_ep0001.pth.tar")]
    _main(ttest, argv, tmp_path / "one", monkeypatch)
    plain = {k: v.copy() for k, v in env.items()}
    made = []
    orig = tbatch.MeshBatchTracker.__init__

    def spy(self, *a, **kw):
        orig(self, *a, **kw)
        made.append(self)

    monkeypatch.setattr(tbatch.MeshBatchTracker, "__init__", spy)
    monkeypatch.setattr(tmesh, "local_devices", lambda device=None: [torch.device("cpu")] * 2)
    out = _main(ttest, argv + ["--multichip"], tmp_path / "mesh", monkeypatch)
    assert "AUC=" in out and "ERROR" not in out
    assert sorted(bt.S_pad for bt in made) == [2, 2] and all(len(bt.replicas) == 2 for bt in made)
    rel = os.path.join("uvltrack", "tiny_cli", "otb99_BBOX_0001")
    assert _txt(tmp_path / "mesh" / rel) == _txt(tmp_path / "one" / rel) == [
        f"{s}.txt" for s in SEQS]
    for name in SEQS:
        assert ((tmp_path / "mesh" / rel / f"{name}.txt").read_bytes()
                == (tmp_path / "one" / rel / f"{name}.txt").read_bytes()), name
        np.testing.assert_allclose(env[("port", name)], plain[("port", name)], atol=BOX_TOL,
                                   rtol=0, err_msg=name)


def test_no_card_without_device_cpu_is_an_error(root, env, tmp_path, monkeypatch):
    """The CLI runs on cuda unless --device cpu is given: without a card it
    stops before any sequence runs, never falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _main(ttest, ["uvltrack", "tiny_cli", "--test_checkpoint",
                      str(root / "UVLTrack_ep0001.pth.tar")], tmp_path, monkeypatch)
    assert not (tmp_path / "uvltrack").exists()


# ----------------------------------------------------------------- analyze
def _fake_results(base, rng):
    """Result files of the tiny_cli tracker on otb99 (BBOX, epoch 1): the
    plain run and runs 0 and 1, noisy copies of the ground truth."""
    from uvltrack_tpu_torch.eval import get_dataset

    ds = get_dataset("otb99")
    for sub in ("tiny_cli", "tiny_cli_000", "tiny_cli_001"):
        d = base / "uvltrack" / sub / "otb99_BBOX_0001"
        d.mkdir(parents=True)
        for s in ds:
            boxes = s.ground_truth_rect + rng.normal(0, 3, s.ground_truth_rect.shape)
            np.savetxt(d / f"{s.name}.txt", np.round(np.abs(boxes)).astype(int),
                       delimiter="\t", fmt="%d")


ANALYZE = {
    "scores": [],
    "per_seq": ["--per_seq"],
    "per_seq_filter": ["--per_seq", "--filter", "delta_ao:0"],
    "run_ids": ["--run_ids", "0,1"],
    "run_ids_merge": ["--run_ids", "0,1", "--merge"],
    "merge": ["--merge", "--force_evaluation"],
}


@pytest.mark.parametrize("case", list(ANALYZE))
def test_analyze_matches_the_jax_cli(case, root, env, tmp_path, monkeypatch):
    """The same printed text and --save_file text as the JAX analyze CLI on
    the same result files (each package on its own copy, so the
    eval_data.pkl caches are their own; paths shown as <ROOT>)."""
    monkeypatch.setenv("UVLTRACK_RESULTS_PATH", str(tmp_path / "seed"))
    tenv.reset_env_cache()
    _fake_results(tmp_path / "seed", np.random.default_rng(3))
    texts = {}
    for name, mod in (("port", tanalyze), ("jax", _jax()[1])):
        shutil.copytree(tmp_path / "seed", tmp_path / name)
        save = tmp_path / f"{name}.txt"
        argv = ["--tracker_param", "tiny_cli", "--save_file", str(save)] + ANALYZE[case]
        out = _main(mod, argv, tmp_path / name, monkeypatch)
        texts[name] = (out.replace(str(tmp_path / name), "<ROOT>"), save.read_text())
    assert texts["port"] == texts["jax"]
    assert "AUC" in texts["port"][0] or "Sequence" in texts["port"][0]


def test_analyze_plots_got_json(root, env, tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    import json

    rep = tmp_path / "got.json"
    rep.write_text(json.dumps({"t": {"overall": {"ao": 0.4,
                                                 "succ_curve": list(np.linspace(1, 0, 101))}}}))
    for name, mod in (("port", tanalyze), ("jax", _jax()[1])):
        out = _main(mod, ["--tracker_param", "tiny_cli", "--got_json", f"t={rep}",
                          "--plot_dir", str(tmp_path / name)], tmp_path, monkeypatch)
        assert "got_success_plot.png" in out
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


def test_cli_modules_import_no_jax():
    """The port's CLIs (test, analyze, pack) import in a process where JAX
    cannot be imported."""
    import subprocess

    code = ("import sys; sys.modules['jax'] = None; sys.modules['uvltrack_tpu'] = None\n"
            "import uvltrack_tpu_torch.cli.test, uvltrack_tpu_torch.cli.analyze, "
            "uvltrack_tpu_torch.cli.pack, uvltrack_tpu_torch.eval\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         timeout=120)
    assert out.stdout.strip() == "ok", out.stderr


# ------------------------------------------------------------- on the card
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L_PER_FWD = {"ln_qkv[bf16x-bf16w]": 12, "ln_qkv[fp32x-bf16w]": 12, "qkv_attention[bf16]": 24,
             "dense[bf16a-bf16w-fp32o]": 72}  # + the default path's products


def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the chip)")


def _card_frames(seed, n, S=None, h=480, w=854):
    """Seeded uint8 frames: n of (h, w, 3), or n steps of S."""
    rng = np.random.default_rng(seed)
    shape = (n, h, w, 3) if S is None else (n, S, h, w, 3)
    return rng.integers(0, 255, size=shape, dtype=np.uint8)


@pytest.fixture(scope="module")
def large_on_card():
    """UVLTrack-L (baseline_large.yaml) at full width and depth on the
    card, seeded random weights, re-mines every 2 frames (the score gate
    opened)."""
    _on_card()
    from uvltrack_tpu_torch.config import load_cfg
    from uvltrack_tpu_torch.models.uvltrack import build_model, prepare_inference_model

    cfg = load_cfg(os.path.join(REPO, "experiments/uvltrack/baseline_large.yaml"))
    cfg.TEST.THRESHOLD, cfg.TEST.UPDATE_INTERVAL, cfg.TEST.MODE = -1.0, 2, "BBOX"
    return cfg, prepare_inference_model(cfg, build_model(cfg, device="cuda", seed=0))


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 8])
def test_cuda_large_graph_step_equals_the_eager_step(large_on_card, S):
    """UVLTrack-L at S streams: 6 steps (3 re-mines) on the step and
    re-mine graphs give the eager step's boxes, scores and prompts bit for
    bit; the step graph records 12 + 12 ln_qkv and 24 qkv_attention."""
    from uvltrack_tpu_torch.track.batch import BatchTracker
    from uvltrack_tpu_torch.track.tracker import JitTracker

    cfg, model = large_on_card
    jt = JitTracker(cfg, model)
    graph = BatchTracker(cfg, None, S, jit_tracker=jt)
    eager = BatchTracker(cfg, None, S, jit_tracker=jt, graphs=False)
    rng = np.random.default_rng(S)
    boxes = np.column_stack([rng.uniform(100, 600, S), rng.uniform(100, 300, S),
                             rng.uniform(50, 120, S), rng.uniform(50, 120, S)]).astype(np.float32)
    frames = _card_frames(S, 7, S)
    outs = []
    for bt in (eager, graph):
        bt.initialize(list(frames[0]), boxes)
        outs.append(np.stack([bt.step(frames[t]) for t in range(1, 7)]))
    np.testing.assert_array_equal(outs[1], outs[0])
    assert torch.equal(graph.state.prompt, eager.state.prompt)
    key, = jt.keys()
    assert jt.replays(key) == {"step": 6, "remine": 3}
    assert jt.captured_launches(key) == {"step": L_PER_FWD, "remine": {}}


@pytest.mark.gpu
def test_cuda_cli_test_equals_a_direct_tracker(tmp_path, monkeypatch):
    """cli.test.main with --device cuda (UVLTrack-B, BBOX) over a
    two-sequence OTB99 layout: its result files equal, byte for byte, a
    direct Tracker's on the CLI's JitTracker from the same decoded frames."""
    _on_card()
    import cv2

    from uvltrack_tpu_torch.eval import get_dataset
    from uvltrack_tpu_torch.eval.running import save_results
    from uvltrack_tpu_torch.native import imread_rgb
    from uvltrack_tpu_torch.track.tracker import Tracker

    otb = tmp_path / "otb99"
    rng = np.random.default_rng(5)
    for name, n in (("SeqA", 9), ("SeqB", 6)):
        d = otb / "OTB_videos" / name / "img"
        d.mkdir(parents=True)
        gt = []
        for t in range(n):
            img = _card_frames(10 * n + t, 1, h=360, w=640)[0]
            x0, y0 = 200 + 5 * t, 120 + 3 * t
            img[y0:y0 + 60, x0:x0 + 80] = rng.integers(0, 255, (60, 80, 3), dtype=np.uint8)
            cv2.imwrite(str(d / f"{t + 1:04d}.jpg"), img[..., ::-1])
            gt.append([x0, y0, 80, 60])
        np.savetxt(otb / "OTB_videos" / name / "groundtruth_rect.txt", gt, delimiter=",",
                   fmt="%d")
        (otb / "OTB_query_test").mkdir(exist_ok=True)
        (otb / "OTB_query_test" / f"{name}.txt").write_text("a box\n")
    monkeypatch.setenv("UVLTRACK_REPO", REPO)
    monkeypatch.setenv("UVLTRACK_OTB99_PATH", str(otb))
    monkeypatch.setenv("UVLTRACK_RESULTS_PATH", str(tmp_path / "results"))
    built, orig = [], ttest.build_tracker
    monkeypatch.setattr(ttest, "build_tracker",
                        lambda *a, **kw: built.append(orig(*a, **kw)) or built[-1])
    tenv.reset_env_cache()
    try:
        with redirect_stdout(io.StringIO()):
            ttest.main(["uvltrack", "baseline_base", "--set", "TEST.MODE=BBOX",
                        "--set", "TEST.THRESHOLD=-1"])
        proto = built[0]
        assert proto.device.type == "cuda" and proto.graphs
        t = Tracker(proto.cfg, jit_tracker=proto.jt)
        for seq in get_dataset("otb99"):
            frames = [imread_rgb(f) for f in seq.frames]
            boxes = [t.initialize(frames[0], seq.init_info())["target_bbox"]]
            boxes += [t.track(f)["target_bbox"] for f in frames[1:]]
            save_results(str(tmp_path / "direct"), seq.name, np.asarray(boxes), np.zeros(len(boxes)))
            rdir = tmp_path / "results" / "uvltrack" / "baseline_base" / "otb99_BBOX_0300"
            assert (rdir / f"{seq.name}.txt").read_bytes() == \
                (tmp_path / "direct" / f"{seq.name}.txt").read_bytes()
    finally:
        tenv.reset_env_cache()


def test_gpu_tests_need_no_jax_at_import():
    """The card's machine has no JAX: this module imports it only inside
    the CPU tests."""
    src = open(os.path.abspath(__file__)).read()
    head = src[:src.index("\ndef ")]
    assert "import jax" not in head and "from uvltrack_tpu." not in head
