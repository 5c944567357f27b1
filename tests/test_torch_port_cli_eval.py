"""uvltrack_tpu_torch's evaluation modules against the JAX package's on the
same inputs: the config overrides (`CfgNode.merge_from_list`, `dump_yaml`),
every dataset adapter of `eval/datasets.py` and `eval/datasets_extra.py` on
synthetic layouts of the benchmarks' own directory structures, the metrics
(`eval/metrics.py`), the packagers and the plots; `BatchTracker.step_many_cost`;
and UVLTrack-L's model (`baseline_large.yaml`) at a stand-in width.

Tolerances: the copied modules are numpy on both sides, so their outputs are
held exactly equal (NaN rows included), report texts character for
character and zip members byte for byte; exceptions by type. The L model in
fp32 at tests/test_torch_port_model.py's 1e-4 abs and rel.
"""

import io
import os
import zipfile
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from uvltrack_tpu.eval import environment as jenv
from uvltrack_tpu_torch.eval import environment as tenv

# ------------------------------------------------------------------ config
OVERRIDES = [
    ["TEST.EPOCH=2"],
    ["TRAIN.LR=1e-4"],
    ["TEST.THRESHOLD=2"],
    ["TPU.CACHE_TEXT=false", "TEST.MODE=NL"],
    ["MODEL.BACKBONE.FUSION_LAYER=[1,2]"],
    ["TEST={EPOCH: 5, MODE: NLBBOX}"],
    ["TEST.UPDATE_INTERVALS={}"],
    ["TEST.NOPE=1"],
    ["NOPE.EPOCH=1"],
    ["TEST=3"],
    ["TEST.EPOCH=true"],
    ["TEST.EPOCH=2.5"],
    ["TEST.EPOCH"],
    ["TEST.EPOCH.X=1"],
    ["TEST={EPOCH: fast}"],
    ["TEST={NOPE: 1}"],
]


def _apply(cfg, items):
    try:
        cfg.merge_from_list(items)
    except Exception as e:  # noqa: BLE001 -- the type is what is compared
        return type(e)
    return cfg.to_dict()


@pytest.mark.parametrize("items", OVERRIDES, ids=lambda v: ",".join(v))
def test_merge_from_list_matches_jax(items):
    """The same tree after the overrides, or the same exception type."""
    from uvltrack_tpu.config import default_cfg as jdefault
    from uvltrack_tpu_torch.config import default_cfg

    want, got = _apply(jdefault(), items), _apply(default_cfg(), items)
    assert got == want


def test_dump_yaml_matches_jax(tmp_path):
    from uvltrack_tpu.config import load_cfg as jload
    from uvltrack_tpu_torch.config import load_cfg

    path = "experiments/uvltrack/baseline_large.yaml"
    items = ["TEST.MODE=NLBBOX", "TRAIN.LR=2e-4", "MODEL.BACKBONE.FUSION_LAYER=[20,21]"]
    jc, tc = jload(path), load_cfg(path)
    jc.merge_from_list(items)
    tc.merge_from_list(items)
    jc.dump_yaml(str(tmp_path / "jax.yaml"))
    tc.dump_yaml(str(tmp_path / "port.yaml"))
    text = (tmp_path / "port.yaml").read_text()
    assert text == (tmp_path / "jax.yaml").read_text()
    assert load_cfg(str(tmp_path / "port.yaml")).to_dict() == tc.to_dict()


# ---------------------------------------------------------------- datasets
def _write(path, data=b"x"):
    path.parent.mkdir(parents=True, exist_ok=True)
    if isinstance(data, str):
        path.write_text(data)
    else:
        path.write_bytes(data)


def _boxes(rng, n):
    return np.round(rng.uniform(1, 60, size=(n, 4)), 1)


def _lasot_like(base, rng, with_nlp):
    for cls, idx in (("cat", 1), ("cat", 3), ("dog", 2)):
        d = base / cls / f"{cls}-{idx}"
        n = 4 + idx
        np.savetxt(_mk(d) / "groundtruth.txt", _boxes(rng, n), delimiter=",", fmt="%.1f")
        occ = (rng.random(n) < 0.3).astype(int)
        _write(d / "full_occlusion.txt", ",".join(map(str, occ)))
        _write(d / "out_of_view.txt", ",".join(map(str, (rng.random(n) < 0.2).astype(int))))
        if with_nlp and idx != 3:
            _write(d / "nlp.txt", f"the {cls} number {idx}\nsecond line\n")
        for i in range(1, n + 1):
            _write(d / "img" / f"{i:08d}.jpg")


def _mk(d):
    d.mkdir(parents=True, exist_ok=True)
    return d


def _lasot_lmdb(base, rng):
    import cv2

    from uvltrack_tpu.utils.lmdb_native import write_lmdb

    names = ["cat-1", "cat-3"]
    items = []
    for name in names:
        n = 5
        items.append((f"cat/{name}/groundtruth.txt",
                      "".join(f"{10 + i},{12 + i},30,40\n" for i in range(n))))
        items.append((f"cat/{name}/full_occlusion.txt", ",".join("0010"[i % 4] for i in range(n))))
        items.append((f"cat/{name}/out_of_view.txt", ",".join("0" * n)))
        for i in range(1, n + 1):
            ok, buf = cv2.imencode(".jpg", rng.integers(0, 255, (8, 10, 3)).astype(np.uint8))
            items.append((f"cat/{name}/img/{i:08d}.jpg", buf.tobytes()))
    write_lmdb(str(base), items)
    _write(base / "lasot_test_split.txt", "\n".join(names) + "\n")


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """{env var: root} of a synthetic layout of every benchmark the
    registries know, made from a numpy seed."""
    root = tmp_path_factory.mktemp("benchmarks")
    rng = np.random.default_rng(0)
    env = {}
    # otb99: OTB_videos/<seq>/{groundtruth_rect.txt,img/*}, OTB_query_<split>/<seq>.txt
    b = root / "otb99"
    for name, n, split in (("Biker", 3, "test"), ("Car", 4, "test"), ("Dog", 2, "train")):
        np.savetxt(_mk(b / "OTB_videos" / name) / "groundtruth_rect.txt", _boxes(rng, n),
                   delimiter=",", fmt="%.1f")
        for i in range(n):
            _write(b / "OTB_videos" / name / "img" / f"{i + 1:04d}.jpg")
        _write(b / f"OTB_query_{split}" / f"{name}.txt", f"a {name.lower()} moving\n")
    env["UVLTRACK_OTB99_PATH"] = b
    # tnl2k: <seq>/{groundtruth.txt,imgs/*,language.txt}
    b = root / "tnl2k"
    for name, n in (("advSamp_Baseball", 3), ("Cartoon_01", 2)):
        np.savetxt(_mk(b / name) / "groundtruth.txt", _boxes(rng, n), delimiter=",",
                   fmt="%.1f")
        _write(b / name / "language.txt", f"track {name}\n")
        for i in range(n):
            _write(b / name / "imgs" / f"{i:05d}.png")
    env["UVLTRACK_TNL2K_PATH"] = b
    _lasot_like(root / "lasot", rng, with_nlp=True)
    env["UVLTRACK_LASOT_PATH"] = root / "lasot"
    _lasot_like(root / "lasotext", rng, with_nlp=False)
    env["UVLTRACK_LASOTEXT_PATH"] = root / "lasotext"
    # got10k: <split>/list.txt + <split>/<seq>/{groundtruth.txt,*.jpg}
    b = root / "got10k"
    for split, names, rows in (("test", ["GOT-10k_Test_000001", "GOT-10k_Test_000002"], 1),
                               ("val", ["GOT-10k_Val_000001"], 3),
                               ("train", [f"GOT-10k_Train_{i:06d}" for i in (1, 2, 3)], 3)):
        _write(b / split / "list.txt", "\n".join(names) + "\n")
        for name in names:
            np.savetxt(_mk(b / split / name) / "groundtruth.txt", _boxes(rng, rows),
                       delimiter=",", fmt="%.4f")
            for i in (1, 2, 10):  # sorted by number, not by name
                _write(b / split / name / f"{i}.jpg")
    _write(b / "got10k_val_split.txt", "0\n2\n")
    env["UVLTRACK_GOT10K_PATH"] = b
    # trackingnet: TEST/anno/<seq>.txt + TEST/frames/<seq>/<i>.jpg
    b = root / "trackingnet"
    for name, n in (("zz_seq", 3), ("aa_seq", 12)):
        np.savetxt(_mk(b / "TEST" / "anno") / f"{name}.txt", _boxes(rng, n), delimiter=",",
                   fmt="%.2f")
        for i in range(n):
            _write(b / "TEST" / "frames" / name / f"{i}.jpg")
    env["UVLTRACK_TRACKINGNET_PATH"] = b
    _lasot_lmdb(root / "lasot_lmdb", rng)
    env["UVLTRACK_LASOT_LMDB_PATH"] = root / "lasot_lmdb"
    # otb (OTB100): <seq>/{groundtruth_rect.txt,img/*.jpg}, one frame more than rows
    b = root / "otb"
    np.savetxt(_mk(b / "Basketball") / "groundtruth_rect.txt", _boxes(rng, 3), delimiter=",",
               fmt="%.1f")
    for i in range(4):
        _write(b / "Basketball" / "img" / f"{i:04d}.jpg")
    _mk(b / "no_annotation")
    env["UVLTRACK_OTB_PATH"] = b
    # nfs: <seq>/30/<seq>.txt (xyxy in columns 1-4) + 30/<seq>/*.jpg
    b = root / "nfs"
    _write(b / "zebra" / "30" / "zebra.txt",
           "\n".join(f"{i} {10 + i} 20 {40 + i} 60 x x x x" for i in range(3)))
    for i in range(2):
        _write(b / "zebra" / "30" / "zebra" / f"{i:05d}.jpg")
    env["UVLTRACK_NFS_PATH"] = b
    # uav (table-driven): anno/UAV123/<seq>.txt with an absent-object NaN row
    b = root / "uav"
    _write(b / "anno" / "UAV123" / "bike1.txt", "10,20,30,40\nNaN,NaN,NaN,NaN\n11,21,31,41\n")
    _write(b / "anno" / "UAV123" / "bird1_2.txt", "1,2,3,4\n5,6,7,8\n")
    env["UVLTRACK_UAV_PATH"] = b
    # tc128: <seq>/{<seq>_gt.txt,img/*.jpg}
    b = root / "tc128"
    for name in ("Ball_ce", "Bike"):
        np.savetxt(_mk(b / name) / f"{name}_gt.txt", _boxes(rng, 2), delimiter=",",
                   fmt="%.1f")
        for i in range(3):
            _write(b / name / "img" / f"{i:04d}.jpg")
    env["UVLTRACK_TC128_PATH"] = b
    # itb: <scenario>/<seq>/{groundtruth.txt,*.jpg}
    b = root / "itb"
    np.savetxt(_mk(b / "scenario1" / "seq1") / "groundtruth.txt", _boxes(rng, 2),
               delimiter=",", fmt="%.1f")
    for i in range(2):
        _write(b / "scenario1" / "seq1" / f"{i:04d}.jpg")
    env["UVLTRACK_ITB_PATH"] = b
    # avist: anno/<seq>.txt + sequences/<seq>/*.jpg
    b = root / "avist"
    np.savetxt(_mk(b / "anno") / "fog1.txt", _boxes(rng, 3), delimiter=",", fmt="%.1f")
    for i in range(2):
        _write(b / "sequences" / "fog1" / f"{i:04d}.jpg")
    env["UVLTRACK_AVIST_PATH"] = b
    return {k: str(v) for k, v in env.items()}


@pytest.fixture
def bench_env(layouts, monkeypatch):
    for k, v in layouts.items():
        monkeypatch.setenv(k, v)
    jenv.reset_env_cache()
    tenv.reset_env_cache()
    yield
    jenv.reset_env_cache()
    tenv.reset_env_cache()


def _assert_same_sequences(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.name, g.dataset, g.language, g.object_class) == \
            (w.name, w.dataset, w.language, w.object_class)
        assert [tuple(f) if isinstance(f, (tuple, list)) else f for f in g.frames] == \
            [tuple(f) if isinstance(f, (tuple, list)) else f for f in w.frames]
        np.testing.assert_array_equal(g.ground_truth_rect, w.ground_truth_rect)
        assert (g.target_visible is None) == (w.target_visible is None)
        if w.target_visible is not None:
            np.testing.assert_array_equal(g.target_visible, w.target_visible)


def _port_registry():
    from uvltrack_tpu_torch.eval import DATASET_BUILDERS

    return DATASET_BUILDERS


def test_registries_hold_the_same_datasets():
    from uvltrack_tpu.eval import DATASET_BUILDERS as JB

    assert sorted(_port_registry()) == sorted(JB)
    assert len(JB) == 17


@pytest.mark.parametrize("name", sorted(_port_registry()))
def test_dataset_adapter_matches_jax(name, bench_env, monkeypatch):
    """The port's adapter reads the same sequences as the JAX package's:
    names, frames, ground truth (NaN rows included), language, object class
    and target_visible. lasot_lmdb reads through the port's
    utils/lmdb_utils.py, its environment handle served by the JAX
    package's self-contained reader where the lmdb binding is absent."""
    from uvltrack_tpu.eval import get_dataset as jget
    from uvltrack_tpu_torch.eval import get_dataset
    from uvltrack_tpu_torch.utils import lmdb_utils

    if name == "lasot_lmdb":
        try:
            import lmdb  # noqa: F401
        except ImportError:
            from uvltrack_tpu.utils.lmdb_native import Reader

            path = os.environ["UVLTRACK_LASOT_LMDB_PATH"]
            monkeypatch.setitem(lmdb_utils._ENVS, path, Reader(path))
    _assert_same_sequences(get_dataset(name), jget(name))


def test_get_dataset_concatenates_and_names_the_unknown(bench_env):
    from uvltrack_tpu.eval import get_dataset as jget
    from uvltrack_tpu_torch.eval import get_dataset

    _assert_same_sequences(get_dataset("otb99", "tnl2k"), jget("otb99", "tnl2k"))
    with pytest.raises(KeyError, match="unknown dataset 'nope'"):
        get_dataset("nope")


def test_load_text_sniffs_the_delimiter(tmp_path):
    from uvltrack_tpu.eval.datasets import load_text as jload
    from uvltrack_tpu_torch.eval.datasets import load_text

    rows = np.random.default_rng(1).integers(0, 99, (4, 4))
    for i, d in enumerate((",", "\t", " ")):
        p = str(tmp_path / f"r{i}.txt")
        np.savetxt(p, rows, delimiter=d, fmt="%d")
        np.testing.assert_array_equal(load_text(p), jload(p))
    bad = tmp_path / "bad.txt"
    bad.write_text("a;b\n")
    for fn in (load_text, jload):
        with pytest.raises(IOError):
            fn(str(bad))


# ----------------------------------------------------------------- metrics
def _box_pair(seed, n=40, nan_rows=(), zero_rows=()):
    """(pred, anno): seeded boxes, the prediction near the annotation, with
    zero-size prediction rows and NaN annotation rows where asked."""
    rng = np.random.default_rng(seed)
    anno = np.column_stack([rng.uniform(0, 200, (n, 2)), rng.uniform(5, 80, (n, 2))])
    pred = anno + rng.normal(0, 6, (n, 4))
    pred[:, 2:] = np.abs(pred[:, 2:])
    anno[3, 2] = 0.0  # an invalid (zero-width) annotation row
    for i in zero_rows:
        pred[i, 2:] = 0.0
    for i in nan_rows:
        anno[i] = np.nan
    return np.round(pred, 2), anno


def _both(fn_name, *args, **kw):
    from uvltrack_tpu.eval import metrics as JM
    from uvltrack_tpu_torch.eval import metrics as M

    out = []
    for mod in (M, JM):
        try:
            out.append(getattr(mod, fn_name)(*args, **kw))
        except Exception as e:  # noqa: BLE001 -- the type is what is compared
            out.append(type(e))
    return out


def _assert_equal_tree(a, b):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b)
        for k in b:
            _assert_equal_tree(a[k], b[k])
    elif isinstance(b, (tuple, list)) and not isinstance(b, str):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal_tree(x, y)
    elif isinstance(b, type):
        assert a is b
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


METRIC_CASES = {
    "otb99": dict(dataset="otb99", zero_rows=(5, 6)),
    "uav_nan": dict(dataset="uav", nan_rows=(7, 8), zero_rows=(7, 9)),
    "itb_nan": dict(dataset="itb", nan_rows=(2,)),
    "otb99_nan_raises": dict(dataset="otb99", nan_rows=(2,)),
    "lasot_visible": dict(dataset="lasot", visible=True),
    "lasot_short_raises": dict(dataset="lasot", short=5),
    "tnl2k_short_padded": dict(dataset="tnl2k", short=5),
    "got10k_long_cut": dict(dataset="got10k", long=4),
}


@pytest.mark.parametrize("case", sorted(METRIC_CASES))
def test_metrics_match_jax_exactly(case):
    spec = METRIC_CASES[case]
    pred, anno = _box_pair(sorted(METRIC_CASES).index(case), nan_rows=spec.get("nan_rows", ()),
                           zero_rows=spec.get("zero_rows", ()))
    if spec.get("short"):
        pred = pred[:-spec["short"]]
    if spec.get("long"):
        pred = np.concatenate([pred, pred[:spec["long"]]])
    visible = None
    if spec.get("visible"):
        visible = np.random.default_rng(9).random(len(anno)) > 0.2
    ds = spec["dataset"]
    for normalized in (False, True):
        n = min(len(pred), len(anno))
        got, want = _both("calc_err_center", pred[:n], anno[:n], normalized=normalized)
        _assert_equal_tree(got, want)
    got, want = _both("calc_iou_overlap", pred[:len(anno)], anno[:len(pred)])
    _assert_equal_tree(got, want)
    got, want = _both("calc_seq_err_robust", pred, anno, ds, visible)
    _assert_equal_tree(got, want)
    for excl in (False, True):
        got, want = _both("sequence_curves", pred, anno, ds, visible,
                          exclude_invalid_frames=excl)
        _assert_equal_tree(got, want)
        if not isinstance(want, type):
            got, want = _both("aggregate_scores", [got, got])
            _assert_equal_tree(got, want)


def test_negative_or_nan_predictions_raise_in_both():
    pred, anno = _box_pair(3)
    pred[4, 3] = -1.0
    got, want = _both("calc_seq_err_robust", pred, anno, "otb99")
    assert got is want is ValueError
    pred[4, 3] = np.nan
    got, want = _both("calc_seq_err_robust", pred, anno, "otb99")
    assert got is want is ValueError


def _scored_dataset(tmp_path, n_seq=3, runs=(0,)):
    """A SequenceList with seeded ground truth (NaN and zero-size rows for
    'uav') and, per run, a results dir of tab-separated integer boxes."""
    from uvltrack_tpu_torch.eval import Sequence, SequenceList

    seqs, dirs = [], {}
    for k in range(n_seq):
        pred, anno = _box_pair(20 + k, n=12 + 3 * k, nan_rows=(4,) if k == 1 else (),
                               zero_rows=(6,))
        seqs.append(Sequence(f"seq{k}", [f"f{i}.jpg" for i in range(len(anno))],
                             "uav" if k == 1 else "otb99", anno))
    rng = np.random.default_rng(5)
    for r in runs:
        d = tmp_path / f"run{r:03d}"
        d.mkdir()
        for s in seqs:
            boxes = np.nan_to_num(s.ground_truth_rect, nan=10.0) + rng.normal(0, 4 + r, (len(s.frames), 4))
            boxes[:, 2:] = np.abs(boxes[:, 2:]) + 1
            np.savetxt(d / f"{s.name}.txt", np.round(boxes).astype(int), delimiter="\t", fmt="%d")
        dirs[r] = str(d)
    # a sequence missing from the first run: scored as missing, or skipped
    (tmp_path / f"run{runs[0]:03d}" / "seq2.txt").unlink()
    return SequenceList(seqs), dirs


def _run_both(fn_name, *args, **kw):
    """(port result, port stdout), (JAX result, JAX stdout)."""
    from uvltrack_tpu.eval import metrics as JM
    from uvltrack_tpu_torch.eval import metrics as M

    out = []
    for mod in (M, JM):
        buf = io.StringIO()
        with redirect_stdout(buf):
            res = getattr(mod, fn_name)(*args, **kw)
        out.append((res, buf.getvalue()))
    return out


def test_evaluate_results_dir_report_matches_jax(tmp_path):
    ds, dirs = _scored_dataset(tmp_path)
    (got, gtext), (want, wtext) = _run_both("evaluate_results_dir", dirs[0], ds)
    assert got == want and gtext == wtext and "n_missing=1" in gtext
    got, want = _both("evaluate_results_dir", str(tmp_path), ds)
    assert got is want is FileNotFoundError


def test_extract_merge_scores_and_report_match_jax(tmp_path):
    """extract_results, the eval_data.pkl cache (a second call loads it, a
    changed tracker list recomputes), merge_multiple_runs, eval_data_scores
    and generate_formatted_report."""
    ds, dirs = _scored_dataset(tmp_path, runs=(0, 1, 2))
    trackers = [{"name": "uvltrack", "param": "baseline_base", "run_id": r,
                 "results_dir": d} for r, d in dirs.items()]
    got, want = _both("extract_results", trackers, ds, skip_missing_seq=True)
    _assert_equal_tree(got, want)
    assert got["valid_sequence"] == [1, 1, 0]
    got, want = _both("extract_results", trackers, ds)
    assert got is want is FileNotFoundError
    for sub in ("port", "jax"):
        os.makedirs(tmp_path / sub)
    from uvltrack_tpu.eval import metrics as JM
    from uvltrack_tpu_torch.eval import metrics as M

    for _ in range(2):  # the second call reads the cache
        got = M.check_and_load_precomputed_results(trackers, ds, str(tmp_path / "port"),
                                                   skip_missing_seq=True)
        want = JM.check_and_load_precomputed_results(trackers, ds, str(tmp_path / "jax"),
                                                     skip_missing_seq=True)
        _assert_equal_tree(got, want)
    assert (tmp_path / "port" / "eval_data.pkl").read_bytes() == \
        (tmp_path / "jax" / "eval_data.pkl").read_bytes()
    got = M.check_and_load_precomputed_results(trackers[:2], ds, str(tmp_path / "port"),
                                               skip_missing_seq=True)
    assert len(got["trackers"]) == 2
    merged, jmerged = _both("merge_multiple_runs", want)
    _assert_equal_tree(merged, jmerged)
    assert len(merged["trackers"]) == 1
    for data in (want, merged):
        got_s, want_s = _both("eval_data_scores", data)
        _assert_equal_tree(got_s, want_s)
        labels = [f"run{i}" for i in range(len(data["trackers"]))]
        got_r, want_r = _both("generate_formatted_report", labels, want_s, table_name="otb99")
        assert got_r == want_r and "AUC" in got_r


@pytest.mark.parametrize("criteria", [None, {"mode": "ao_min", "threshold": 60.0},
                                      {"mode": "ao_max", "threshold": 70.0},
                                      {"mode": "delta_ao", "threshold": 1.0},
                                      {"mode": "nope", "threshold": 1.0}],
                         ids=["all", "ao_min", "ao_max", "delta_ao", "unknown"])
def test_per_sequence_results_match_jax(tmp_path, criteria):
    ds, dirs = _scored_dataset(tmp_path, runs=(0, 1))
    rdirs = {"a": dirs[0], "b": dirs[1]}
    if criteria and criteria["mode"] == "nope":
        got, want = _both("per_sequence_results", rdirs, ds, criteria, report=False)
        assert got is want is ValueError
        return
    (got, gtext), (want, wtext) = _run_both("per_sequence_results", rdirs, ds, criteria)
    assert got == want and gtext == wtext


# --------------------------------------------------------------- packagers
def _results_dir(tmp_path, with_times=True):
    rng = np.random.default_rng(6)
    d = tmp_path / "results"
    d.mkdir()
    for name, n in (("seqA", 5), ("seqB", 3)):
        np.savetxt(d / f"{name}.txt", rng.integers(0, 99, (n, 4)), delimiter="\t", fmt="%d")
        if with_times:
            np.savetxt(d / f"{name}_time.txt", rng.uniform(0, 0.1, n), fmt="%.8f")
    np.savetxt(d / "seqC.txt", rng.integers(0, 99, (2, 4)), delimiter=",", fmt="%d")
    return str(d)


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


@pytest.mark.parametrize("which", ["transform_got10k", "transform_trackingnet"])
def test_packagers_match_jax_byte_for_byte(tmp_path, which):
    from uvltrack_tpu.eval import packagers as JP
    from uvltrack_tpu_torch.eval import packagers as P

    rdir = _results_dir(tmp_path)
    got = getattr(P, which)(rdir, str(tmp_path / "port"), zip_name="sub")
    want = getattr(JP, which)(rdir, str(tmp_path / "jax"), zip_name="sub")
    assert os.path.basename(got) == os.path.basename(want) == "sub.zip"
    members = _members(got)
    assert members == _members(want)
    n_files = 3 if which == "transform_trackingnet" else 5  # + 2 time files
    assert len([m for m in members if not m.endswith("/")]) == n_files


# ------------------------------------------------------------------- plots
def test_plots_write_the_jax_files(tmp_path):
    """plot_results_dirs and plot_got_success write the files the JAX
    package writes (matplotlib, where it imports)."""
    pytest.importorskip("matplotlib")
    import json

    from uvltrack_tpu.eval import plots as JPL
    from uvltrack_tpu_torch.eval import plots as PL

    ds, dirs = _scored_dataset(tmp_path, runs=(0, 1))
    rdirs = {"a": dirs[0], "b": dirs[1]}
    got = PL.plot_results_dirs(rdirs, ds, str(tmp_path / "port"))
    want = JPL.plot_results_dirs(rdirs, ds, str(tmp_path / "jax"))
    assert [os.path.relpath(p, tmp_path / "port") for p in got] == \
        [os.path.relpath(p, tmp_path / "jax") for p in want]
    assert all(os.path.getsize(p) > 0 for p in got)
    rep = tmp_path / "got.json"
    rep.write_text(json.dumps({"t": {"ao": 0.5, "succ_curve": list(np.linspace(1, 0, 101))}}))
    got = PL.plot_got_success({"t": str(rep)}, str(tmp_path / "port"))
    want = JPL.plot_got_success({"t": str(rep)}, str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]


def test_plots_import_without_matplotlib(monkeypatch):
    """eval/plots.py imports matplotlib only where it draws."""
    import importlib
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.delitem(sys.modules, "uvltrack_tpu_torch.eval.plots", raising=False)
    mod = importlib.import_module("uvltrack_tpu_torch.eval.plots")
    with pytest.raises(ImportError):
        mod.plot_curves({}, "/nonexistent")


# ---------------------------------------------------------- step_many_cost
def test_step_many_cost_counts_s_frames_from_the_shapes():
    """frame_cost x S, the weights read once for the batch, S frames' bytes,
    "streams" = S; the keys of the JAX BatchTracker.step_many_cost."""
    from test_torch_port_batch import _cfg
    from test_torch_port_model import make_pair
    from uvltrack_tpu.track.batch import BatchTracker as JBatchTracker
    from uvltrack_tpu_torch.config import CfgNode
    from uvltrack_tpu_torch.track.batch import BatchTracker
    from uvltrack_tpu_torch.track.tracker import frame_cost

    jm, v, tm = make_pair(seed=4)
    frames = np.zeros((2, 3, 64, 96, 3), np.uint8)
    jbt = JBatchTracker(_cfg(), jm, v, 3)
    jbt.initialize(list(frames[0]), np.tile([[10.0, 12.0, 20.0, 18.0]], (3, 1)))
    want = jbt.step_many_cost(frames)
    bt = BatchTracker(CfgNode(_cfg().to_dict()), tm, 3)
    got = bt.step_many_cost(frames)
    assert sorted(got) == sorted(want) == ["bytes", "flops", "streams"]
    fc = frame_cost(bt.model, bt.nt)
    assert want["streams"] == 3
    assert got == {"flops": 3 * fc["flops"], "bytes": fc["weight_bytes"] + 3 * 64 * 96 * 3,
                   "streams": 3}
    assert bt.step_many_cost([list(frames[0])] * 2) == got


# --------------------------------------------------------------- UVLTrack-L
L_STAND_IN = dict(embed_dim=32, depth=24, num_heads=4)


@pytest.fixture(scope="module")
def large_pair():
    """UVLTrack-L from experiments/uvltrack/baseline_large.yaml through both
    packages' build_model, at a stand-in width: the ViT-L variant at C=32
    with its 24 blocks (fusion at 12-23) and 4 heads, a 2-layer BERT
    stand-in, 32/64 px crops and a 32-channel head; fp32. The JAX variables
    perturbed from a numpy seed reach the port through from_jax_variables."""
    import jax

    from test_torch_port_model import _np_tree, _perturb
    from uvltrack_tpu.config import load_cfg as jload
    from uvltrack_tpu.models import bert as jbert
    from uvltrack_tpu.models import uvltrack as juv
    from uvltrack_tpu.models.vit import VIT_VARIANTS as JV
    from uvltrack_tpu_torch.config import load_cfg
    from uvltrack_tpu_torch.models import bert as tbert
    from uvltrack_tpu_torch.models import uvltrack as tuv
    from uvltrack_tpu_torch.models.convert import from_jax_variables, load_reference_state
    from uvltrack_tpu_torch.models.vit import VIT_VARIANTS as TV

    mp = pytest.MonkeyPatch()
    for variants in (JV, TV):
        mp.setitem(variants, "large", L_STAND_IN)
    bert = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                intermediate_size=64, max_position=64)
    mp.setattr(juv, "bert_config_from_type", lambda t: jbert.BertConfig(**bert))
    mp.setattr(tuv, "bert_config_from_type", lambda t: tbert.BertConfig(**bert))
    path = "experiments/uvltrack/baseline_large.yaml"
    items = ["DATA.TEMPLATE.SIZE=32", "DATA.SEARCH.SIZE=64", "MODEL.HIDDEN_DIM=32",
             "MODEL.HEAD.HEAD_DIM=32", "TPU.COMPUTE_DTYPE=float32"]
    jcfg, cfg = jload(path), load_cfg(path)
    jcfg.merge_from_list(items)
    cfg.merge_from_list(items)
    try:
        jm = juv.build_model(jcfg)
        v = _perturb(_np_tree(juv.init_model(jm, jcfg, jax.random.PRNGKey(0))),
                     np.random.default_rng(12))
        tm = tuv.build_model(cfg, device="cpu", seed=1).eval()
    finally:
        mp.undo()
    state = from_jax_variables(v["params"], v["batch_stats"])
    assert load_reference_state(tm, state) == []
    return jm, v, tm, state


def test_uvltrack_l_builds_24_blocks_and_the_reference_keys(large_pair):
    from uvltrack_tpu.models.convert import export_uvltrack

    jm, v, tm, state = large_pair
    bb = tm.backbone
    assert bb.depth == 24 and len(bb.vit.blocks) == 24 and bb.embed_dim == 32
    assert tuple(bb.fusion_layers) == tuple(range(12, 24))
    ref = export_uvltrack(v["params"], v["batch_stats"])
    assert sorted(state) == sorted(ref) == sorted(tm.state_dict())
    for k in ref:
        np.testing.assert_array_equal(state[k].numpy(), np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("flag_val", [0, 2])
def test_uvltrack_l_forward_matches_jax(large_pair, flag_val):
    """forward_test (BERT, the 12 visual and 12 joint blocks, the head) and
    the prompt init at L's depth, fp32, within 1e-4."""
    import jax.numpy as jnp

    from test_model import NT
    from test_torch_port_model import _close, _t, japply
    from uvltrack_tpu.models.uvltrack import UVLTrack as JUVLTrack

    jm, v, tm, _ = large_pair
    rng = np.random.default_rng(30 + flag_val)
    b = 2
    tz = rng.normal(size=(b, 32, 32, 3)).astype(np.float32)
    sx = rng.normal(size=(b, 64, 64, 3)).astype(np.float32)
    ids = rng.integers(1, 60, size=(b, NT)).astype(np.int32)
    mask = np.ones((b, NT), np.int32)
    mask[:, 5:] = 0
    flag = np.full((b,), flag_val, np.int32)
    prompt = rng.normal(size=(b, 3, 32)).astype(np.float32)
    tmask = rng.random((b, 4)) > 0.5
    cmask = rng.random((b, 16)) > 0.5
    args = [jnp.asarray(a) for a in (tz, sx, ids, mask, prompt, flag)]
    ref = japply(jm, v, *args, method=JUVLTrack.forward_test)
    with torch.no_grad():
        out = tm.forward_test(*(_t(a) for a in (tz, sx, ids, mask, prompt, flag)))
        out_p = tm.forward_prompt_init(*(_t(a) for a in (tz, sx, ids, mask, tmask, cmask,
                                                         flag)))
    for key in ("cls_score_test", "bbox_map", "cont_score", "pred_boxes"):
        _close(out[key], ref[key])
    ref_p = japply(jm, v, *(jnp.asarray(a) for a in (tz, sx, ids, mask, tmask, cmask, flag)),
                   method=JUVLTrack.forward_prompt_init)
    _close(out_p, ref_p)
