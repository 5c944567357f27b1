"""The port's data path (uvltrack_tpu_torch/{utils/lmdb_*, data/, cli/prewarm})
against the JAX package's on the same inputs.

Both sides run the same numpy and cv2 code on the same inputs, so every
comparison is exact: the same arrays (dtype, shape, values; NaN where NaN),
the same sequence lists, infos, frames, languages and sample dicts. The
inputs are made from numpy seeds; the dataset trees are
uvltrack_tpu_torch/tools/data_fixtures.py's at 72x96 px (the layouts of
tests/test_train_datasets.py and tests/test_lmdb.py), plus the layouts those
files write for the adapters the trees leave out. The sampler and the loader
are held at one worker: the JAX package's thread workers spawn a stream per
thread in the order the threads first draw, so only one worker, or process
workers per worker id, are reproducible.
"""

import io
import json
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

REPO = Path(__file__).resolve().parent.parent
FRAME_HW, IMAGE_HW = (72, 96), (60, 80)


def same(a, b, where="root"):
    """Exact equality of nested dicts / lists / tuples / arrays / scalars."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (where, sorted(a), sorted(b))
        for k in a:
            same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype, a.shape,
                                                           b.shape)
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, float) and isinstance(b, float) and np.isnan(a):
        assert np.isnan(b), where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _jpg(rng, h=30, w=36):
    ok, buf = cv2.imencode(".jpg", rng.integers(0, 255, size=(h, w, 3)).astype(np.uint8))
    assert ok
    return buf.tobytes()


def _reset_envs():
    from uvltrack_tpu.eval.environment import reset_env_cache as jreset
    from uvltrack_tpu_torch.eval.environment import reset_env_cache

    jreset()
    reset_env_cache()


def _write_extra(root: Path) -> dict:
    """The layouts the trees leave out (test_train_datasets.py,
    test_lmdb.py): Objects365, Visual Genome, WebUAV, ImageNet-VID on disk,
    and LaSOT, TrackingNet, ImageNet-VID and COCO packed as LMDB; plus
    GOT-10k's votval split table."""
    from uvltrack_tpu_torch.utils.lmdb_native import write_lmdb

    rng = np.random.default_rng(11)
    env = {}
    o = root / "object365"
    (o / "imgs").mkdir(parents=True)
    (o / "zhiyuan_objv2_train.json").write_text(json.dumps({
        "categories": [{"id": 3, "name": "Bicycle"}],
        "annotations": [{"id": 1, "image_id": 7, "category_id": 3, "bbox": [5, 6, 20, 14]},
                        {"id": 2, "image_id": 9, "category_id": 3, "bbox": [1, 2, 10, 10]}]}))
    (o / "imgs" / "objects365_v1_00000007.jpg").write_bytes(_jpg(rng))
    (o / "imgs" / "objects365_v2_00000009.jpg").write_bytes(_jpg(rng))
    env["UVLTRACK_OBJECT365_PATH"] = str(o)
    v = root / "vg"
    (v / "VG_100K").mkdir(parents=True)
    (v / "region_descriptions_new.json").write_text(json.dumps(
        [{"image_id": 11, "x": 4, "y": 8, "width": 16, "height": 12,
          "phrase": "A man on the LEFT"}]))
    (v / "VG_100K" / "11.jpg").write_bytes(_jpg(rng))
    env["UVLTRACK_VISUALGENOME_PATH"] = str(v)
    w = root / "webuav"
    seq = w / "train" / "Train" / "uav001"
    (seq / "img").mkdir(parents=True)
    (seq / "groundtruth_rect.txt").write_text("10,12,8,9\n11,13,8,9\n0,0,0,0\n12,14,8,9\n")
    (seq / "absent.txt").write_text("0,1,0,0")
    for i in range(4):
        (seq / "img" / f"{i:06d}.jpg").write_bytes(_jpg(rng))
    lang = w / "language" / "Language" / "Train" / "uav001"
    lang.mkdir(parents=True)
    (lang / "language.txt").write_text("A Drone Flying Low\n")
    env["UVLTRACK_WEBUAV_PATH"] = str(w)
    vid = root / "vid"
    ann = vid / "Annotations" / "VID" / "train" / "ILSVRC2015_VID_train_0000" / \
        "ILSVRC2015_train_00000001"
    data = vid / "Data" / "VID" / "train" / "ILSVRC2015_VID_train_0000" / \
        "ILSVRC2015_train_00000001"
    ann.mkdir(parents=True)
    data.mkdir(parents=True)
    for f in range(8):
        (ann / f"{f:06d}.xml").write_text(
            "<annotation><size><width>36</width><height>30</height></size><object>"
            f"<trackid>0</trackid><name>dog</name><bndbox><xmin>{2 + f}</xmin><ymin>3</ymin>"
            f"<xmax>{12 + f}</xmax><ymax>14</ymax></bndbox><occluded>0</occluded></object>"
            "</annotation>")
        (data / f"{f:06d}.JPEG").write_bytes(_jpg(rng))
    env["UVLTRACK_IMAGENET_PATH"] = str(vid)
    # LMDB packs
    items = []
    for name in ("cat-1", "cat-3"):
        items.append((f"cat/{name}/groundtruth.txt",
                      "".join(f"{10 + i},{12 + i},9,8\n" for i in range(8))))
        items.append((f"cat/{name}/full_occlusion.txt", ",".join("0" * 8)))
        items.append((f"cat/{name}/out_of_view.txt", ",".join("0" * 8)))
        items += [(f"cat/{name}/img/{i:08d}.jpg", _jpg(rng)) for i in range(1, 9)]
    write_lmdb(str(root / "lasot_lmdb"), items)
    (root / "lasot_lmdb" / "lasot_train_split.txt").write_text("cat-1\ncat-3\n")
    env["UVLTRACK_LASOT_LMDB_PATH"] = str(root / "lasot_lmdb")
    tn = root / "trackingnet_lmdb"
    tn.mkdir()
    write_lmdb(str(tn / "TRAIN_0_lmdb"),
               [("anno/vid_a.txt", "".join(f"{i},{i},10,12\n" for i in range(8)))]
               + [(f"frames/vid_a/{i}.jpg", _jpg(rng)) for i in range(8)])
    (tn / "seq_list.json").write_text('[[0, "vid_a"]]')
    env["UVLTRACK_TRACKINGNET_LMDB_PATH"] = str(tn)
    seqs = [{"set_id": 1, "vid_id": 7, "class_name": "dog", "start_frame": 2,
             "anno": [[3, 4, 11, 13]] * 8, "target_visible": [True] * 8,
             "image_size": [36, 30]}]
    write_lmdb(str(root / "vid_lmdb"), [("cache.json", json.dumps(seqs))] + [
        (f"Data/VID/train/ILSVRC2015_VID_train_0001/ILSVRC2015_train_00000007/{i:06d}.JPEG",
         _jpg(rng)) for i in range(2, 10)])
    env["UVLTRACK_IMAGENET_LMDB_PATH"] = str(root / "vid_lmdb")
    coco = {"images": [{"id": 1, "file_name": "img1.jpg"}],
            "categories": [{"id": 9, "name": "cat"}],
            "annotations": [{"id": 5, "image_id": 1, "category_id": 9,
                             "bbox": [2, 3, 8, 9], "iscrowd": 0}]}
    write_lmdb(str(root / "coco_lmdb"), [
        ("annotations/instances_train2017.json", json.dumps(coco)),
        ("images/train2017/img1.jpg", _jpg(rng))])
    env["UVLTRACK_COCO_LMDB_PATH"] = str(root / "coco_lmdb")
    return env


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The fixture trees (and the extra layouts), with both packages'
    environment pointed at them."""
    from uvltrack_tpu_torch.tools.data_fixtures import vocab_words, write_trees

    root = tmp_path_factory.mktemp("trees")
    env = write_trees(root, seed=0, frame_hw=FRAME_HW, image_hw=IMAGE_HW, n_seq=3,
                      n_frames=12)
    (root / "got10k" / "got10k_vot_val_split.txt").write_text("2\n")
    (root / "got10k_lmdb" / "got10k_vot_val_split.txt").write_text("2\n")
    env.update(_write_extra(root))
    vocab = root / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + vocab_words()) + "\n")
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        _reset_envs()
        yield {"root": root, "env": env, "vocab": str(vocab)}
    _reset_envs()


# ------------------------------------------------------------------ LMDB
def test_port_lmdb_utils_reads_its_own_writer_without_the_binding(tmp_path, monkeypatch):
    """The port reads an LMDB environment where the lmdb wheel is absent: its
    own write_lmdb's output through lmdb_utils' str / json / image decoders
    (the binding's import made to fail; the backend order is the JAX
    package's: the binding if installed, else utils/lmdb_native.py)."""
    from uvltrack_tpu_torch.utils import lmdb_utils
    from uvltrack_tpu_torch.utils.lmdb_native import write_lmdb

    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, size=(20, 24, 3)).astype(np.uint8)
    ok, buf = cv2.imencode(".png", img)
    env = str(tmp_path / "env")
    write_lmdb(env, [("s", "a string"), ("j", json.dumps({"k": [1, 2]})),
                     ("i.png", buf.tobytes())])
    monkeypatch.setitem(sys.modules, "lmdb", None)
    monkeypatch.setattr(lmdb_utils, "HAS_LMDB", False, raising=False)
    monkeypatch.setattr(lmdb_utils, "_ENVS", {})
    assert lmdb_utils.decode_str(env, "s") == "a string"
    assert lmdb_utils.decode_json(env, "j") == {"k": [1, 2]}
    np.testing.assert_array_equal(lmdb_utils.decode_img(env, "i.png"), img[:, :, ::-1])
    with pytest.raises(KeyError, match="nope"):
        lmdb_utils.read_bytes(env, "nope")


def _lmdb_items(seed):
    rng = np.random.default_rng(seed)
    items = {f"k/{i:05d}": bytes(rng.integers(0, 256, rng.integers(1, 80), dtype=np.uint8))
             for i in range(1500)}
    for i in range(8):  # overflow pages
        items[f"big/{i:03d}"] = bytes(rng.integers(0, 256, rng.integers(3000, 30000),
                                                   dtype=np.uint8))
    return items


def test_lmdb_writers_write_the_same_bytes_and_read_each_other(tmp_path):
    from uvltrack_tpu.utils import lmdb_native as jl
    from uvltrack_tpu_torch.utils import lmdb_native as tl

    items = _lmdb_items(1)
    jl.write_lmdb(str(tmp_path / "j"), items.items())
    tl.write_lmdb(str(tmp_path / "t"), items.items())
    assert (tmp_path / "j" / "data.mdb").read_bytes() == (tmp_path / "t" / "data.mdb").read_bytes()
    for reader, path in ((tl.Reader, "j"), (jl.Reader, "t")):
        r = reader(str(tmp_path / path))
        assert r.entries == len(items) and r.depth >= 2
        assert all(r.get(k) == v for k, v in items.items())
        assert list(r.keys()) == sorted(k.encode() for k in items)
        r.close()


@pytest.mark.parametrize("case", ["empty", "duplicate", "bad_magic"])
def test_port_lmdb_native_edges_match_jax(tmp_path, case):
    from uvltrack_tpu.utils import lmdb_native as jl
    from uvltrack_tpu_torch.utils import lmdb_native as tl

    for mod, d in ((jl, tmp_path / "j"), (tl, tmp_path / "t")):
        if case == "empty":
            mod.write_lmdb(str(d), [])
            r = mod.Reader(str(d))
            assert r.get("x") is None and list(r.keys()) == []
        elif case == "duplicate":
            with pytest.raises(ValueError, match="duplicate key"):
                mod.write_lmdb(str(d), [("k", b"1"), ("k", b"2")])
        else:
            d.mkdir()
            (d / "data.mdb").write_bytes(b"\x00" * 8192)
            with pytest.raises(ValueError, match="magic"):
                mod.Reader(str(d))


# ----------------------------------------------------------- data_specs
def test_data_specs_resolve_to_the_repo_not_into_the_package():
    from uvltrack_tpu.data.datasets import video_datasets as jv
    from uvltrack_tpu_torch.data.datasets import lmdb_datasets as tlm
    from uvltrack_tpu_torch.data.datasets import video_datasets as tv

    specs = tv._repo_data_specs()
    assert Path(specs) == REPO / "data_specs" == Path(jv._repo_data_specs())
    assert "uvltrack_tpu" not in Path(specs).relative_to(REPO).parts
    got = Path(tlm._specs_file(str(REPO / "nowhere"), "lasot_train_split.txt"))
    assert got == REPO / "data_specs" / "lasot_train_split.txt"


def test_bundled_split_tables_load_in_the_port(tmp_path):
    from uvltrack_tpu_torch.data.datasets.video_datasets import Got10k, Lasot

    n = 9335
    (tmp_path / "train").mkdir()
    (tmp_path / "train" / "list.txt").write_text(
        "\n".join(f"GOT-10k_Train_{i:06d}" for i in range(1, n + 1)) + "\n")
    assert Got10k(str(tmp_path), split="vottrain").get_num_sequences() == 7086
    assert Got10k(str(tmp_path), split="votval").get_num_sequences() == 1249
    assert Lasot(str(tmp_path), split="train").get_num_sequences() == 1120
    assert Lasot(str(tmp_path), split="test").get_num_sequences() == 280


# -------------------------------------------------------------- transforms
def _images(seed, n=3, h=40, w=52):
    rng = np.random.default_rng(seed)
    return ([rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8) for _ in range(n)],
            [rng.uniform(0.1, 0.5, 4) for _ in range(n)],
            [rng.random((h, w)) > 0.5 for _ in range(n)])


@pytest.mark.parametrize("which", ["default", "eval", "gray_flip"])
@pytest.mark.parametrize("seed", [0, 3])
def test_transforms_equal_jax(which, seed):
    from uvltrack_tpu.data import transforms as jt
    from uvltrack_tpu_torch.data import transforms as tt

    def build(m):
        if which == "default":
            return m.default_transform()
        if which == "eval":
            return m.eval_transform()
        return m.default_transform(grayscale_prob=1.0, flip_prob=1.0)

    ims, boxes, atts = _images(seed)
    out_j = build(jt)(ims, boxes, atts, rng=np.random.default_rng(seed))
    out_t = build(tt)(ims, boxes, atts, rng=np.random.default_rng(seed))
    same(out_t, out_j)
    same(tt.IMAGENET_MEAN, jt.IMAGENET_MEAN)
    same(tt.IMAGENET_STD, jt.IMAGENET_STD)


# -------------------------------------------------------- processing_utils
PU_CASES = ["sample_target", "sample_target_pad", "sample_target_no_resize",
            "transform_image_to_crop", "jittered_center_crop", "grounding_resize_wide",
            "grounding_resize_tall", "gaussian_radius", "cls_label_dynamic", "cls_label_static",
            "perturb_box"]


@pytest.mark.parametrize("case", PU_CASES)
def test_processing_utils_equal_jax(case):
    from uvltrack_tpu.data import processing_utils as jp
    from uvltrack_tpu_torch.data import processing_utils as tp

    rng = np.random.default_rng(PU_CASES.index(case))
    im = rng.integers(0, 256, size=(90, 120, 3)).astype(np.uint8)
    box = np.array([30.0, 20.0, 25.0, 18.0])

    def run(m):
        if case == "sample_target":
            return m.sample_target_np(im, box, 4.0, 64)
        if case == "sample_target_pad":
            return m.sample_target_np(im, np.array([2.0, 70.0, 40.0, 30.0]), 4.0, 64)
        if case == "sample_target_no_resize":
            return m.sample_target_np(im, box, 2.0)
        if case == "transform_image_to_crop":
            return [m.transform_image_to_crop(box, box + 1.5, rf, 64, normalize=n)
                    for rf in (0.5, 1.7) for n in (True, False)]
        if case == "jittered_center_crop":
            return m.jittered_center_crop([im, im[::-1].copy()], [box, box + 3],
                                          [box, box + 2], 4.0, 64)
        if case == "grounding_resize_wide":
            return m.grounding_resize_np(im, 64, box)
        if case == "grounding_resize_tall":
            return m.grounding_resize_np(im.transpose(1, 0, 2).copy(), 64, box[[1, 0, 3, 2]])
        if case == "gaussian_radius":
            return [m.gaussian_radius_np(h, w, o) for h, w, o in ((3.0, 5.0, 0.7), (10.0, 2.0, 0.5))]
        if case == "cls_label_dynamic":
            return [m.generate_cls_label_np(b, 16, 0.7, True)
                    for b in ([0.2, 0.3, 0.25, 0.1], [0.5, 0.5, 0.3, 0.4])]
        if case == "cls_label_static":
            return m.generate_cls_label_np(np.array([0.2, 0.3, 0.25, 0.1]), 16, 0.7, False)
        return [m.perturb_box(box, min_iou=iou, rng=np.random.default_rng(5))
                for iou in (0.5, 0.9)]

    same(run(tp), run(jp))


# ------------------------------------------------------------ grounding_aug
GA_CASES = ["has_directions", "flip_phrase", "size_menus", "random_resize_long",
            "random_resize_short", "random_size_crop", "color_jitter", "horizontal_flip",
            "letterbox_centered", "letterbox_random", "grounding_resize_train"]


@pytest.mark.parametrize("case", GA_CASES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grounding_aug_equals_jax(case, seed):
    from uvltrack_tpu.data import grounding_aug as jg
    from uvltrack_tpu_torch.data import grounding_aug as tg

    rng = np.random.default_rng(100 + seed)
    im = rng.integers(0, 256, size=(int(rng.integers(60, 140)), int(rng.integers(60, 140)), 3)
                      ).astype(np.uint8)
    x1, y1 = rng.uniform(0, 30, 2)
    box = np.array([x1, y1, x1 + rng.uniform(10, 40), y1 + rng.uniform(10, 30)])
    phrases = ["the dog on the Left", "a car to the right of the LEFT man", "middle top box"]

    def run(m):
        r = np.random.default_rng(seed)
        if case == "has_directions":
            return [m.has_directions(p) for p in phrases + ["a red car"]]
        if case == "flip_phrase":
            return [m.flip_phrase(p) for p in phrases]
        if case == "size_menus":
            return [m.size_menus(s) for s in (64, 128, 256, 320, 384)]
        if case == "random_resize_long":
            return m.random_resize([64, 48, 32], im, box, r, resize_long_side=True)
        if case == "random_resize_short":
            return m.random_resize([40, 32], im, box, r, resize_long_side=False)
        if case == "random_size_crop":
            return m.random_size_crop(im, box, r, 40, 60)
        if case == "color_jitter":
            return [m.color_jitter(im, r) for _ in range(4)]
        if case == "horizontal_flip":
            return [m.random_horizontal_flip(im, phrases[i % 3], box, r) for i in range(4)]
        if case == "letterbox_centered":
            return m.random_translate_letterbox(im[:50, :40], box / 3, 64, None)
        if case == "letterbox_random":
            return m.random_translate_letterbox(im[:50, :40], box / 3, 64, r)
        xywh = np.array([box[0], box[1], box[2] - box[0], box[3] - box[1]])
        return [m.grounding_resize_train(im, 64, xywh, phrases[i % 3], r) for i in range(3)]

    same(run(tg), run(jg))


# ------------------------------------------------------------ TrackProcessing
def _cfg(pkg, **over):
    import importlib

    cfg = importlib.import_module(f"{pkg}.config").default_cfg()
    cfg.DATA.TEMPLATE.SIZE = over.get("t", 32)
    cfg.DATA.SEARCH.SIZE = over.get("s", 64)
    return cfg


@pytest.mark.parametrize("process", ["track", "grounding", "grounding_directions",
                                     "grounding_test"])
@pytest.mark.parametrize("sizes", [(32, 64), (128, 256)])
def test_track_processing_equals_jax(process, sizes):
    """TrackProcessing's three processes on one fixed generator each: the
    same sample dicts, and the frame-major float32 NHWC, ImageNet-normalized
    contract of data/synthetic.py (keys, dtypes, per-frame shapes)."""
    from uvltrack_tpu.data.processing import TrackProcessing as JP
    from uvltrack_tpu_torch.data.processing import TrackProcessing as TP
    from uvltrack_tpu_torch.data.synthetic import synthetic_batch

    rng = np.random.default_rng(7)
    frames = [rng.integers(0, 256, size=(90, 120, 3)).astype(np.uint8) for _ in range(3)]
    boxes = [np.array([40.0 + i, 30.0, 22.0, 16.0]) for i in range(3)]

    def run(P, pkg):
        p = P(_cfg(pkg, t=sizes[0], s=sizes[1]), rng=np.random.default_rng(3))
        out = []
        for _ in range(3):
            if process == "track":
                out.append(p.track_process(frames[:1], boxes[:1], frames[1:], boxes[1:],
                                           "a red car"))
            elif process.startswith("grounding_test"):
                out.append(p.grounding_process_test(frames[:1], boxes[:1], "the dog", 2))
            else:
                lang = "the dog on the left" if process.endswith("directions") else "a dog"
                out.append(p.grounding_process(frames[:1], boxes[:1], frames[1:2], boxes[1:2],
                                               lang, 2))
        return out

    got, ref = run(TP, "uvltrack_tpu_torch"), run(JP, "uvltrack_tpu")
    same(got, ref)
    syn = synthetic_batch(np.random.default_rng(0), 1, template_size=sizes[0],
                          search_size=sizes[1])
    for s in got:
        assert s is not None
        for k in ("template_images", "search_images", "template_anno", "search_anno",
                  "search_cls"):
            assert s[k].dtype == np.float32 and s[k].shape == syn[k][:, 0].shape, k
        assert abs(float(s["search_images"].mean())) < 3  # normalized, not 0..255


def test_track_process_host_cost_guard():
    """The port's track_process on a 720p frame stays under the JAX
    package's per-sample bound (tests/test_loader_workers.py: 0.5 s)."""
    import time

    from uvltrack_tpu_torch.config import default_cfg
    from uvltrack_tpu_torch.data.processing import TrackProcessing

    proc = TrackProcessing(default_cfg(), seed=0)
    frame = np.random.default_rng(0).integers(0, 255, (720, 1280, 3)).astype(np.uint8)
    args = ([frame], [np.array([300.0, 200.0, 300.0, 260.0])], [frame, frame],
            [np.array([310.0, 205.0, 300.0, 260.0])] * 2, None)
    proc.track_process(*args)
    t0 = time.perf_counter()
    for _ in range(5):
        out = proc.track_process(*args)
    per = (time.perf_counter() - t0) / 5
    assert out["search_images"].shape[0] == 2
    assert per < 0.5, f"track_process {per * 1e3:.0f} ms/sample"


# ------------------------------------------------------------ dataset adapters
def _adapter_pairs():
    """(name, constructor(module package, env) -> dataset) for every adapter."""
    def vid(cls, path_key, **kw):
        return lambda m, e: getattr(m.video_datasets, cls)(e[path_key], **kw)

    def img(cls, path_key, **kw):
        return lambda m, e: getattr(m.image_datasets, cls)(e[path_key], **kw)

    def lm(cls, path_key, **kw):
        return lambda m, e: getattr(m.lmdb_datasets, cls)(e[path_key], **kw)

    return {
        "Lasot_train": vid("Lasot", "UVLTRACK_LASOT_PATH", split="train"),
        "Lasot_test": vid("Lasot", "UVLTRACK_LASOT_PATH", split="test"),
        "LasotExt": vid("LasotExt", "UVLTRACK_LASOTEXT_PATH"),
        "Got10k_vottrain": vid("Got10k", "UVLTRACK_GOT10K_PATH", split="vottrain"),
        "Got10k_train": vid("Got10k", "UVLTRACK_GOT10K_PATH", split="train"),
        "TrackingNet": vid("TrackingNet", "UVLTRACK_TRACKINGNET_PATH"),
        "Tnl2k": vid("Tnl2k", "UVLTRACK_TNL2K_PATH"),
        "Otb99_train": vid("Otb99", "UVLTRACK_OTB99_PATH", split="train"),
        "Otb99_test": vid("Otb99", "UVLTRACK_OTB99_PATH", split="test"),
        "ImagenetVID": vid("ImagenetVID", "UVLTRACK_IMAGENET_PATH"),
        "WebUAV": vid("WebUAV", "UVLTRACK_WEBUAV_PATH"),
        "CocoSeq": img("CocoSeq", "UVLTRACK_COCO_PATH"),
        "RefCocoSeq": img("RefCocoSeq", "UVLTRACK_COCO_PATH"),
        "RefCocoSeq_val": img("RefCocoSeq", "UVLTRACK_COCO_PATH", split="val"),
        "Object365": img("Object365", "UVLTRACK_OBJECT365_PATH"),
        "VisualGenome": img("VisualGenome", "UVLTRACK_VISUALGENOME_PATH"),
        "Got10kLmdb": lm("Got10kLmdb", "UVLTRACK_GOT10K_LMDB_PATH", split="vottrain"),
        "LasotLmdb": lm("LasotLmdb", "UVLTRACK_LASOT_LMDB_PATH", split="train"),
        "TrackingNetLmdb": lm("TrackingNetLmdb", "UVLTRACK_TRACKINGNET_LMDB_PATH"),
        "ImagenetVidLmdb": lm("ImagenetVidLmdb", "UVLTRACK_IMAGENET_LMDB_PATH"),
        "CocoSeqLmdb": lm("CocoSeqLmdb", "UVLTRACK_COCO_LMDB_PATH"),
    }


def _dataset_view(d):
    """Everything an adapter serves: capabilities, the sequence list, each
    sequence's info, language, and frames 0, the last and a middle one."""
    caps = [d.get_name(), d.is_video_sequence(), d.is_tracking_sequence(),
            d.is_grounding_sequence(), d.is_vl_sequence(), len(d)]
    seqs = []
    for i in range(d.get_num_sequences()):
        info = d.get_sequence_info(i)
        n = len(info["bbox"])
        ids = sorted({0, n - 1, n // 2}) if d.is_video_sequence() else [0, 0]
        frames, annos, meta = d.get_frames(i, ids, info)
        seqs.append([info, d.get_language(i), frames, annos, meta])
    return [caps, [str(s) for s in d.sequence_list], seqs]


@pytest.mark.parametrize("name", sorted(_adapter_pairs()))
def test_dataset_adapter_equals_jax(name, trees, monkeypatch):
    """Each adapter of the port against the JAX package's on the same tree;
    the LMDB ones read through the port's own reader (the binding is
    absent here, or made so)."""
    import uvltrack_tpu.data.datasets.lmdb_datasets  # noqa: F401 (not in the package's __init__)
    import uvltrack_tpu_torch.data.datasets.lmdb_datasets  # noqa: F401
    from uvltrack_tpu.data import datasets as jd
    from uvltrack_tpu_torch.data import datasets as td
    from uvltrack_tpu_torch.utils import lmdb_utils

    monkeypatch.setattr(lmdb_utils, "HAS_LMDB", False)
    make = _adapter_pairs()[name]
    ref = _dataset_view(make(jd, trees["env"]))
    got = _dataset_view(make(td, trees["env"]))
    assert got[0][-1] > 0, "an empty dataset tests nothing"
    same(got, ref)


# Every name of uvltrack_tpu/data/builders.py that a tree serves; the
# LMDB-packed GOT-10k splits read their tables from the pack's root.
BUILDER_NAMES = ["LASOT", "LASOT_test", "LASOTEXT", "GOT10K_vottrain", "GOT10K_votval",
                 "GOT10K_train_full", "TRACKINGNET", "TNL2K", "TNL2K_test", "OTB99", "OTB99_test",
                 "COCO17", "REFCOCOG", "REFCOCOG_val", "VID", "Object365", "VisualGenome",
                 "WEBUAV", "LASOT_lmdb", "GOT10K_vottrain_lmdb", "GOT10K_votval_lmdb",
                 "TRACKINGNET_lmdb", "VID_lmdb", "COCO17_lmdb"]


def test_names2datasets_covers_every_name_like_jax(trees):
    from uvltrack_tpu.data.builders import names2datasets as jn
    from uvltrack_tpu_torch.data.builders import names2datasets as tn

    src = (REPO / "uvltrack_tpu" / "data" / "builders.py").read_text()
    quoted = {n for n in BUILDER_NAMES if f'"{n}"' in src}
    assert quoted == {n for n in BUILDER_NAMES if not n.endswith("_lmdb")}
    got, ref = tn(BUILDER_NAMES), jn(BUILDER_NAMES)
    assert [type(d).__name__ for d in got] == [type(d).__name__ for d in ref]
    for g, r in zip(got, ref):
        assert type(g).__module__.startswith("uvltrack_tpu_torch.")
        assert g.get_name() == r.get_name() and len(g) == len(r) > 0
        same([str(s) for s in g.sequence_list], [str(s) for s in r.sequence_list])
    for bad in ("NOPE", "NOPE_lmdb"):
        with pytest.raises(ValueError, match="unknown training dataset"):
            tn([bad])


# ----------------------------------------------------------------- sampler
def _sampler(pkg, trees, mode, frame_mode="causal", names=None, seed=5, spe=40):
    import importlib

    b = importlib.import_module(f"{pkg}.data.builders")
    pr = importlib.import_module(f"{pkg}.data.processing")
    sm = importlib.import_module(f"{pkg}.data.sampler")
    tok = importlib.import_module(f"{pkg}.core.tokenizer").BertTokenizer
    cfg = _cfg(pkg)
    names = names or ["GOT10K_vottrain", "LASOT", "COCO17", "TRACKINGNET", "TNL2K", "OTB99",
                      "REFCOCOG"]
    ratios = [1, 1, 1, 1, 1, 0.2, 5][:len(names)] if mode == "joint" else None
    return sm.GroundingAndTrackingSampler(
        b.names2datasets(names), ratios, spe, 200 if frame_mode == "causal" else [20],
        pr.TrackProcessing(cfg, seed=seed), num_search_frames=2,
        num_template_frames=1 if frame_mode == "causal" else 2, mode=mode,
        grounding_ratio=0.11, vl_ratio=0.44, tokenizer=tok(trees["vocab"]), max_query_len=8,
        seed=seed, frame_sample_mode=frame_mode)


@pytest.mark.parametrize("mode,frame_mode,names", [
    ("joint", "causal", None),
    ("joint", "trident", ["LASOT", "TNL2K"]),
    ("joint", "stark", ["LASOT", "GOT10K_vottrain"]),
    ("grounding", "causal", ["LASOT", "REFCOCOG"]),
    ("tracking_test", "causal", ["LASOT_test", "LASOTEXT", "OTB99_test", "TNL2K_test"]),
    ("grounding_test", "causal", ["OTB99_test", "TNL2K_test", "LASOT_test"]),
    ("vl_test", "causal", ["LASOT_test", "LASOTEXT", "OTB99_test", "TNL2K_test"]),
])
def test_sampler_equals_jax_at_one_worker(mode, frame_mode, names, trees):
    """The task roll, the dataset picks, the frame sampling, processing and
    tokenizing: 24 draws of the port's sampler equal the JAX package's from
    one seed (grounding_test takes the loader's draw index)."""
    got_s = _sampler("uvltrack_tpu_torch", trees, mode, frame_mode, names)
    ref_s = _sampler("uvltrack_tpu", trees, mode, frame_mode, names)
    assert len(got_s) == len(ref_s)
    idx = (lambda i: i) if mode == "grounding_test" else (lambda i: None)
    got = [got_s(idx(i)) for i in range(24)]
    ref = [ref_s(idx(i)) for i in range(24)]
    same(got, ref)
    flags = {int(s["flag"]) for s in got}
    expect = {"joint": {0, 1, 2}, "grounding": {1}, "tracking_test": {0},
              "grounding_test": {1}, "vl_test": {2}}[mode]
    # the grounding task (flag 1, 11% of joint's draws) has its own case
    assert flags <= expect and (mode != "joint" or len(flags) > 1)
    assert any(s["text_mask"].sum() > 0 for s in got)


# ------------------------------------------------------------------ loader
def _loader_cfg(pkg, workers=1, mode="thread"):
    cfg = _cfg(pkg)
    cfg.TRAIN.NUM_WORKER = workers
    cfg.TPU.LOADER_WORKER_MODE = mode
    cfg.DATA.SEARCH.NUMBER = 2
    cfg.DATA.TRAIN.SAMPLE_PER_EPOCH = 8
    cfg.MODEL.BACKBONE.LANGUAGE.BERT.MAX_QUERY_LEN = 8
    for node in (cfg.DATA.VALTRACK, cfg.DATA.VALVL):
        node.SAMPLE_PER_EPOCH = 4
    return cfg


def test_loaders_equal_jax_at_one_worker_for_two_epochs(trees):
    """build_train_loader and build_val_loaders of both packages on the
    config's datasets: the same frame-major batches, epoch after epoch
    (the three validation families included)."""
    from uvltrack_tpu.data import loader as jl
    from uvltrack_tpu_torch.data import loader as tl

    batches = {}
    for name, m, pkg in (("port", tl, "uvltrack_tpu_torch"), ("jax", jl, "uvltrack_tpu")):
        cfg = _loader_cfg(pkg)
        cfg.MODEL.BACKBONE.LANGUAGE.VOCAB_PATH = trees["vocab"]
        train = m.build_train_loader(cfg, 4, seed=3)
        val = m.build_val_loaders(cfg, 4, seed=9)
        assert len(train) == 2 and set(val) == {"valtrack", "valground", "valvl"}
        batches[name] = [[list(train), {k: list(v) for k, v in val.items()}] for _ in range(2)]
    same(batches["port"], batches["jax"])
    b = batches["port"][0][0][0]
    assert b["search_images"].shape == (2, 4, 64, 64, 3) and b["flag"].shape == (4,)
    assert not np.array_equal(batches["port"][0][0][0]["search_images"],
                              batches["port"][1][0][0]["search_images"])


class _Draws:
    """A picklable sampler stub on the port's per-thread generator."""

    def __init__(self, seed=0, fail=False):
        from uvltrack_tpu_torch.data.sampler import _ThreadLocalRng

        self._rng, self.fail = _ThreadLocalRng(seed), fail

    def reseed(self, key):
        self._rng.reseed(key)

    def __call__(self, index):
        import time

        if self.fail:
            raise RuntimeError(f"sampler failed at draw {index}")
        time.sleep(0.02)  # spreads the draws over the workers
        v = np.float32(self._rng.get().random())
        return {"template_images": np.full((1, 2, 2, 3), v, np.float32),
                "template_anno": np.zeros((1, 4), np.float32),
                "search_images": np.full((2, 2, 2, 3), v, np.float32),
                "search_anno": np.zeros((2, 4), np.float32),
                "search_cls": np.zeros((2, 1, 1), np.float32),
                "text": np.zeros((2, 4), np.int32), "text_mask": np.zeros((2, 4), np.int32),
                "flag": np.int32(0)}


def test_process_workers_draw_per_worker_streams():
    """reseed(epoch * workers + worker id): every value a 2-process pool
    draws in epoch e comes from one of two precomputable streams, and no
    value repeats across epochs (tests/test_loader_workers.py's rule)."""
    from uvltrack_tpu_torch.data.loader import SamplerLoader
    from uvltrack_tpu_torch.data.sampler import _ThreadLocalRng

    def stream(wid, n=64):
        r = _ThreadLocalRng(5)
        r.reseed(wid)
        g = r.get()
        return {np.float32(g.random()) for _ in range(n)}

    loader = SamplerLoader(_Draws(seed=5), batch_size=6, steps_per_epoch=2, num_workers=2,
                           worker_mode="process")
    seen = []
    for epoch in (1, 2):
        drawn = [v for b in loader for v in b["search_images"][0, :, 0, 0, 0]]
        assert len(drawn) == 12 and set(drawn) <= stream(2 * epoch) | stream(2 * epoch + 1)
        seen.append(set(drawn))
    assert seen[0].isdisjoint(seen[1])


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_sampler_error_surfaces_to_the_consumer(mode):
    from uvltrack_tpu_torch.data.loader import SamplerLoader

    loader = SamplerLoader(_Draws(fail=True), batch_size=2, steps_per_epoch=3, num_workers=2,
                           worker_mode=mode)
    with pytest.raises(RuntimeError, match="sampler failed at draw"):
        list(loader)


# ----------------------------------------------------------------- prewarm
def test_prewarm_equals_jax(trees, tmp_path, capsys):
    """cli.prewarm over the got10k_lmdb pack and a two-shard TrackingNet
    layout: the port's message equals the JAX package's but for the
    seconds, and its TrackingNet jobs are the same."""
    from uvltrack_tpu.cli import prewarm as jp
    from uvltrack_tpu_torch.cli import prewarm as tp
    from uvltrack_tpu_torch.utils.lmdb_native import write_lmdb

    os.symlink(trees["env"]["UVLTRACK_GOT10K_LMDB_PATH"], tmp_path / "got10k_lmdb")
    t_root = tmp_path / "trackingnet_lmdb"
    t_root.mkdir()
    (t_root / "seq_list.json").write_text(json.dumps([[0, "seqA"], [0, "seqB"], [1, "seqC"]]))
    write_lmdb(str(t_root / "TRAIN_0_lmdb"), [("anno/seqA.txt", b"1,2,3,4\n")])
    write_lmdb(str(t_root / "TRAIN_1_lmdb"), [("anno/seqC.txt", b"5,6,7,8\n")])
    assert tp.trackingnet_jobs(str(tmp_path)) == jp.trackingnet_jobs(str(tmp_path))
    assert tp.INDEX_KEYS == jp.INDEX_KEYS
    out = []
    for m in (tp, jp):
        m.main(["--data_dir", str(tmp_path), "--dataset_str", "gt", "--full"])
        out.append(capsys.readouterr().out.rsplit(" in ", 1)[0])
    assert out[0] == out[1]
    assert out[0].startswith("pre-read 3 stores (")


def test_pickled_sampler_holds_no_tensor(trees):
    """A sampler crossing into a process worker pickles without torch."""
    s = _sampler("uvltrack_tpu_torch", trees, "joint")
    blob = pickle.dumps(s)
    found = []

    class Spy(pickle.Unpickler):
        def find_class(self, module, name):
            found.append(module)
            return super().find_class(module, name)

    t = Spy(io.BytesIO(blob)).load()
    assert found and not [m for m in found if m.split(".")[0] == "torch"]
    same(t(None), _sampler("uvltrack_tpu_torch", trees, "joint")(None))
