"""uvltrack_tpu_torch's benchmark runners (eval/, copies of the JAX package's
framework-free runners) driving the port's trackers: the lockstep runner
with the port's BatchTracker writes the same result files as the JAX runner
with the JAX BatchTracker on the same weights; a stream that fails (a
corrupt frame, a change of resolution) is frozen and left unsaved while the
others finish; the sequential runner's chunked path equals its per-frame
path. Also the copied native JPEG decoder and the LMDB frame dispatch.
"""

import os

import numpy as np
import pytest

from test_torch_port_batch import _cfg
from test_torch_port_model import make_pair
from uvltrack_tpu.eval.running_batched import run_dataset_batched as jrun_dataset_batched
from uvltrack_tpu.track.batch import BatchTracker as JBatchTracker
from uvltrack_tpu_torch.config import CfgNode
from uvltrack_tpu_torch.eval import Sequence, SequenceList, run_dataset_batched, run_sequence
from uvltrack_tpu_torch.track.batch import BatchTracker
from uvltrack_tpu_torch.track.tracker import Tracker

HW = (64, 96)


def _dataset(tmp_path, lengths=(4, 6, 3), hw=HW, seed=0):
    rng = np.random.default_rng(seed)
    seqs = []
    for k, n in enumerate(lengths):
        frames = []
        for i in range(n):
            p = tmp_path / f"s{k}_f{i}.npy"
            np.save(p, rng.integers(0, 255, size=hw + (3,)).astype(np.uint8))
            frames.append(str(p))
        gt = np.tile(np.array([[10.0 + k, 12.0, 20.0, 18.0]]), (n, 1))
        seqs.append(Sequence(f"s{k}", frames, "otb99", gt))
    return SequenceList(seqs)


def _results(rdir, names):
    return {s: np.loadtxt(os.path.join(rdir, f"{s}.txt"), delimiter="\t", ndmin=2)
            for s in names}


@pytest.fixture(scope="module")
def built():
    jm, v, tm = make_pair(seed=4)
    return jm, v, tm


def _port_factory(tm):
    cfg = CfgNode(_cfg().to_dict())
    return lambda S: BatchTracker(cfg, tm, S)


def test_batched_runner_matches_the_jax_runner(built, tmp_path):
    """Three sequences of ragged length in groups of 2 then 1: the result
    files (integer boxes, frame 0 the init box) equal the JAX runner's; a
    second run skips every sequence (resumable)."""
    jm, v, tm = built
    ds = _dataset(tmp_path)
    rdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    stats = run_dataset_batched(_port_factory(tm), ds, rdir, num_streams=2,
                                image_loader=np.load, verbose=False)
    jrun_dataset_batched(lambda S: JBatchTracker(_cfg(), jm, v, S), ds, jdir,
                         num_streams=2, image_loader=np.load, verbose=False)
    assert stats["sequences"] == 3 and stats["frames"] == 13
    names = [s.name for s in ds]
    got, want = _results(rdir, names), _results(jdir, names)
    for k, s in enumerate(names):
        assert got[s].shape == (len(ds[k].frames), 4)
        np.testing.assert_array_equal(got[s][0], [10 + k, 12, 20, 18])
        np.testing.assert_array_equal(got[s], want[s])
    again = run_dataset_batched(_port_factory(tm), ds, rdir, num_streams=2,
                                image_loader=np.load, verbose=False)
    assert again["sequences"] == 0


@pytest.mark.parametrize("fault", ["corrupt", "resolution"])
def test_batched_runner_isolates_a_failed_stream(built, tmp_path, fault):
    """A stream whose third frame is corrupt, or changes resolution, is
    frozen from there and its result is not saved; the other stream of the
    group finishes with the boxes of a run without the fault."""
    _, _, tm = built
    ds = _dataset(tmp_path, lengths=(5, 5))
    clean = str(tmp_path / "clean")
    run_dataset_batched(_port_factory(tm), ds, clean, num_streams=2, image_loader=np.load,
                        verbose=False)
    bad = ds[1].frames[2]
    if fault == "corrupt":
        with open(bad, "wb") as f:
            f.write(b"not a frame")
    else:
        np.save(bad, np.zeros((HW[0] + 16, HW[1], 3), np.uint8))
    rdir = str(tmp_path / "faulty")
    stats = run_dataset_batched(_port_factory(tm), ds, rdir, num_streams=2,
                                image_loader=np.load, verbose=False)
    assert stats["sequences"] == 1
    assert not os.path.exists(os.path.join(rdir, "s1.txt"))
    np.testing.assert_array_equal(_results(rdir, ["s0"])["s0"], _results(clean, ["s0"])["s0"])


def test_run_sequence_chunked_equals_per_frame(built, tmp_path):
    """The sequential runner through the port's Tracker: chunk=4 (boxes read
    back once per 4 frames, Tracker.track_many) writes the boxes of chunk=0
    (one track() a frame), over 10 frames with a ragged last chunk."""
    _, _, tm = built
    ds = _dataset(tmp_path, lengths=(11,))
    tracker = Tracker(CfgNode(_cfg().to_dict()), tm)
    a, b = str(tmp_path / "chunk4"), str(tmp_path / "chunk0")
    assert run_sequence(tracker, ds[0], a, image_loader=np.load, chunk=4)[0] == 11
    run_sequence(tracker, ds[0], b, image_loader=np.load, chunk=0)
    got, want = _results(a, ["s0"])["s0"], _results(b, ["s0"])["s0"]
    assert got.shape == (11, 4)
    np.testing.assert_array_equal(got, want)


def test_track_many_splits_a_chunk_at_a_resolution_change(built):
    """Tracker.track_many(chunk) equals track() frame by frame across a
    change of frame size inside a chunk."""
    _, _, tm = built
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 255, size=(HW if i < 3 else (80, 100)) + (3,)).astype(np.uint8)
              for i in range(6)]
    t = Tracker(CfgNode(_cfg().to_dict()), tm)
    info = {"init_bbox": [20.0, 12.0, 20.0, 18.0]}
    t.initialize(frames[0], info)
    many = t.track_many(frames[1:], chunk=4)
    t.initialize(frames[0], info)
    one = [t.track(f) for f in frames[1:]]
    np.testing.assert_array_equal(many[:, :4], [r["target_bbox"] for r in one])
    np.testing.assert_array_equal(many[:, 4], [r["score"] for r in one])
    with pytest.raises(ValueError, match="chunk"):
        t.track_many(frames[1:], chunk=0)


def test_native_jpeg_decoder_matches_the_jax_packages(tmp_path):
    """The copied libjpeg decoder, built into the build directory, decodes
    a JPEG to the JAX package's bytes."""
    cv2 = pytest.importorskip("cv2")
    from uvltrack_tpu import native as jnative
    from uvltrack_tpu_torch import native

    img = np.random.default_rng(0).integers(0, 255, size=(48, 80, 3)).astype(np.uint8)
    path = str(tmp_path / "f.jpg")
    assert cv2.imwrite(path, img[..., ::-1])
    got = native.imread_rgb(path)
    assert got.shape == (48, 80, 3) and got.dtype == np.uint8
    want = jnative.imread_rgb(path)
    np.testing.assert_array_equal(got, want)
    frames = list(native.SequencePrefetcher([path] * 5, depth=2))
    assert len(frames) == 5 and all(np.array_equal(f, got) for f in frames)


def test_runners_route_lmdb_frame_refs_to_lmdb_utils(built, tmp_path, monkeypatch):
    """Both runners send a (db_path, key) frame ref to
    utils/lmdb_utils.decode_img and a path to the image loader (here
    decode_img stood in for by a table: the lmdb binding is not needed)."""
    from uvltrack_tpu_torch.utils import lmdb_utils

    _, _, tm = built
    rng = np.random.default_rng(2)
    table = {f"k{i}": rng.integers(0, 255, size=HW + (3,)).astype(np.uint8) for i in range(4)}
    asked = []

    def decode_img(db, key):
        asked.append((db, key))
        return table[key]

    monkeypatch.setattr(lmdb_utils, "decode_img", decode_img)
    gt = np.tile(np.array([[10.0, 12.0, 20.0, 18.0]]), (4, 1))
    ds = SequenceList([Sequence("lm0", [("db", k) for k in table], "otb99", gt)])
    stats = run_dataset_batched(_port_factory(tm), ds, str(tmp_path / "b"), num_streams=1,
                                image_loader=np.load, verbose=False)
    assert stats["sequences"] == 1 and ("db", "k3") in asked
    asked.clear()
    tracker = Tracker(CfgNode(_cfg().to_dict()), tm)
    run_sequence(tracker, ds[0], str(tmp_path / "s"), image_loader=np.load, prefetch=0)
    assert asked == [("db", k) for k in table]
    np.testing.assert_array_equal(_results(str(tmp_path / "s"), ["lm0"])["lm0"],
                                  _results(str(tmp_path / "b"), ["lm0"])["lm0"])


def test_batched_runner_dispatches_lmdb_frame_refs(built, tmp_path):
    """(db_path, key) frame refs decode through utils/lmdb_utils (the lmdb
    binding, or the port's own reader where it is absent) in the batched
    runner, as plain paths through the loader. The environment is written
    by the port's utils/lmdb_native.write_lmdb."""
    cv2 = pytest.importorskip("cv2")
    from uvltrack_tpu_torch.utils.lmdb_native import write_lmdb

    _, _, tm = built
    rng = np.random.default_rng(1)
    env_path = str(tmp_path / "env")
    frames, items = [], []
    for i in range(4):
        img = rng.integers(0, 255, size=HW + (3,)).astype(np.uint8)
        ok, buf = cv2.imencode(".png", img[..., ::-1])
        assert ok
        key = f"seq/{i:08d}.png"
        items.append((key, bytes(buf)))
        frames.append((env_path, key))
    write_lmdb(env_path, items)
    gt = np.tile(np.array([[10.0, 12.0, 20.0, 18.0]]), (4, 1))
    ds = SequenceList([Sequence("lm0", frames, "otb99", gt)])
    rdir = str(tmp_path / "results")
    stats = run_dataset_batched(_port_factory(tm), ds, rdir, num_streams=1, verbose=False)
    assert stats["sequences"] == 1
    assert _results(rdir, ["lm0"])["lm0"].shape == (4, 4)
