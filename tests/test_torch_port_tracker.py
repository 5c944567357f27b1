"""uvltrack_tpu_torch geometry, crop pipeline and Tracker against the JAX
package: the same frames and weights through both trackers, frame by frame,
in BBOX and NLBBOX mode with prompt re-mines (the pattern of
tests/test_tracker.py). fp32 (COMPUTE_DTYPE=float32); boxes within 1e-3 px,
scores and prompts within 1e-4, identical argmax cells (a different cell
would move the box by a whole 16 px stride).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_model import make_pair
from test_torch_port_nl import ground_from_jax, share_jax_state
from test_tracker import tiny_cfg
from uvltrack_tpu.core import box_ops as jbox
from uvltrack_tpu.core import geometry as jgeo
from uvltrack_tpu.core.hann import hanning2d_flat as jhann
from uvltrack_tpu.track import pipeline as jpipe
from uvltrack_tpu.track.tracker import Tracker as JTracker
from uvltrack_tpu_torch.config import CfgNode
from uvltrack_tpu_torch.core import box_ops, geometry
from uvltrack_tpu_torch.core.hann import hanning2d_flat
from uvltrack_tpu_torch.core.tokenizer import BertTokenizer
from uvltrack_tpu_torch.track import pipeline
from uvltrack_tpu_torch.track.tracker import Tracker

H, W = 80, 100


def _frame(seed):
    return np.random.default_rng(seed).integers(0, 255, size=(H, W, 3)).astype(np.uint8)


# ------------------------------------------------------------------ geometry
# inside; spill left/top; spill right/bottom; exact fit on the far edges;
# larger than the frame on every side
BOXES = [[30.0, 20.0, 20.0, 24.0], [-6.0, -9.0, 18.0, 14.0], [85.0, 66.0, 22.0, 19.0],
         [70.0, 50.0, 30.0, 30.0], [10.0, 5.0, 80.0, 70.0]]


@pytest.mark.parametrize("box", BOXES)
@pytest.mark.parametrize("factor,out_sz", [(2.0, 32), (4.0, 64)])
def test_sample_target_matches_jax(box, factor, out_sz):
    """Bilinear crop with the far-edge quirk, normalization and the crop
    window's round-half-even corner."""
    frame = _frame(0)
    ref, rf = jpipe.sample_target_device(jnp.asarray(frame), jnp.asarray(box), factor, out_sz)
    out, trf = pipeline.sample_target_device(torch.from_numpy(frame), torch.tensor(box),
                                             factor, out_sz)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(trf.numpy(), np.asarray(rf), rtol=1e-7)


def test_crop_exact_fit_drops_the_last_row_and_column():
    """A crop whose far edge is exactly the frame's edge (x2 == W) samples
    the last column as zero, like the reference's padding."""
    frame = np.full((16, 16, 3), 200, np.uint8)
    args = (torch.tensor(8, dtype=torch.int32), torch.tensor(8, dtype=torch.int32),
            torch.tensor(8, dtype=torch.int32), 8)
    out = pipeline.crop_resize(torch.from_numpy(frame), *args)
    ref = jpipe.crop_resize(jnp.asarray(frame), *(jnp.asarray(a.numpy()) for a in args[:3]), 8)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert (out[-1] == 0).all() and (out[:, -1] == 0).all() and (out[:-1, :-1] == 200).all()


def test_geometry_helpers_match_jax():
    rng = np.random.default_rng(1)
    boxes = np.abs(rng.normal(0.4, 0.2, size=(6, 4))).astype(np.float32)
    np.testing.assert_array_equal(geometry.anno2mask(torch.from_numpy(boxes), 8).numpy(),
                                  np.asarray(jgeo.anno2mask(jnp.asarray(boxes), 8)))
    for b in BOXES:
        jb, tb = jnp.asarray(b), torch.tensor(b)
        for j, t in zip(jgeo.crop_params(jb, 4.0, 64), geometry.crop_params(tb, 4.0, 64)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-7)
        np.testing.assert_allclose(geometry.crop_box_normalized(tb, 2.0).numpy(),
                                   np.asarray(jgeo.crop_box_normalized(jb, 2.0)), rtol=1e-6)
    pred = rng.normal(30, 10, size=(4,)).astype(np.float32)
    prev = np.asarray(BOXES[0], np.float32)
    np.testing.assert_allclose(
        geometry.map_box_back(torch.from_numpy(pred), torch.from_numpy(prev),
                              torch.tensor(1.7), 64).numpy(),
        np.asarray(jgeo.map_box_back(jnp.asarray(pred), jnp.asarray(prev),
                                     jnp.asarray(1.7), 64)), rtol=1e-6)
    wild = rng.normal(50, 80, size=(5, 4)).astype(np.float32)
    np.testing.assert_allclose(box_ops.clip_box_xywh(torch.from_numpy(wild), H, W, 10).numpy(),
                               np.asarray(jbox.clip_box_xywh(jnp.asarray(wild), H, W, 10)))
    np.testing.assert_allclose(box_ops.box_cxcywh_to_xywh(torch.from_numpy(wild)).numpy(),
                               np.asarray(jbox.box_cxcywh_to_xywh(jnp.asarray(wild))))
    for sz in (1, 4, 16):
        np.testing.assert_allclose(hanning2d_flat(sz).numpy(), np.asarray(jhann(sz)),
                                   atol=1e-7)


# ------------------------------------------------------------------- tracker
@pytest.fixture(scope="module")
def trackers(tmp_path_factory):
    """A JAX and a port Tracker on the same perturbed weights, fp32, with
    re-mines every 2 frames (THRESHOLD=-1 opens the score gate)."""
    jm, v, tm = make_pair(seed=3)
    vocab = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "red",
                                "box", "the", "moving"]) + "\n")
    from uvltrack_tpu.core.tokenizer import BertTokenizer as JTok

    jcfg = tiny_cfg()
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    jt = JTracker(jcfg, jm, v, tokenizer=JTok(str(vocab)))
    tt = Tracker(CfgNode(jcfg.to_dict()), tm, tokenizer=BertTokenizer(str(vocab)))
    return jt, tt


@pytest.mark.parametrize("mode", ["BBOX", "NLBBOX"])
def test_tracker_matches_jax_frame_by_frame(trackers, mode):
    jt, tt = trackers
    jt.cfg.TEST.MODE = tt.cfg.TEST.MODE = mode
    info = {"init_bbox": [30.0, 20.0, 20.0, 24.0], "language": "a red box moving"}
    assert tt.initialize(_frame(10), info) == jt.initialize(_frame(10), info)
    assert int(tt.flag[0]) == int(jt.flag[0]) == (0 if mode == "BBOX" else 2)
    np.testing.assert_allclose(tt.state.prompt.numpy(), np.asarray(jt.state.prompt),
                               atol=1e-4, rtol=1e-4)
    for i in range(7):
        f = _frame(11 + i)
        ref, out = jt.track(f), tt.track(f)
        np.testing.assert_allclose(out["target_bbox"], ref["target_bbox"], atol=1e-3, rtol=0)
        np.testing.assert_allclose(out["score"], ref["score"], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(tt.state.prompt.numpy(), np.asarray(jt.state.prompt),
                                   atol=1e-4, rtol=1e-4)
        assert float(tt.state.max_score) == pytest.approx(float(jt.state.max_score), abs=1e-4)
    assert tt.state.frame_id == int(jt.state.frame_id) == 7
    assert tt.remines == 3  # frames 2, 4, 6


def test_track_many_equals_track(trackers):
    _, tt = trackers
    tt.cfg.TEST.MODE = "BBOX"
    frames = [_frame(30 + i) for i in range(4)]
    tt.initialize(_frame(29), {"init_bbox": [30.0, 20.0, 20.0, 24.0]})
    many = tt.track_many(frames)
    tt.initialize(_frame(29), {"init_bbox": [30.0, 20.0, 20.0, 24.0]})
    seq = [tt.track(f) for f in frames]
    assert many.shape == (4, 5)
    np.testing.assert_array_equal(many[:, :4], [r["target_bbox"] for r in seq])
    np.testing.assert_array_equal(many[:, 4], [r["score"] for r in seq])


def test_track_debug_matches_jax_and_track(trackers):
    """The response maps equal the JAX tracker's, and the box and score
    equal a replayed track()."""
    jt, tt = trackers
    jt.cfg.TEST.MODE = tt.cfg.TEST.MODE = "BBOX"
    frames = [_frame(50 + i) for i in range(3)]
    for t in (jt, tt):
        t.initialize(_frame(49), {"init_bbox": [30.0, 20.0, 20.0, 24.0]})
    dbg = []
    for f in frames:
        ref, out = jt.track_debug(f), tt.track_debug(f)
        for key in ("cls_map", "cont_map", "merged_map"):
            np.testing.assert_allclose(out[key], ref[key], atol=1e-4, rtol=1e-4)
        dbg.append(out)
    tt.initialize(_frame(49), {"init_bbox": [30.0, 20.0, 20.0, 24.0]})
    for d, f in zip(dbg, frames):
        r = tt.track(f)
        assert d["target_bbox"] == r["target_bbox"] and d["score"] == r["score"]


def test_nl_mode_matches_jax_frame_by_frame(trackers, monkeypatch):
    """NL mode starts from a sentence alone: the grounding box becomes the
    init box, the sequence tracks with flag 2, and every frame (re-mines
    included) agrees with the JAX tracker at the tolerances above. The
    grounding boxes are compared alone; the init then starts from the JAX
    box and every step from the JAX state (the init's forced mask cell is a
    near-tie on the box's last bits: test_torch_port_nl.py)."""
    jt, tt = trackers
    jt.cfg.TEST.MODE = tt.cfg.TEST.MODE = "NL"
    try:
        info = {"language": "a red box moving"}
        ref, out = jt.initialize(_frame(40), info), tt.initialize(_frame(40), info)
        np.testing.assert_allclose(out["target_bbox"], ref["target_bbox"], atol=1e-3, rtol=0)
        assert int(tt.flag[0]) == int(jt.flag[0]) == 2
        ground_from_jax(monkeypatch, tt, ref["target_bbox"])
        tt.initialize(_frame(40), info)
        np.testing.assert_allclose(tt.state.prompt.numpy(), np.asarray(jt.state.prompt),
                                   atol=1e-4, rtol=1e-4)
        for i in range(7):
            f = _frame(41 + i)
            share_jax_state(tt, jt)
            ref, out = jt.track(f), tt.track(f)
            np.testing.assert_allclose(out["target_bbox"], ref["target_bbox"], atol=1e-3,
                                       rtol=0)
            np.testing.assert_allclose(out["score"], ref["score"], atol=1e-4, rtol=1e-4)
            np.testing.assert_allclose(tt.state.prompt.numpy(), np.asarray(jt.state.prompt),
                                       atol=1e-4, rtol=1e-4)
        assert tt.remines == 3
    finally:
        jt.cfg.TEST.MODE = tt.cfg.TEST.MODE = "BBOX"


@pytest.mark.parametrize("mode", ["BBOX", "NLBBOX"])
def test_uncached_text_matches_jax_frame_by_frame(trackers, mode):
    """TPU.CACHE_TEXT=False: both trackers step UVLTrack.forward_test on the
    raw text ids every frame (BERT each frame), and agree frame by frame,
    re-mines included, at the tolerances above; the port's boxes also equal
    its cached-text tracker's."""
    jt0, tt0 = trackers
    jcfg = tiny_cfg()
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    jcfg.TPU.CACHE_TEXT = False
    jcfg.TEST.MODE = mode
    jt = JTracker(jcfg, jt0.jt.model, jt0.jt.variables, tokenizer=jt0.tokenizer)
    tt = Tracker(CfgNode(jcfg.to_dict()), tt0.model, tokenizer=tt0.tokenizer)
    assert not tt.cache_text and not jt.jt.cache_text
    info = {"init_bbox": [30.0, 20.0, 20.0, 24.0], "language": "a red box moving"}
    assert tt.initialize(_frame(60), info) == jt.initialize(_frame(60), info)
    assert tt.txt.dtype == torch.int32 and tuple(tt.txt.shape) == tuple(jt.txt.shape)
    tt0.cfg.TEST.MODE = mode
    tt0.initialize(_frame(60), info)
    for i in range(5):
        f = _frame(61 + i)
        ref, out, cached = jt.track(f), tt.track(f), tt0.track(f)
        np.testing.assert_allclose(out["target_bbox"], ref["target_bbox"], atol=1e-3, rtol=0)
        np.testing.assert_allclose(out["score"], ref["score"], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(tt.state.prompt.numpy(), np.asarray(jt.state.prompt),
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(out["target_bbox"], cached["target_bbox"], atol=1e-3,
                                   rtol=0)
    assert tt.remines == 2  # frames 2, 4
    tt0.cfg.TEST.MODE = "BBOX"
