"""NL mode of uvltrack_tpu_torch against the JAX package: the grounding
letterbox, the grounding forward (UVLTrack.forward, the head's prompt mining
without a prompt) and the tracker's grounding init, at the tiny geometry of
tests/test_torch_port_model.py (C=32, 4 blocks, 32/64 px crops as in
experiments/uvltrack/_smoke_cpu.yaml, 8 text tokens). fp32; model outputs
within 1e-4, grounding boxes within 1e-3 px, letterboxes within 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_model import _inputs, _t, japply, make_pair
from test_tracker import tiny_cfg
from uvltrack_tpu.core import geometry as jgeo
from uvltrack_tpu.models.uvltrack import UVLTrack as JUVLTrack
from uvltrack_tpu.track import pipeline as jpipe
from uvltrack_tpu.track.tracker import Tracker as JTracker
from uvltrack_tpu_torch.config import CfgNode
from uvltrack_tpu_torch.core import geometry
from uvltrack_tpu_torch.core.tokenizer import BertTokenizer
from uvltrack_tpu_torch.track import pipeline
from uvltrack_tpu_torch.track.tracker import Tracker

ATOL = RTOL = 1e-4
WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "red", "box", "the", "moving"]


@pytest.mark.parametrize("b", [1, 2, 3, 4])
def test_rotate_half_batch_matches_jax(b):
    x = np.arange(b * 6, dtype=np.float32).reshape(b, 3, 2)
    np.testing.assert_array_equal(geometry.rotate_half_batch(torch.from_numpy(x)).numpy(),
                                  np.asarray(jgeo.rotate_half_batch(jnp.asarray(x))))


# (H, W, out): landscape and portrait 720p downscaled to 256, a square
# frame, frames smaller than the canvas (upscaled), and odd margins
SHAPES = [(720, 1280, 256), (1280, 720, 256), (300, 300, 256), (100, 150, 256),
          (150, 97, 256), (80, 100, 64), (97, 203, 256)]


@pytest.mark.parametrize("h,w,out", SHAPES)
def test_letterbox_params_match_jax(h, w, out):
    assert pipeline.letterbox_params(h, w, out) == jpipe.letterbox_params(h, w, out)


@pytest.mark.parametrize("h,w,out", SHAPES)
def test_grounding_letterbox_matches_jax(h, w, out):
    """F.interpolate(bilinear, align_corners=False, antialias=False) against
    jax.image.resize(linear, antialias=False), borders included, after the
    canvas and normalization; the frame as the JAX tracker passes it (fp32)
    and as the port's tracker does (uint8)."""
    frame = np.random.default_rng(h * w).integers(0, 256, size=(h, w, 3)).astype(np.uint8)
    ref = np.asarray(jpipe.grounding_letterbox(jnp.asarray(frame, jnp.float32), out))
    got = pipeline.grounding_letterbox(torch.from_numpy(frame), out)
    assert got.shape == ref.shape == (1, out, out, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(
        got.numpy(), pipeline.grounding_letterbox(torch.from_numpy(frame).float(), out).numpy())
    oh, ow, y0, x0 = pipeline.letterbox_params(h, w, out)
    pad = pipeline.normalize(torch.zeros(3))
    if y0:
        np.testing.assert_allclose(got[0, 0].numpy(), np.broadcast_to(pad, (out, 3)), atol=1e-6)
    if x0:
        np.testing.assert_allclose(got[0, :, 0].numpy(), np.broadcast_to(pad, (out, 3)),
                                   atol=1e-6)


@pytest.fixture(scope="module")
def pair():
    return make_pair()


@pytest.mark.parametrize("flag_val", [1, 0, 2])
def test_grounding_forward_matches_jax(pair, flag_val):
    """UVLTrack.forward == model.apply (UVLTrack.__call__, train=False) at
    batch 2, so the prompter mines from the rotated batch: every output of
    the head, and the argmax cell."""
    jm, v, tm = pair
    arrs = _inputs(flag_val, seed=21)
    ref = japply(jm, v, *(jnp.asarray(a) for a in arrs))
    out = tm(*(_t(a) for a in arrs))
    for key in ("prompts", "cont_score", "cls_score_test", "bbox_map", "pred_boxes",
                "cls_score"):
        np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(ref[key]),
                                   atol=ATOL, rtol=RTOL, err_msg=key)
    assert out["cont_score"].shape[-1] == 2  # the mining path's two columns


def test_grounding_forward_with_cls_tokenize_matches_jax():
    """The other head configuration (tokenized cls input, no softmax_one)."""
    jm, v, tm = make_pair(cls_tokenize=True, softmax_one=False, seed=5)
    arrs = _inputs(1, seed=22)
    ref = japply(jm, v, *(jnp.asarray(a) for a in arrs))
    out = tm(*(_t(a) for a in arrs))
    for key in ("prompts", "cont_score", "bbox_map", "pred_boxes", "cls_score"):
        np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(ref[key]),
                                   atol=ATOL, rtol=RTOL, err_msg=key)


def test_grounding_uses_the_grounding_size_tower(pair):
    """Under flag 1 the boxes' sizes come from conv_bbox_grounding (carried
    across by models/convert.py with the other towers); perturbing it moves
    them, perturbing conv_bbox does not."""
    _, _, tm = pair
    arrs = [_t(a) for a in _inputs(1, seed=23)]
    with torch.no_grad():
        base = tm(*arrs)["bbox_map"][..., 2:].clone()
        final = tm.box_head.conv_bbox[4].bias
        final += 1.0
        same = tm(*arrs)["bbox_map"][..., 2:].clone()
        final -= 1.0
        tower = tm.box_head.conv_bbox_grounding[4].bias
        tower += 1.0
        moved = tm(*arrs)["bbox_map"][..., 2:].clone()
        tower -= 1.0
    torch.testing.assert_close(same, base, rtol=0, atol=0)
    assert (moved - base).abs().max() > 1e-3


@pytest.fixture(scope="module")
def trackers(tmp_path_factory):
    """A JAX and a port Tracker on the same perturbed weights, fp32, NL mode."""
    from uvltrack_tpu.core.tokenizer import BertTokenizer as JTok

    jm, v, tm = make_pair(seed=4)
    vocab = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    vocab.write_text("\n".join(WORDS) + "\n")
    jcfg = tiny_cfg()
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    jcfg.TEST.MODE = "NL"
    jt = JTracker(jcfg, jm, v, tokenizer=JTok(str(vocab)))
    tt = Tracker(CfgNode(jcfg.to_dict()), tm, tokenizer=BertTokenizer(str(vocab)))
    return jt, tt


# landscape and portrait (the margin shift goes to y, then x), a square frame
# and one smaller than the 64 px canvas
@pytest.mark.parametrize("hw", [(80, 100), (100, 80), (64, 64), (40, 50)])
def test_grounding_box_matches_jax(trackers, hw):
    jt, tt = trackers
    frame = np.random.default_rng(hw[0]).integers(0, 255, size=(*hw, 3)).astype(np.uint8)
    for t in (jt, tt):
        t.text_ids, t.text_mask = t._tokenize("the red box")
    ref = jt._grounding(frame, "the red box")
    out = tt._grounding(frame)
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)
    assert all(isinstance(x, float) for x in out)


def test_nl_initialize_sets_the_grounding_box_and_flag_2(trackers):
    jt, tt = trackers
    frame = np.random.default_rng(3).integers(0, 255, size=(80, 100, 3)).astype(np.uint8)
    info = {"language": "a red box moving"}
    ref, out = jt.initialize(frame, info), tt.initialize(frame, info)
    np.testing.assert_allclose(out["target_bbox"], ref["target_bbox"], atol=1e-3, rtol=0)
    np.testing.assert_allclose(tt.state.box.numpy(), out["target_bbox"], rtol=1e-6)
    assert int(tt.flag[0]) == int(jt.flag[0]) == 2
    np.testing.assert_array_equal(tt.text_mask.numpy(), np.asarray(jt.text_mask))
    np.testing.assert_allclose(tt.state.prompt.numpy(), np.asarray(jt.state.prompt),
                               atol=1e-4, rtol=1e-4)
