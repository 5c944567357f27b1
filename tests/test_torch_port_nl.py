"""NL mode of uvltrack_tpu_torch against the JAX package: the grounding
letterbox, the grounding forward (UVLTrack.forward, the head's prompt mining
without a prompt) and the tracker's grounding init, at the tiny geometry of
tests/test_torch_port_model.py (C=32, 4 blocks, 32/64 px crops as in
experiments/uvltrack/_smoke_cpu.yaml, 8 text tokens). fp32; model outputs
within 1e-4, grounding boxes within 1e-3 px, letterboxes within 1e-4.

An NL init is compared in two parts: the grounding box of each tracker
(1e-3 px), then the prompt init of both from the JAX box, a shared state
(test_nl_init_centre_cell_is_a_near_tie records why). The NL trackers of
test_torch_port_tracker.py and test_torch_port_batch.py do the same through
ground_from_jax and share_jax_state, and step from the JAX state each frame,
as chip_smoke.py's paired_ab does on the card.
"""

import dataclasses

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
STATE_KEYS = ("box", "prompt", "max_score", "best_box_net", "best_search", "best_template",
              "best_vis_token", "best_txt_token")
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


def ground_from_jax(monkeypatch, port, boxes):
    """The port tracker's NL streams take their grounding boxes from
    `boxes` (the JAX tracker's, in stream order) on its next initialize:
    its prompt init then starts from the JAX box."""
    rows = iter(np.asarray(boxes, np.float32).reshape(-1, 4))
    if hasattr(port, "_grounding"):  # Tracker
        monkeypatch.setattr(port, "_grounding", lambda image: [float(v) for v in next(rows)])
    else:  # BatchTracker
        monkeypatch.setattr(port, "ground", lambda *a: next(rows))


def share_jax_state(port, jax_tracker):
    """Load the JAX tracker's state into the port's (Tracker: JAX shapes
    without the stream axis; BatchTracker: (S, ...)), so the next step of
    both starts from one state, as paired_ab does; the port keeps its own
    active flags."""
    st, js = port.state, jax_tracker.state
    new = {k: torch.from_numpy(np.array(getattr(js, k), np.float32)).reshape(
        getattr(st, k).shape) for k in STATE_KEYS}
    new["frame_id"] = np.asarray(js.frame_id, np.int64).reshape(st.frame_id.shape).copy()
    port.state = dataclasses.replace(st, **new)


NL_FRAME = np.random.default_rng(3).integers(0, 255, size=(80, 100, 3)).astype(np.uint8)
NL_INFO = {"language": "a red box moving"}


def test_nl_initialize_sets_the_grounding_box_and_flag_2(trackers, monkeypatch):
    """The grounding box within 1e-3 px; then the port's init from the JAX
    box: its prompt within 1e-4 and its template mask equal to JAX's."""
    jt, tt = trackers
    ref, out = jt.initialize(NL_FRAME, NL_INFO), tt.initialize(NL_FRAME, NL_INFO)
    np.testing.assert_allclose(out["target_bbox"], ref["target_bbox"], atol=1e-3, rtol=0)
    # the Tracker's state is the lockstep state at S=1: box (1, 4)
    np.testing.assert_allclose(tt.state.box[0].numpy(), out["target_bbox"], rtol=1e-6)
    assert int(tt.flag[0]) == int(jt.flag[0]) == 2
    np.testing.assert_array_equal(tt.text_mask.numpy(), np.asarray(jt.text_mask))
    ground_from_jax(monkeypatch, tt, ref["target_bbox"])
    assert tt.initialize(NL_FRAME, NL_INFO)["target_bbox"] == list(ref["target_bbox"])
    assert int(tt.flag[0]) == 2
    np.testing.assert_array_equal(tt.template_mask.numpy(), np.asarray(jt.template_mask))
    np.testing.assert_allclose(tt.state.prompt.numpy(), np.asarray(jt.state.prompt),
                               atol=1e-4, rtol=1e-4)


def _centre_cells(box, factor: float, size: int):
    """anno2mask's forced cell of the crop-normalized box on a size x size
    grid: (cx, cy), and the centre's distance to its nearest cell edge in
    crop pixels."""
    b = torch.from_numpy(np.asarray([box], np.float32))
    bx = geometry.box_xywh_to_xyxy(geometry.crop_box_normalized(b, factor))[0] * size
    ctr = torch.stack([bx[0] + bx[2], bx[1] + bx[3]]) / 2
    cell_px = float(torch.ceil(torch.sqrt(b[0, 2] * b[0, 3]) * factor)) / size
    return (tuple(torch.floor(ctr).int().tolist()),
            ((ctr - torch.round(ctr)).abs() * cell_px).tolist())


def test_nl_init_centre_cell_is_a_near_tie(trackers):
    """Why an NL init is compared from a shared box. anno2mask forces on the
    cell that holds the box centre, and the crop-normalized box is centred
    by construction: on the even grids (2x2 template, 4x4 search) its
    centre is the cell edge size/2 up to fp32 rounding, which the box's last
    bits decide. So the JAX and port grounding boxes, within 1e-3 px (fp32
    noise of the two grounding forwards, ~1e-5 px), may set different cells,
    and the prompt mined from them differs by whole units. Held here: both
    boxes put the centre within 4 ulps of the edge; a change of at most 8
    ulps of the box's w or h (< 1e-4 px) reaches both sides of it on each
    grid; and the JAX and port masks are equal for either box, so the flip
    is the box's, not the port's arithmetic."""
    jt, tt = trackers
    ref, out = jt.initialize(NL_FRAME, NL_INFO), tt.initialize(NL_FRAME, NL_INFO)
    jbox = np.float32(ref["target_bbox"])
    pbox = np.float32(out["target_bbox"])
    np.testing.assert_allclose(pbox, jbox, atol=1e-3, rtol=0)
    for factor, crop in ((tt.template_factor, tt.template_size),
                         (tt.search_factor, tt.search_size)):
        size = crop // 16
        assert size % 2 == 0
        for box in (jbox, pbox):
            _, margin = _centre_cells(box, factor, size)
            cell_px = np.ceil(np.sqrt(box[2] * box[3]) * factor) / size
            assert max(margin) <= 4 * np.spacing(np.float32(size / 2)) * cell_px < 1e-4
            nb = geometry.crop_box_normalized(torch.from_numpy(box[None]), factor)
            np.testing.assert_array_equal(
                geometry.anno2mask(nb, size).numpy(),
                np.asarray(jgeo.anno2mask(jnp.asarray(nb.numpy()), size)))
        cells = set()
        for j in (2, 3):
            for toward in (-np.inf, np.inf):
                nudged = jbox.copy()
                for _ in range(8):
                    nudged[j] = np.nextafter(nudged[j], np.float32(toward))
                    cells.add(_centre_cells(nudged, factor, size)[0])
        assert abs(nudged[3] - jbox[3]) < 1e-4
        assert len(cells) >= 2, (factor, cells)
