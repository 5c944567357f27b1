"""uvltrack_tpu_torch's lockstep multi-stream tracking (track/batch.py) against
the JAX package's BatchTracker and against single port Trackers, on the same
frames and weights (the tiny model of tests/test_torch_port_model.py, fp32,
COMPUTE_DTYPE=float32), frame by frame: boxes within 1e-3 px, scores and
prompts within 1e-4, as tests/test_torch_port_tracker.py holds the single
Tracker. The batched crop equals the stack of single crops exactly.
"""

import numpy as np
import pytest
import torch

from test_torch_port_model import make_pair
from test_torch_port_nl import ground_from_jax, share_jax_state
from test_torch_port_tracker import BOXES
from test_tracker import tiny_cfg
from uvltrack_tpu.core.tokenizer import BertTokenizer as JTok
from uvltrack_tpu.track.batch import BatchTracker as JBatchTracker
from uvltrack_tpu_torch.config import CfgNode
from uvltrack_tpu_torch.core.tokenizer import BertTokenizer
from uvltrack_tpu_torch.ops import attention as tattn
from uvltrack_tpu_torch.ops import ln_qkv_attention as lqa
from uvltrack_tpu_torch.track import pipeline
from uvltrack_tpu_torch.track.batch import BatchTracker
from uvltrack_tpu_torch.track.tracker import Tracker, grounding_inputs

H, W = 80, 100
BOX_TOL = dict(atol=1e-3, rtol=0)
SCORE_TOL = dict(atol=1e-4, rtol=1e-4)
SENTENCE = "a red box moving"
WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "red", "box", "the", "moving"]


def _frames(seed, n=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, size=(H, W, 3)).astype(np.uint8) for _ in range(n)]


def _cfg(**tpu):
    c = tiny_cfg()
    c.TPU.COMPUTE_DTYPE = "float32"
    for k, v in tpu.items():
        setattr(c.TPU, k, v)
    return c


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The JAX model and variables, a port model on the same weights, the
    vocab, and one JAX BatchTracker of 3 streams (re-mines every 2 frames)."""
    jm, v, tm = make_pair(seed=3)
    vocab = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    vocab.write_text("\n".join(WORDS) + "\n")
    jbt = JBatchTracker(_cfg(), jm, v, 3, tokenizer=JTok(str(vocab)))
    return jm, v, tm, str(vocab), jbt


def _port(built, streams=3, **tpu):
    _, _, tm, vocab, _ = built
    return BatchTracker(CfgNode(_cfg(**tpu).to_dict()), tm, streams,
                        tokenizer=BertTokenizer(vocab))


# --------------------------------------------------------------- the crop
@pytest.mark.parametrize("factor,out_sz", [(2.0, 32), (4.0, 64)])
def test_batched_crop_equals_stacked_single_crops(factor, out_sz):
    """One crop a stream, each from its own frame, far-edge quirk included
    (the spill and exact-fit boxes): bit for bit the single crops."""
    frames = torch.from_numpy(np.stack(_frames(0, len(BOXES))))
    boxes = torch.tensor(BOXES)
    patches, factors = pipeline.sample_target_device(frames, boxes, factor, out_sz)
    assert patches.shape == (len(BOXES), out_sz, out_sz, 3)
    for i in range(len(BOXES)):
        one, rf = pipeline.sample_target_device(frames[i], boxes[i], factor, out_sz)
        np.testing.assert_array_equal(patches[i].numpy(), one[0].numpy())
        np.testing.assert_array_equal(factors[i].numpy(), rf.numpy())


# ------------------------------------------------------ against the JAX one
MODES = ["BBOX", "NLBBOX", "NL"]
INIT = np.array([[30, 20, 20, 24], [10, 10, 30, 30], [1, 1, 2, 2]], np.float32)


def _lockstep(bt, steps, active_at=None):
    """initialize from frames of seed 100, then `steps` steps of frames of
    seed 101+t; yields (init boxes, then each step's packed output)."""
    out = [bt.initialize(_frames(100, 3), INIT, languages=[SENTENCE] * 3, modes=MODES)]
    for t in range(steps):
        if active_at is not None:
            bt.set_active(active_at(t))
        out.append(bt.step(np.stack(_frames(101 + t, 3))))
    return out


def _freeze_1(t):
    """Stream 1 frozen on steps 2 and 3."""
    return np.array([True, t not in (2, 3), True])


def _init_from_jax(monkeypatch, jbt, bt):
    """Both trackers initialized on frames of seed 100: the NL stream's
    grounding boxes within 1e-3 px, then the port's init again from the JAX
    boxes (the shared state; the init's forced mask cell is a near-tie on
    the box's last bits: test_torch_port_nl.py). Returns both inits."""
    args = (_frames(100, 3), INIT)
    kw = dict(languages=[SENTENCE] * 3, modes=MODES)
    j_init, t_init = jbt.initialize(*args, **kw), bt.initialize(*args, **kw)
    np.testing.assert_allclose(t_init, j_init, **BOX_TOL)
    ground_from_jax(monkeypatch, bt, [j_init[i] for i, m in enumerate(MODES) if m == "NL"])
    np.testing.assert_array_equal(bt.initialize(*args, **kw), j_init)
    np.testing.assert_array_equal(bt.template_mask.numpy(), np.asarray(jbt.template_mask))
    return j_init, t_init


def test_batch_tracker_matches_jax_frame_by_frame(built, monkeypatch):
    """BBOX, NLBBOX and NL streams side by side, re-mines every 2 frames,
    stream 1 frozen for two steps (its box and frame_id unchanged); each
    step from the JAX state."""
    jbt = built[4]
    bt = _port(built)
    j_init, t_init = _init_from_jax(monkeypatch, jbt, bt)
    # flags by the BatchTracker's rule: 0 for BBOX, 2 for a text mode
    assert bt.flags.tolist() == np.asarray(jbt.flags).tolist() == [0, 2, 2]
    np.testing.assert_array_equal(t_init[:2], INIT[:2])
    assert not np.allclose(t_init[2], INIT[2])  # NL: grounded, the given box ignored
    np.testing.assert_allclose(bt.state.prompt.numpy(), np.asarray(jbt.state.prompt),
                               **SCORE_TOL)
    for t in range(6):
        active = _freeze_1(t)
        jbt.set_active(active)
        bt.set_active(active)
        frames = np.stack(_frames(101 + t, 3))
        share_jax_state(bt, jbt)
        before = bt.state.box.clone()
        ref, out = jbt.step(frames), bt.step(frames)
        np.testing.assert_allclose(out[:, :4], ref[:, :4], **BOX_TOL)
        np.testing.assert_allclose(out[:, 4], ref[:, 4], **SCORE_TOL)
        np.testing.assert_allclose(bt.state.prompt.numpy(), np.asarray(jbt.state.prompt),
                                   **SCORE_TOL)
        np.testing.assert_allclose(bt.state.max_score.numpy(), np.asarray(jbt.state.max_score),
                                   **SCORE_TOL)
        assert bt.state.frame_id.tolist() == np.asarray(jbt.state.frame_id).tolist()
        if not active[1]:
            assert torch.equal(bt.state.box[1], before[1])
    assert bt.state.frame_id.tolist() == [6, 4, 6]
    assert bt.remines.tolist() == [3, 2, 3]  # frames 2, 4, 6; stream 1: 2, 4


def test_uncached_text_matches_jax(built, monkeypatch):
    """TPU.CACHE_TEXT=False at batch S: both step forward_test on the raw
    text ids (BERT each frame) and agree frame by frame, re-mines
    included, each step from the JAX state."""
    jm, v, _, vocab, _ = built
    jbt = JBatchTracker(_cfg(CACHE_TEXT=False), jm, v, 3, tokenizer=JTok(vocab))
    bt = _port(built, CACHE_TEXT=False)
    assert not bt.cache_text
    _init_from_jax(monkeypatch, jbt, bt)
    assert bt.txt.dtype == torch.int32
    for t in range(3):
        frames = np.stack(_frames(101 + t, 3))
        share_jax_state(bt, jbt)
        r, o = jbt.step(frames), bt.step(frames)
        np.testing.assert_allclose(o[:, :4], r[:, :4], **BOX_TOL)
        np.testing.assert_allclose(o[:, 4], r[:, 4], **SCORE_TOL)
        np.testing.assert_allclose(bt.state.prompt.numpy(), np.asarray(jbt.state.prompt),
                                   **SCORE_TOL)


# ------------------------------------------------ against single Trackers
def test_batch_tracker_matches_single_trackers(built):
    """Each stream of the batch against a port Tracker of its own on the
    same frames (stream 1 skips the frames it is frozen on); re-mines
    counted alike."""
    _, _, tm, vocab, _ = built
    bt = _port(built)
    out = _lockstep(bt, 6, _freeze_1)
    for i, mode in enumerate(MODES):
        cfg = CfgNode(_cfg().to_dict())
        cfg.TEST.MODE = mode
        tr = Tracker(cfg, tm, tokenizer=BertTokenizer(vocab))
        init = tr.initialize(_frames(100, 3)[i], {"init_bbox": INIT[i].tolist(),
                                                  "language": SENTENCE})
        np.testing.assert_allclose(out[0][i], init["target_bbox"], **BOX_TOL)
        for t in range(6):
            if not _freeze_1(t)[i]:
                continue
            r = tr.track(_frames(101 + t, 3)[i])
            np.testing.assert_allclose(out[t + 1][i, :4], r["target_bbox"], **BOX_TOL)
            np.testing.assert_allclose(out[t + 1][i, 4], r["score"], **SCORE_TOL)
        np.testing.assert_allclose(bt.state.prompt[i:i + 1].numpy(), tr.state.prompt.numpy(),
                                   **SCORE_TOL)
        assert tr.remines == bt.remines[i] and tr.state.frame_id == bt.state.frame_id[i]


def test_nl_streams_ground_as_each_alone(built):
    """Two NL streams on different frames and sentences: each grounded box
    equals a single Tracker's bit for bit, and so do the prompts mined from
    it at batch 2 within 1e-4 (the grounding forward runs at batch 1, one
    stream at a time, as the JAX BatchTracker vmaps a batch-1 forward).
    One grounding forward over both streams would pair each stream's
    template with the other's search features in the prompt-less path's
    rotation; under flag 1 the prompter returns its query embeddings, so
    the boxes come out the same all the same."""
    _, _, tm, vocab, _ = built
    bt = _port(built, streams=2)
    frames, langs = [_frames(7)[0], _frames(8)[0]], [SENTENCE, "the red box"]
    boxes = bt.initialize(frames, np.zeros((2, 4)), languages=langs, modes=["NL", "NL"])
    cfg = CfgNode(_cfg().to_dict())
    cfg.TEST.MODE = "NL"
    tr = Tracker(cfg, tm, tokenizer=BertTokenizer(vocab))
    alone = []
    for i, lang in enumerate(langs):
        box = tr.initialize(frames[i], {"language": lang})["target_bbox"]
        np.testing.assert_array_equal(boxes[i], np.float32(box))
        np.testing.assert_allclose(bt.state.prompt[i:i + 1].numpy(), tr.state.prompt.numpy(),
                                   **SCORE_TOL)
        alone.append(tr.grounding_forward(tr._frame(frames[i]))["pred_boxes"])
    assert not np.allclose(boxes[0], boxes[1])
    both = [torch.cat(parts) for parts in zip(*(
        grounding_inputs(torch.from_numpy(frames[i]), bt.text_ids[i:i + 1],
                         bt.text_mask[i:i + 1], bt.template_size, bt.search_size)
        for i in range(2)))]
    with torch.no_grad():
        mixed = bt.model(*both)["pred_boxes"]
    np.testing.assert_allclose(mixed.numpy(), torch.cat(alone).numpy(), atol=1e-6, rtol=0)


def test_prompt_init_and_text_cache_at_batch_s_equal_batch_1(built):
    """forward_prompt_init and encode_text mix no rows: at batch 3 each row
    equals its batch-1 call."""
    bt = _port(built)
    bt.initialize(_frames(100, 3), INIT, languages=[SENTENCE] * 3, modes=MODES)
    frames = bt.device_frames(_frames(100, 3))
    for i in range(3):
        template, tmask, prompt = bt.init_rows(
            frames[i:i + 1], bt.state.box[i:i + 1], bt.text_ids[i:i + 1],
            bt.text_mask[i:i + 1], bt.flags[i:i + 1])
        np.testing.assert_array_equal(template.numpy(), bt.template[i:i + 1].numpy())
        np.testing.assert_array_equal(tmask.numpy(), bt.template_mask[i:i + 1].numpy())
        np.testing.assert_allclose(prompt.numpy(), bt.state.prompt[i:i + 1].numpy(),
                                   atol=1e-5, rtol=1e-5)
        with torch.no_grad():
            txt = bt.model.encode_text(bt.text_ids[i:i + 1], bt.text_mask[i:i + 1])
        np.testing.assert_allclose(txt.numpy(), bt.txt[i:i + 1].numpy(), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------ the port alone
def test_unconditional_remine_gives_the_same_boxes(built, monkeypatch):
    """UVLTRACK_BATCH_COND_REMINE=0 re-mines every step, where-selected,
    with no host read: the same boxes, scores and prompts as "1"."""
    monkeypatch.setenv("UVLTRACK_BATCH_COND_REMINE", "1")
    bt = _port(built)
    cond = _lockstep(bt, 5, _freeze_1)
    cond_prompt, cond_remines = bt.state.prompt.clone(), bt.remines
    monkeypatch.setenv("UVLTRACK_BATCH_COND_REMINE", "0")
    always = _lockstep(bt, 5, _freeze_1)
    for a, b in zip(cond, always):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(bt.state.prompt, cond_prompt)
    assert bt.remines.tolist() == cond_remines.tolist() == [2, 1, 2]


def test_step_many_equals_repeated_steps(built):
    bt = _port(built)
    blocks = np.stack([np.stack(_frames(101 + t, 3)) for t in range(4)])
    steps = np.stack(_lockstep(bt, 4)[1:])
    state = bt.state
    bt.initialize(_frames(100, 3), INIT, languages=[SENTENCE] * 3, modes=MODES)
    many = bt.step_many(blocks)
    assert many.shape == (4, 3, 5)
    np.testing.assert_array_equal(many, steps)
    np.testing.assert_array_equal(bt.state.box.numpy(), state.box.numpy())
    np.testing.assert_array_equal(bt.state.prompt.numpy(), state.prompt.numpy())


@pytest.mark.parametrize("streams", [1, 3])
def test_kernel_entry_calls_per_batched_step(built, streams, monkeypatch):
    """With the kernel gate open on the CPU (the card stood in for, the gate
    at 16 tokens), a batched step calls kernel #1's entry once per block, at
    S=1 as at S=3: the batch rides in the rows, not in more launches."""
    monkeypatch.setattr(tattn, "_BACKEND", "cuda")
    monkeypatch.setattr(tattn, "_on_card", lambda t: True)
    monkeypatch.setenv("UVLTRACK_PALLAS_MIN_N", "16")
    calls = []
    entry = lqa.ln_qkv_attention

    def spy(x, *a, **kw):
        calls.append(x.shape[0])
        return entry(x, *a, **kw)

    monkeypatch.setattr(lqa, "ln_qkv_attention", spy)
    bt = _port(built, streams=streams)
    frames = _frames(100, streams)
    bt.initialize(frames, INIT[:streams], modes=["BBOX"] * streams)
    calls.clear()
    bt.step(np.stack(_frames(101, streams)))
    depth = len(bt.model.backbone.vit.blocks)
    assert calls == [streams] * depth
