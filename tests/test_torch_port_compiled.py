"""uvltrack_tpu_torch's compiled step (track/tracker.py::JitTracker): the step
split into a body of device tensors and a host driver, CUDA graphs of the
step and the re-mine per (frame size, S, knobs), shared by every tracker on
one JitTracker.

On the CPU the graph driver runs with a stand-in capture that calls the
body again at each replay (`_eager_capture`), so everything but the CUDA
graph itself is exercised: the static buffers, the pinned-stage masks, the
device-side due/refresh, the always-applied active mask, the state copied
in and out, the constants copied when the owner changes, the chunked
uploads. Held to: today's eager step bit for bit (same ops, same order);
the JAX package's JitTracker.step_fn (Tracker.track) and scan_fn
(Tracker.track_many(chunk=4)) at tests/test_torch_port_tracker.py's
tolerance, fp32 (COMPUTE_DTYPE=float32) on the tiny model: boxes within
1e-3 px, scores and prompts within 1e-4.

The `gpu` cases capture real graphs of UVLTrack-B on the card (run there
with `python -m pytest tests/test_torch_port_compiled.py -m gpu
--noconftest`): step and re-mine graphs at S in {1, 4}, graph boxes
bitwise equal to the eager step's, the captured launches, no capture for a
second Tracker, and a knob set after capture getting a graph of its own.
"""

import pathlib

import numpy as np
import pytest
import torch

from uvltrack_tpu_torch.config import CfgNode
from uvltrack_tpu_torch.core.tokenizer import BertTokenizer
from uvltrack_tpu_torch.ops import attention as tattn
from uvltrack_tpu_torch.track import pipeline
from uvltrack_tpu_torch.track.batch import BatchTracker
from uvltrack_tpu_torch.track.pool import StreamPool
from uvltrack_tpu_torch.track.tracker import JitTracker, Tracker, frame_cost, graph_knobs
from uvltrack_tpu_torch.utils import tracing

REPO = pathlib.Path(__file__).resolve().parent.parent
H, W = 80, 100
BOX_TOL = dict(atol=1e-3, rtol=0)
SCORE_TOL = dict(atol=1e-4, rtol=1e-4)
SENTENCE = "a red box moving"
WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "red", "box", "the", "moving"]
MODES = ["BBOX", "NLBBOX", "NL"]
INIT = np.array([[30, 20, 20, 24], [10, 10, 30, 30], [1, 1, 2, 2]], np.float32)


def _frames(seed, n=1, h=H, w=W):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, size=(h, w, 3)).astype(np.uint8) for _ in range(n)]


def _eager_capture(self, fn):
    """The CPU's stand-in for JitTracker._capture: no graph; each replay
    calls the body again and puts its outputs where the graph's would be."""
    out = dict(fn())
    return (lambda: out.update(fn())), out


def _graphs_on(*trackers):
    for t in trackers:
        t.graphs = True
    return trackers


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(JitTracker, "_capture", _eager_capture)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The JAX model and variables and a port model on the same weights (the
    tiny fp32 pair of tests/test_torch_port_model.py), the vocab, and the
    JAX config (re-mines every 2 frames)."""
    from test_torch_port_model import make_pair
    from test_tracker import tiny_cfg

    jm, v, tm = make_pair(seed=3)
    vocab = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    vocab.write_text("\n".join(WORDS) + "\n")
    jcfg = tiny_cfg()
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    return jm, v, tm, str(vocab), jcfg


def _cfg(built, mode="BBOX"):
    cfg = CfgNode(built[4].to_dict())
    cfg.TEST.MODE = mode
    return cfg


# ------------------------------------------------------------ the pipeline
@pytest.mark.parametrize("factor,out_sz", [(2.0, 32), (4.0, 64)])
def test_normalize_repair_keeps_the_crop_bitwise(factor, out_sz):
    """normalize's constants are made once per device now: the crops (one
    frame, and S frames at once) equal the old per-call constants' bit for
    bit."""
    def old_normalize(img):
        mean = torch.tensor(pipeline.IMAGENET_MEAN, dtype=torch.float32, device=img.device)
        std = torch.tensor(pipeline.IMAGENET_STD, dtype=torch.float32, device=img.device)
        return (img / 255.0 - mean) / std

    frames = torch.from_numpy(np.stack(_frames(0, 3)))
    boxes = torch.tensor(INIT)
    for f, b in ((frames[0], boxes[0]), (frames, boxes)):
        new, _ = pipeline.sample_target_device(f, b, factor, out_sz)
        x1, y1, crop, _ = pipeline.crop_params(b, factor, out_sz)
        old = old_normalize(pipeline.crop_resize(f, x1, y1, crop, out_sz))
        np.testing.assert_array_equal(new.numpy(), (old[None] if f.ndim == 3 else old).numpy())
    assert pipeline._norm_consts(torch.device("cpu"))[0] is pipeline._norm_consts(
        torch.device("cpu"))[0]


# ------------------------------------------- the graph driver vs the eager one
def _lockstep(bt, steps=6):
    """initialize from frames of seed 100, then `steps` steps of frames of
    seed 101+t with stream 1 frozen on steps 2 and 3; returns the packed
    outputs, the init boxes first."""
    out = [bt.initialize(_frames(100, 3), INIT, languages=[SENTENCE] * 3, modes=MODES)]
    for t in range(steps):
        bt.set_active(np.array([True, t not in (2, 3), True]))
        out.append(bt.step(np.stack(_frames(101 + t, 3))))
    return out


@pytest.mark.parametrize("cond", ["1", "0"])
def test_graph_driver_equals_the_eager_step(built, stand_in, monkeypatch, cond):
    """BBOX, NLBBOX and NL streams, re-mines every 2 frames, a stream frozen
    for two steps, UVLTRACK_BATCH_COND_REMINE=1 and 0: the graph driver's
    boxes, scores, prompts, best scores and re-mine counts equal the eager
    step's bit for bit. The re-mine graph replays only on steps where some
    active stream is due (every step under "0")."""
    monkeypatch.setenv("UVLTRACK_BATCH_COND_REMINE", cond)
    tm, vocab = built[2], built[3]
    eager = BatchTracker(_cfg(built), tm, 3, tokenizer=BertTokenizer(vocab))
    graph, = _graphs_on(BatchTracker(_cfg(built), tm, 3, tokenizer=BertTokenizer(vocab)))
    assert not eager.graphs
    want, got = _lockstep(eager), _lockstep(graph)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    for k in ("prompt", "max_score", "best_search", "box"):
        assert torch.equal(getattr(eager.state, k), getattr(graph.state, k)), k
    assert eager.remines.tolist() == graph.remines.tolist() == [3, 2, 3]
    assert graph.state.frame_id.tolist() == [6, 4, 6]
    key, = graph.jt.keys()
    assert key == ((H, W), 3, graph_knobs())
    # due steps: 1, 3, 5 (frames 2, 4, 6; stream 1 frozen on 2 and 3)
    assert graph.jt.replays(key) == {"step": 6, "remine": 3 if cond == "1" else 6}
    assert graph.jt.graphs_captured == 2


def test_step_many_on_the_graph_driver(built, stand_in):
    """step_many uploads the T steps' frames once and replays T times: the
    eager steps' outputs exactly."""
    tm, vocab = built[2], built[3]
    eager = BatchTracker(_cfg(built), tm, 3, tokenizer=BertTokenizer(vocab))
    graph, = _graphs_on(BatchTracker(_cfg(built), tm, 3, tokenizer=BertTokenizer(vocab)))
    blocks = np.stack([np.stack(_frames(101 + t, 3)) for t in range(5)])
    for bt in (eager, graph):
        bt.initialize(_frames(100, 3), INIT, languages=[SENTENCE] * 3, modes=MODES)
    want = np.stack([eager.step(b) for b in blocks])
    got = graph.step_many(blocks)
    np.testing.assert_array_equal(got, want)
    assert torch.equal(graph.state.prompt, eager.state.prompt)


def test_pool_rows_reach_the_graph(built, stand_in):
    """A StreamPool on the graph driver against one on the eager step: opens
    at different rounds, a close and a slot reused by another sequence, a
    stream skipping rounds -- the rows open writes in place reach the
    graph's buffers (no slot is read stale): equal boxes."""
    tm, vocab = built[2], built[3]
    cfg = _cfg(built, "NLBBOX")
    pools = [StreamPool(cfg, tm, 3, tokenizer=BertTokenizer(vocab)) for _ in range(2)]
    _graphs_on(pools[1].bt)
    opens = {0: ["a"], 1: ["b"], 3: ["c"], 5: ["d"]}
    closes, skips = {5: ["a"]}, {2: ["b"]}
    outs = [[], []]
    for p, out in zip(pools, outs):
        sent = {}
        for r in range(8):
            for s in closes.get(r, []):
                p.close(s)
                del sent[s]
            for s in opens.get(r, []):
                seed = 200 + ord(s)
                p.open(s, _frames(seed)[0], {"init_bbox": INIT[ord(s) % 2].tolist(),
                                             "language": SENTENCE if s in "bd" else None})
                sent[s] = 0
            pending = {}
            for s in sent:
                if s not in skips.get(r, []):
                    sent[s] += 1
                    pending[s] = _frames(300 + ord(s) * 10 + sent[s])[0]
            out.append(p.submit(pending))
    assert outs[0] == outs[1]
    assert pools[1].slot_of["d"] == 0  # a's slot, reused
    assert pools[0].bt.remines.tolist() == pools[1].bt.remines.tolist()


def test_second_tracker_shares_the_graphs(built, stand_in):
    """A Tracker given jit_tracker= shares the prepared model and the graph
    caches: stepping it captures nothing new, and its boxes equal a fresh
    Tracker's (its own JitTracker). The two trackers interleave, so each
    replay copies in the other tracker's state and constants."""
    tm, vocab = built[2], built[3]
    cfg = _cfg(built, "NLBBOX")
    tok = BertTokenizer(vocab)
    t1, = _graphs_on(Tracker(cfg, tm, tokenizer=tok))
    t2, = _graphs_on(Tracker(cfg, tokenizer=tok, jit_tracker=t1.jt))
    assert t2.jt is t1.jt and t2.model is t1.model and t2.window is t1.window
    fresh = [Tracker(cfg, tm, tokenizer=tok) for _ in range(2)]
    assert fresh[0].jt is not t1.jt
    infos = [{"init_bbox": [30.0, 20.0, 20.0, 24.0], "language": SENTENCE},
             {"init_bbox": [10.0, 10.0, 30.0, 30.0], "language": "the red box"}]
    for t, f, info in zip((t1, t2), fresh, infos):
        t.initialize(_frames(40)[0], info)
        f.initialize(_frames(40)[0], info)
    want1, want2 = [], []
    for i in range(2):  # frame 2 is a re-mine frame: both graphs captured
        t1.track(_frames(41 + i)[0])
        want1.append(fresh[0].track(_frames(41 + i)[0]))
    captured = t1.jt.graphs_captured
    for i in range(5):
        a, b = _frames(43 + i)[0], _frames(60 + i)[0]
        got = (t1.track(a), t2.track(b))
        want1.append(fresh[0].track(a))
        want2.append(fresh[1].track(b))
        assert got[0] == want1[-1] and got[1] == want2[-1]
    assert t1.jt.graphs_captured == captured == 2
    assert t2.remines == fresh[1].remines == 2


# ------------------------------------------------- against the JAX package
@pytest.mark.parametrize("mode", ["BBOX", "NLBBOX"])
def test_graph_tracker_matches_jax_step_fn_and_scan_fn(built, stand_in, mode):
    """The graph driver's Tracker against the JAX Tracker frame by frame
    (track: JitTracker.step_fn), then a sequence of 9 frames through
    track_many(chunk=4) on both (JitTracker.scan_fn for the two full chunks,
    step_fn for the last frame); re-mines on frames 2, 4, 6, 8."""
    from uvltrack_tpu.core.tokenizer import BertTokenizer as JTok
    from uvltrack_tpu.track.tracker import Tracker as JTracker

    jm, v, tm, vocab, jcfg = built
    jcfg.TEST.MODE = mode
    jt = JTracker(jcfg, jm, v, tokenizer=JTok(vocab))
    tt, = _graphs_on(Tracker(_cfg(built, mode), tm, tokenizer=BertTokenizer(vocab)))
    info = {"init_bbox": [30.0, 20.0, 20.0, 24.0], "language": SENTENCE}
    assert tt.initialize(_frames(10)[0], info) == jt.initialize(_frames(10)[0], info)
    for i in range(5):
        f = _frames(11 + i)[0]
        ref, out = jt.track(f), tt.track(f)
        np.testing.assert_allclose(out["target_bbox"], ref["target_bbox"], **BOX_TOL)
        np.testing.assert_allclose(out["score"], ref["score"], **SCORE_TOL)
        np.testing.assert_allclose(tt.state.prompt.numpy(), np.asarray(jt.state.prompt),
                                   **SCORE_TOL)
    assert tt.remines == 2
    seq = [_frames(20 + i)[0] for i in range(9)]
    jt.initialize(_frames(19)[0], info)
    tt.initialize(_frames(19)[0], info)
    ref, out = jt.track_many(seq, chunk=4), tt.track_many(seq, chunk=4)
    assert out.shape == ref.shape == (9, 5)
    np.testing.assert_allclose(out[:, :4], ref[:, :4], **BOX_TOL)
    np.testing.assert_allclose(out[:, 4], ref[:, 4], **SCORE_TOL)
    np.testing.assert_allclose(tt.state.prompt.numpy(), np.asarray(jt.state.prompt),
                               **SCORE_TOL)
    assert tt.remines == 4 and tt.state.frame_id.tolist() == [9]
    jcfg.TEST.MODE = "BBOX"


def test_track_many_graph_chunks_equal_track(built, stand_in):
    """track_many on the graph driver (a chunk's frames in one upload, a
    resolution change ending a chunk early) equals track() frame by frame
    on the eager step."""
    tm = built[2]
    eager = Tracker(_cfg(built), tm)
    graph, = _graphs_on(Tracker(_cfg(built), tm))
    seq = [_frames(30 + i)[0] for i in range(5)] + _frames(36, 2, h=72, w=96)
    for t in (eager, graph):
        t.initialize(_frames(29)[0], {"init_bbox": [30.0, 20.0, 20.0, 24.0]})
    want = []
    for f in seq:
        r = eager.track(f)
        want.append(r["target_bbox"] + [r["score"]])
    got = graph.track_many(seq, chunk=3)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert len(graph.jt.keys()) == 2  # one graph set per frame size


# ------------------------------------------------------------- the keys
KNOBS = [("UVLTRACK_FUSED_PREFIX", "0"), ("UVLTRACK_FUSED_PROJ", "1"),
         ("UVLTRACK_FUSED_MLP", "1"), ("UVLTRACK_PALLAS_MIN_N", "32")]


def test_graph_key_changes_with_each_knob(built, monkeypatch):
    """Every call-time knob that changes the ops of a step, the backend and
    the tracer (its graphs record the region timers) change the key; the
    frame size and S do too."""
    for name, _ in KNOBS:
        monkeypatch.delenv(name, raising=False)
    jt = JitTracker(_cfg(built), built[2])
    base = jt.graph_key((H, W), 1)
    keys = {base}
    for name, value in KNOBS:
        monkeypatch.setenv(name, value)
        keys.add(jt.graph_key((H, W), 1))
        monkeypatch.delenv(name)
    tattn.force_backend("plain" if tattn.get_backend() == "cuda" else "cuda")
    try:
        keys.add(jt.graph_key((H, W), 1))
    finally:
        tattn.force_backend(None)
    tracing.start()
    try:
        keys.add(jt.graph_key((H, W), 1))
    finally:
        tracing.stop()
    keys |= {jt.graph_key((H + 1, W), 1), jt.graph_key((H, W), 2)}
    assert len(keys) == 1 + len(KNOBS) + 4
    assert jt.graph_key((H, W), 1) == base
    # the default spelled out is the default: no second graph for it
    monkeypatch.setenv("UVLTRACK_FUSED_PREFIX", "1")
    monkeypatch.setenv("UVLTRACK_PALLAS_MIN_N", "128")
    assert jt.graph_key((H, W), 1) == base


def test_knob_set_after_capture_gets_its_own_graph(built, stand_in, monkeypatch):
    """A knob set after a capture never replays the stale path: the next
    step captures a graph set of its own, and setting the knob back
    replays the first one."""
    monkeypatch.delenv("UVLTRACK_FUSED_PREFIX", raising=False)
    tt, = _graphs_on(Tracker(_cfg(built), built[2]))
    tt.initialize(_frames(29)[0], {"init_bbox": [30.0, 20.0, 20.0, 24.0]})
    tt.track(_frames(30)[0])
    first, = tt.jt.keys()
    monkeypatch.setenv("UVLTRACK_FUSED_PREFIX", "0")
    tt.track(_frames(31)[0])
    assert len(tt.jt.keys()) == 2
    monkeypatch.delenv("UVLTRACK_FUSED_PREFIX")
    tt.track(_frames(32)[0])
    assert tt.jt.replays(first)["step"] == 2 and len(tt.jt.keys()) == 2


# ------------------------------------------------------------- step_cost
def test_step_cost_counts_from_the_shapes(built):
    tt = Tracker(_cfg(built), built[2])
    cost = tt.step_cost((H, W, 3))
    fc = frame_cost(tt.model, tt.nt)
    assert cost == {"flops": fc["flops"], "bytes": fc["weight_bytes"] + H * W * 3}
    assert 0 < fc["kernel1_flops"] < fc["flops"]
    bb = tt.model.backbone
    n = 1 + bb.num_patches_z + bb.num_patches_x
    assert fc["flops"] > bb.depth * 24 * n * bb.embed_dim ** 2


# ------------------------------------------------------------- on the card
def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the chip)")


@pytest.fixture(scope="module")
def card_model():
    """UVLTrack-B (baseline_base.yaml) on the card, seeded random weights,
    re-mines every 2 frames (the score gate opened)."""
    _on_card()
    from uvltrack_tpu_torch.config import load_cfg
    from uvltrack_tpu_torch.models.uvltrack import build_model, prepare_inference_model

    cfg = load_cfg(str(REPO / "experiments/uvltrack/baseline_base.yaml"))
    cfg.TEST.THRESHOLD, cfg.TEST.UPDATE_INTERVAL, cfg.TEST.MODE = -1.0, 2, "BBOX"
    return cfg, prepare_inference_model(cfg, build_model(cfg, device="cuda", seed=0))


# the prefix kernels and the default path's projection, fc1 and fc2 (`dense`)
PER_FWD = {"ln_qkv[bf16x-bf16w]": 6, "ln_qkv[fp32x-bf16w]": 6, "qkv_attention[bf16]": 12,
           "dense[bf16a-bf16w-fp32o]": 36}


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 4])
def test_cuda_graphs_equal_the_eager_step(card_model, S):
    """At S streams (one frozen for two steps at S=4): the step and re-mine
    graphs are captured once, replay 6 steps with 3 re-mines, launch 12
    ln_qkv + 12 qkv_attention per step replay and none per re-mine, and give
    the eager step's boxes, scores and prompts bit for bit."""
    cfg, model = card_model
    jt = JitTracker(cfg, model)
    graph = BatchTracker(cfg, None, S, jit_tracker=jt)
    eager = BatchTracker(cfg, None, S, jit_tracker=jt, graphs=False)
    assert graph.graphs and not eager.graphs
    boxes = np.array([[300, 200, 96, 64], [500, 300, 80, 80], [100, 100, 60, 90],
                      [700, 400, 120, 70]][:S], np.float32)
    outs = []
    for bt in (eager, graph):
        bt.initialize(_frames(1, S, 480, 854), boxes)
        out = []
        for t in range(6):
            bt.set_active(np.array([i != 1 or t not in (2, 3) for i in range(S)]))
            out.append(bt.step(np.stack(_frames(2 + t, S, 480, 854))))
        outs.append(np.stack(out))
    np.testing.assert_array_equal(outs[1], outs[0])
    assert torch.equal(graph.state.prompt, eager.state.prompt)
    assert graph.remines.tolist() == eager.remines.tolist()
    key, = jt.keys()
    assert jt.replays(key) == {"step": 6, "remine": 3}
    assert jt.captured_launches(key) == {"step": PER_FWD, "remine": {}}
    assert jt.graphs_captured == 2 and jt.capture_seconds > 0


@pytest.mark.gpu
def test_cuda_second_tracker_captures_nothing(card_model, monkeypatch):
    """A second Tracker on the same JitTracker captures no graph, and its
    boxes equal a fresh Tracker's; UVLTRACK_FUSED_PREFIX=0 set after the
    capture gets its own graph, with 12 qkv_attention and no ln_qkv (and the
    36 products on `dense`)."""
    cfg, model = card_model
    frames = _frames(5, 7, 480, 854)
    info = {"init_bbox": [300.0, 200.0, 96.0, 64.0]}
    t1 = Tracker(cfg, model)
    t1.initialize(frames[0], info)
    t1.track_many(frames[1:4], chunk=3)
    captured = t1.jt.graphs_captured
    t2, fresh = Tracker(cfg, jit_tracker=t1.jt), Tracker(cfg, model)
    for t in (t2, fresh):
        t.initialize(frames[0], info)
    got = [t2.track(f) for f in frames[1:]]
    assert t1.jt.graphs_captured == captured
    assert got == [fresh.track(f) for f in frames[1:]]
    monkeypatch.setenv("UVLTRACK_FUSED_PREFIX", "0")
    t2.track(frames[1])
    key = t1.jt.graph_key(frames[0].shape[:2], 1)
    assert len(t1.jt.keys()) == 2
    assert t1.jt.captured_launches(key)["step"] == {"qkv_attention[bf16]": 12,
                                                     "dense[bf16a-bf16w-fp32o]": 36}
