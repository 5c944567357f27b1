"""uvltrack_tpu_torch's StreamPool (track/pool.py) against the JAX package's
StreamPool and against single port Trackers fed the same frames: streams
that join mid-flight, streams frozen for a round and a slot reused after a
close each reproduce the single-stream trajectory (the scenario of
tests/test_stream_pool.py), with the tolerances of
tests/test_torch_port_tracker.py: boxes within 1e-3 px, scores within 1e-4.
The tiny model of tests/test_torch_port_model.py, fp32.
"""

import numpy as np
import pytest

from test_torch_port_batch import BOX_TOL, SCORE_TOL, WORDS, _cfg
from test_torch_port_model import make_pair
from uvltrack_tpu.core.tokenizer import BertTokenizer as JTok
from uvltrack_tpu.track.pool import StreamPool as JStreamPool
from uvltrack_tpu_torch.config import CfgNode
from uvltrack_tpu_torch.core.tokenizer import BertTokenizer
from uvltrack_tpu_torch.track.pool import StreamPool
from uvltrack_tpu_torch.track.tracker import Tracker

SENTENCE = "the red box"


def _frames(seed, n, hw=(80, 100)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, size=hw + (3,)).astype(np.uint8) for _ in range(n)]


def _port_cfg(mode):
    cfg = CfgNode(_cfg().to_dict())
    cfg.TEST.MODE = mode
    return cfg


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The JAX model and variables, a port model on the same weights, the
    vocab, and one JAX StreamPool of 2 slots in NLBBOX mode."""
    jm, v, tm = make_pair(seed=5)
    vocab = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    vocab.write_text("\n".join(WORDS) + "\n")
    jcfg = _cfg()
    jcfg.TEST.MODE = "NLBBOX"
    jpool = JStreamPool(jcfg, jm, v, capacity=2, tokenizer=JTok(str(vocab)))
    return tm, str(vocab), jpool


def _standalone(tm, vocab, mode, frames, info):
    t = Tracker(_port_cfg(mode), tm, tokenizer=BertTokenizer(vocab))
    t.initialize(frames[0], info)
    return [t.track(f) for f in frames[1:]]


def _scenario(pool):
    """A joins alone, B joins two rounds later, A is frozen for a round, A
    closes and C takes its slot. A has no sentence (flag 0 in NLBBOX mode,
    the BatchTracker's rule), B and C have one (flag 2). Returns the opens'
    boxes, each stream's results and the streams' infos and frames."""
    fa, fb, fc = _frames(1, 5), _frames(2, 5), _frames(3, 2)
    info = {"A": {"init_bbox": [30.0, 20.0, 20.0, 24.0]},
            "B": {"init_bbox": [10.0, 10.0, 30.0, 30.0], "language": SENTENCE},
            "C": {"init_bbox": [40.0, 30.0, 25.0, 20.0], "language": "a moving box"}}
    got = {"A": [], "B": [], "C": []}
    opened = [pool.open("A", fa[0], info["A"])]
    got["A"].append(pool.submit({"A": fa[1]})["A"])
    got["A"].append(pool.submit({"A": fa[2]})["A"])
    opened.append(pool.open("B", fb[0], info["B"]))  # joins mid-flight
    out = pool.submit({"A": fa[3], "B": fb[1]})
    got["A"].append(out["A"])
    got["B"].append(out["B"])
    got["B"].append(pool.submit({"B": fb[2]})["B"])  # A frozen this round
    out = pool.submit({"A": fa[4], "B": fb[3]})
    got["A"].append(out["A"])
    got["B"].append(out["B"])
    pool.close("A")
    opened.append(pool.open("C", fc[0], info["C"]))  # reuses A's slot
    assert pool.open_streams == ["B", "C"]
    out = pool.submit({"B": fb[4], "C": fc[1]})
    got["B"].append(out["B"])
    got["C"].append(out["C"])
    return opened, got, info, {"A": fa, "B": fb, "C": fc}


def test_join_freeze_and_slot_reuse_match_jax_and_single_trackers(built):
    tm, vocab, jpool = built
    pool = StreamPool(_port_cfg("NLBBOX"), tm, capacity=2, tokenizer=BertTokenizer(vocab))
    opened, got, info, frames = _scenario(pool)
    j_opened, j_got, _, _ = _scenario(jpool)
    assert opened == j_opened == [info[s]["init_bbox"] for s in "ABC"]
    assert pool.slot_of == jpool.slot_of == {"B": 1, "C": 0}
    assert pool.bt.flags.tolist() == np.asarray(jpool.bt.flags).tolist() == [2, 2]
    for s in "ABC":
        # A, without a sentence, tracks as a BBOX-mode Tracker (flag 0)
        want = _standalone(tm, vocab, "BBOX" if s == "A" else "NLBBOX", frames[s], info[s])
        assert len(got[s]) == len(j_got[s]) == len(want)
        for g, j, w in zip(got[s], j_got[s], want):
            np.testing.assert_allclose(g["bbox"], j["bbox"], **BOX_TOL)
            np.testing.assert_allclose(g["score"], j["score"], **SCORE_TOL)
            np.testing.assert_allclose(g["bbox"], w["target_bbox"], **BOX_TOL)
            np.testing.assert_allclose(g["score"], w["score"], **SCORE_TOL)
    np.testing.assert_allclose(pool.bt.state.prompt.numpy(), np.asarray(jpool.bt.state.prompt),
                               **SCORE_TOL)
    assert pool.bt.state.frame_id.tolist() == np.asarray(jpool.bt.state.frame_id).tolist()
    assert pool.bt.remines.tolist() == [0, 2]  # C: one frame; B: frames 2 and 4


def test_pool_full_unknown_and_mixed_resolution(built):
    tm, vocab, _ = built
    with pytest.raises(ValueError, match="capacity"):
        StreamPool(_port_cfg("BBOX"), tm, capacity=0)
    pool = StreamPool(_port_cfg("BBOX"), tm, capacity=1)
    f = _frames(7, 2)
    pool.open("A", f[0], {"init_bbox": [5, 5, 20, 20]})
    with pytest.raises(RuntimeError, match="pool full"):
        pool.open("B", f[0], {"init_bbox": [5, 5, 20, 20]})
    with pytest.raises(LookupError, match="not open"):
        pool.submit({"ghost": f[1]})
    with pytest.raises(LookupError, match="not open"):
        pool.close("ghost")
    assert pool.submit({}) == {}
    # a re-open of a live stream re-initializes it in place (no second slot)
    pool.open("A", f[1], {"init_bbox": [8, 8, 22, 22]})
    assert pool.open_streams == ["A"] and pool.bt.state.frame_id.tolist() == [0]
    pool.close("A")
    pool.open("B", f[0], {"init_bbox": [5, 5, 20, 20]})  # the freed slot reused
    assert pool.slot_of == {"B": 0}

    pool2 = StreamPool(_port_cfg("BBOX"), tm, capacity=2)
    g = _frames(8, 1, hw=(64, 96))
    pool2.open("A", f[0], {"init_bbox": [5, 5, 20, 20]})
    pool2.open("B", g[0], {"init_bbox": [5, 5, 20, 20]})
    with pytest.raises(ValueError, match="one resolution"):
        pool2.submit({"A": f[0], "B": g[0]})
    # one stream at a time, each at its own resolution, is fine
    assert set(pool2.submit({"B": g[0]})) == {"B"}


def test_nl_open_grounds_like_single_tracker(built):
    """NL mode: open() takes the slot's box from the grounding forward (a
    supplied box is ignored), bit for bit the single Tracker's, portrait
    letterbox offset included; the slot then tracks like the Tracker."""
    tm, vocab, _ = built
    frames = _frames(9, 3, hw=(96, 64))
    info = {"language": SENTENCE, "init_bbox": [1, 1, 2, 2]}
    pool = StreamPool(_port_cfg("NL"), tm, capacity=2, tokenizer=BertTokenizer(vocab))
    pool.open("other", _frames(10, 1, hw=(96, 64))[0], info)
    box = pool.open("A", frames[0], info)
    t = Tracker(_port_cfg("NL"), tm, tokenizer=BertTokenizer(vocab))
    want = t.initialize(frames[0], info)["target_bbox"]
    np.testing.assert_array_equal(np.float32(box), np.float32(want))
    assert box != info["init_bbox"]
    for f in frames[1:]:
        got, ref = pool.submit({"A": f})["A"], t.track(f)
        np.testing.assert_allclose(got["bbox"], ref["target_bbox"], **BOX_TOL)
        np.testing.assert_allclose(got["score"], ref["score"], **SCORE_TOL)
