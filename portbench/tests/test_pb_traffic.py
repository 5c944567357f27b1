"""The traffic generator: banks, vocabularies and sentences from the seed,
the periodic path, and the re-mine stagger."""

import numpy as np
import pytest

from portbench.traffic import generator

from .helpers import DATA


def small(name="S8-mixed", **kw):
    tr = generator.load(name)
    tr.update(dict(frame=[64, 96], target=[24, 16], bank_frames=12), **kw)
    return tr


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3, -12])
def test_same_seed_same_inputs(seed):
    tr = small()
    a, ga = generator.make_bank(tr, seed)
    b, gb = generator.make_bank(tr, seed)
    assert np.array_equal(a, b) and np.array_equal(ga, gb)
    assert generator.sentences(tr, seed) == generator.sentences(tr, seed)
    assert generator.vocab_tokens(tr, seed) == generator.vocab_tokens(tr, seed)
    assert a.shape == (12, 8, 64, 96, 3) and a.dtype == np.uint8


def test_other_seed_other_inputs():
    tr = small()
    a, ga = generator.make_bank(tr, 1)
    b, gb = generator.make_bank(tr, 2)
    assert not np.array_equal(a, b) and not np.array_equal(ga, gb)
    assert generator.sentences(tr, 1) != generator.sentences(tr, 2)


def test_streams_differ_and_sentences_follow_modes():
    tr = small()
    bank, _ = generator.make_bank(tr, 3)
    assert not np.array_equal(bank[0, 0], bank[0, 1])
    sents = generator.sentences(tr, 3)
    for mode, s in zip(tr["modes"], sents):
        assert (s is None) == (mode == "BBOX")
        if s is not None:
            assert len(s) == tr["sentence_words"] and set(s) <= set(tr["words"])
    vocab = generator.vocab_tokens(tr, 3)
    assert vocab[:4] == ["[PAD]", "[UNK]", "[CLS]", "[SEP]"] and set(tr["words"]) <= set(vocab)


def test_path_is_periodic_with_the_bank():
    tr = small(bank_frames=16)
    _, boxes = generator.make_bank(tr, 9)
    # one step past the last frame is the first frame: the largest jump on the
    # loop is no larger than a step inside it
    steps = np.abs(np.diff(np.concatenate([boxes, boxes[:1]]), axis=0)).max(axis=(1, 2))
    assert steps[-1] <= steps[:-1].max()
    assert (boxes[..., 2:] == [24, 16]).all()
    (h, w), (tw, th) = tr["frame"], tr["target"]
    assert (boxes[..., 0] >= 0).all() and (boxes[..., 0] + tw <= w).all()
    assert (boxes[..., 1] >= 0).all() and (boxes[..., 1] + th <= h).all()


@pytest.mark.parametrize("name,expect", [("S8-mixed", [0, 2, 5, 8, 10, 12, 15, 18]),
                                         ("S8-nlbbox", [0, 2, 5, 8, 10, 12, 15, 18]),
                                         ("S1-bbox", [0])])
def test_remine_offsets(name, expect):
    assert generator.stagger(generator.load(name)) == expect


def test_offsets_fixed_by_the_mix_not_the_seed():
    tr = generator.load("S8-mixed")
    assert generator.stagger(tr) == [round(i * 20 / 8) for i in range(8)]
    assert (DATA / "tiny-S3.json").exists()
