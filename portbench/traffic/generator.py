"""The one traffic generator: every traffic mix is a JSON file of
parameters beside this module (portbench/traffic/<name>.json), read here.

A mix gives S streams, each a mode (BBOX: flag 0, a box; NLBBOX: flag 2, a
box and a sentence), and a bank of synthetic frames per stream made from the
seed: a textured background and a textured target moving on a Lissajous
path whose period is the bank's length, so looping the bank never makes the
target jump. The seed moves frame content, paths and sentences only; the
number of streams, their modes, the frame size, the bank length and the
stagger of re-mine phases are the mix's.

Keys of a mix file:
  entry         "lockstep" (BatchTracker.step, frames as one (S, H, W, 3)
                uint8 array) or "single" (Tracker.track, S = 1)
  modes         one mode a stream
  frame         [H, W]
  bank_frames   frames a stream's bank holds (the path's period)
  target        [w, h] of the target in pixels
  path          {"amp": [ax, ay], "cycles": [kx, ky]}: centre = frame centre
                + amp * size * sin(2 pi cycles (t + phase) / bank_frames)
  words, filler, sentence_words
                the vocabulary's words, the seeded filler entries and the
                words a sentence draws
  stagger_period
                stream i starts round(i * period / S) frames ahead of
                stream 0, so re-mine phases spread as for streams that
                started at different times
  warmup_steps  steps after the stagger, before the window, every stream
                active (a re-mine on the way: both graphs captured)
  trace_steps   steps the --trace 1 run profiles after its window
  samples       {"plain": n, "due": n}: steps of the window drawn from the
                seed for the comparison with the reference (due: a step on
                which some stream re-mines)
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def load(name: str) -> dict:
    return json.loads((HERE / f"{name}.json").read_text())


def _rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64), *keys]))


def stagger(tr: dict) -> list:
    """Frames each stream runs ahead of stream 0 when the window opens."""
    s = len(tr["modes"])
    return [round(i * tr["stagger_period"] / s) for i in range(s)]


def make_bank(tr: dict, seed: int):
    """(bank (F, S, H, W, 3) uint8, boxes (F, S, 4) float32 xywh): row t holds
    every stream's frame t, so a lockstep step hands bank[t % F] over as it
    is, with no copy."""
    s, (h, w), f = len(tr["modes"]), tr["frame"], tr["bank_frames"]
    tw, th = tr["target"]
    (ax, ay), (kx, ky) = tr["path"]["amp"], tr["path"]["cycles"]
    bank = np.empty((f, s, h, w, 3), np.uint8)
    boxes = np.empty((f, s, 4), np.float32)
    for i in range(s):
        rng = _rng(seed, 1, i)
        coarse = rng.integers(0, 256, size=(h // 16 + 1, w // 16 + 1, 3)).astype(np.uint8)
        bg = np.repeat(np.repeat(coarse, 16, 0), 16, 1)[:h, :w] // 2
        bg += rng.integers(0, 128, size=(h, w, 3), dtype=np.uint8)
        tex = rng.integers(0, 256, size=(th // 8 + 1, tw // 8 + 1, 3)).astype(np.uint8)
        target = np.repeat(np.repeat(tex, 8, 0), 8, 1)[:th, :tw]
        phase = int(rng.integers(f))
        for t in range(f):
            a = 2 * np.pi * (t + phase) / f
            x0 = int(w / 2 + ax * w * np.sin(kx * a) - tw / 2)
            y0 = int(h / 2 + ay * h * np.sin(ky * a) - th / 2)
            frame = bank[t, i]
            frame[...] = bg
            frame[y0:y0 + th, x0:x0 + tw] = target
            boxes[t, i] = (x0, y0, tw, th)
    return bank, boxes


def vocab_tokens(tr: dict, seed: int) -> list:
    """The WordPiece vocabulary, one token a line: the specials, the mix's
    words and seeded filler entries."""
    rng = _rng(seed, 2)
    filler = ["".join(rng.choice(list("abcdefghij"), 5)) for _ in range(tr["filler"])]
    toks = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + sorted(set(tr["words"])) + filler
    return list(dict.fromkeys(toks))


def sentences(tr: dict, seed: int) -> list:
    """One sentence (a list of words) for each NLBBOX stream, None for the
    others."""
    rng = _rng(seed, 3)
    words = sorted(set(tr["words"]))
    return [[words[k] for k in rng.integers(len(words), size=tr["sentence_words"])]
            if m == "NLBBOX" else None for m in tr["modes"]]


def reservoir(tr: dict, seed: int):
    """The sampler of the window's steps: (rng, sizes by kind)."""
    return _rng(seed, 4), dict(tr["samples"])
