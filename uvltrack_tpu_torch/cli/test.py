"""Evaluation CLI of the port: build_tracker so far (port of
uvltrack_tpu/cli/test.py::build_tracker). The `test` CLI's main, which runs
a tracker over a benchmark, comes with the port's CLIs (ROADMAP queue 1,
item 2); checkpoint directories of the JAX trainer wait for training (item
3).
"""

from __future__ import annotations

import os

from ..core.tokenizer import BertTokenizer
from ..eval.environment import env_settings, resolve_path
from ..models.convert import load_reference_state, load_torch_file
from ..models.uvltrack import build_model
from ..track.tracker import Tracker


def build_tracker(cfg, checkpoint: str | None = None, device=None) -> Tracker:
    """A Tracker of the model `cfg` describes, on `device` ("cuda" by
    default), with random weights from seed 0 (build_model) or, given a
    reference checkpoint (.pth, .pth.tar or .bin: the network under 'net'),
    its weights through load_reference_state. The tokenizer's vocab is
    resolved against the repo and the pretrained directory
    (eval/environment.py::resolve_path); NL and NLBBOX modes warn when it
    is missing and then track with empty text, as the JAX package does."""
    model = build_model(cfg, device=device)
    if checkpoint:
        if not checkpoint.endswith((".pth", ".pth.tar", ".bin")):
            raise ValueError(f"{checkpoint!r}: the port loads reference checkpoints "
                             "(.pth, .pth.tar, .bin); trainer checkpoints come with training")
        unused = load_reference_state(model, load_torch_file(checkpoint))
        if unused:
            print(f"converter: {len(unused)} unused keys (e.g. {unused[:3]})")
    tok = None
    vocab = resolve_path(env_settings(), cfg.MODEL.BACKBONE.LANGUAGE.VOCAB_PATH)
    if vocab and os.path.exists(vocab):
        tok = BertTokenizer(vocab)
    elif cfg.TEST.MODE in ("NL", "NLBBOX"):
        print(f"WARNING: vocab not found at {vocab!r} — {cfg.TEST.MODE} "
              "mode will run with empty text")
    return Tracker(cfg, model, tokenizer=tok)
