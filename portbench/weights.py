"""Seeded weights of a configuration, made on the device in a few large
draws, in the dtype they are served in. The benchmark makes them; the port
and the reference each get the same values (the reference regenerates them
from the seed after the window, so the window's memory holds one copy).

Distributions (random weights: speed and agreement are measured, not
accuracy): Linear weights N(0, 2 / (fan_in + fan_out)), conv weights
N(0, 1 / fan_in), tokens, embedding tables and position embeddings
N(0, 0.02^2), the prompter's query embeddings N(0, 1), biases and running
means N(0, 0.02^2), norm scales 1 + N(0, 0.02^2), running variances 1,
logit scales log(1 / 0.07)."""

from __future__ import annotations

import math

import torch

CHUNK = 1 << 25  # elements a draw at most (128 MB of fp32)


def seed64(seed: int) -> int:
    """Any whole number -> a generator seed in [0, 2**64)."""
    return int(seed) % (1 << 64)


def _std(shape, kind: str) -> float:
    if kind == "linear":
        return math.sqrt(2.0 / (shape[0] + shape[1]))
    if kind == "conv":
        return 1.0 / math.sqrt(math.prod(shape[1:]))
    return {"token": 0.02, "query": 1.0, "bias": 0.02, "norm": 0.02}[kind]


def make_weights(specs, seed: int, device, served: torch.dtype) -> dict:
    """{name: tensor} for `specs` ((name, shape, kind), reference/model.py's
    param_specs): tensors of two or more dimensions in `served`, the rest in
    float32 (num_batches_tracked in int64). The draws come from one
    torch.Generator on `device`, CHUNK elements at a time, in spec order."""
    g = torch.Generator(device=device)
    g.manual_seed(seed64(seed))
    out = {}
    drawn = [s for s in specs if s[2] in ("linear", "conv", "token", "query", "bias", "norm")]
    i = 0
    while i < len(drawn):
        j, n = i, 0
        while j < len(drawn) and (n == 0 or n + math.prod(drawn[j][1]) <= CHUNK):
            n += math.prod(drawn[j][1])
            j += 1
        flat = torch.randn(n, generator=g, device=device)
        at = 0
        for name, shape, kind in drawn[i:j]:
            k = math.prod(shape)
            v = flat[at:at + k].view(shape) * _std(shape, kind)
            at += k
            if kind == "norm":
                v = v + 1.0
            out[name] = v.to(served) if len(shape) >= 2 else v.clone()
        i = j
    for name, shape, kind in specs:
        if kind == "logit":
            out[name] = torch.full(shape, math.log(1 / 0.07), device=device)
        elif kind == "var":
            out[name] = torch.ones(shape, device=device)
        elif kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
    return out


def reference_weights(specs, seed: int, device, served: torch.dtype) -> dict:
    """The same values as make_weights, all in float32 (the reference's)."""
    return {k: (v.float() if v.is_floating_point() else v)
            for k, v in make_weights(specs, seed, device, served).items()}
