"""Cosine (Hann) window used as the tracking motion prior (port of
uvltrack_tpu/core/hann.py::hanning2d_flat; the reference tracker's numpy
hanning outer product, lib/test/tracker/uvltrack.py:64-68)."""

from __future__ import annotations

import math

import torch


def hanning(sz: int, device=None) -> torch.Tensor:
    """numpy.hanning equivalent: 0.5 - 0.5*cos(2*pi*n/(sz-1)); zero at ends."""
    if sz == 1:
        return torch.ones((1,), dtype=torch.float32, device=device)
    n = torch.arange(sz, dtype=torch.float32, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / (sz - 1))


def hanning2d_flat(sz: int, device=None) -> torch.Tensor:
    """Outer product of hanning(sz) with itself, flattened to (sz*sz,)."""
    w = hanning(sz, device)
    return torch.outer(w, w).reshape(-1)
