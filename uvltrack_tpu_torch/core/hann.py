"""Cosine (Hann) windows used as tracking motion priors (port of
uvltrack_tpu/core/hann.py). The live inference window is hanning2d_flat,
the reference tracker's numpy hanning outer product
(lib/test/tracker/uvltrack.py:64-68); hann1d/hann2d (lib/test/utils/hann.py:
6-17) are provided for completeness: no path calls them."""

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


def hann1d(sz: int, centered: bool = True, device=None) -> torch.Tensor:
    """Cosine window that is strictly positive in the interior (no zero ends)."""
    if centered:
        n = torch.arange(1, sz + 1, dtype=torch.float32, device=device)
        return 0.5 * (1.0 - torch.cos((2.0 * math.pi / (sz + 1)) * n))
    n = torch.arange(0, sz // 2 + 1, dtype=torch.float32, device=device)
    w = 0.5 * (1.0 + torch.cos((2.0 * math.pi / (sz + 2)) * n))
    return torch.cat([w, w[1:sz - sz // 2].flip(0)])


def hann2d(sz_y: int, sz_x: int, centered: bool = True, device=None) -> torch.Tensor:
    return hann1d(sz_y, centered, device)[:, None] * hann1d(sz_x, centered, device)[None, :]
