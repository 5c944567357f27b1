"""Precise RoI Pooling (PrRoIPool) in plain PyTorch (port of
uvltrack_tpu/ops/prroi_pool.py; the vendored CUDA kernel of the reference,
lib/utils/PreciseRoIPooling/src/prroi_pooling_gpu_impl.cu:1-443): the exact
(quadrature-free) integral of the bilinearly interpolated feature surface
over each RoI bin, divided by the bin area, differentiable with respect to
both the features and the RoI coordinates.

The JAX function is plain XLA, not a Pallas kernel, and no path of either
package calls it. The bilinear interpolant is a tensor product of 1-D hat
bases, so the integral over a bin separates:

    integral = sum_ij F[i, j] * a_j * b_i,   a_j = integral over the bin of hat_j(x) dx

and each RoI pools with two products (B @ F @ A^T). The hat's running
integral is a piecewise quadratic, so autograd gives the coordinate
gradient the CUDA implementation writes by hand.
"""

from __future__ import annotations

import torch


def _hat_cumint(t: torch.Tensor) -> torch.Tensor:
    """H(t) = integral from -inf to t of max(0, 1 - |u|) du (piecewise quadratic, C^1)."""
    t = t.clamp(-1.0, 1.0)
    neg = (t + 1.0) ** 2 / 2.0
    pos = 1.0 - (1.0 - t) ** 2 / 2.0
    return torch.where(t <= 0, neg, pos)


def _axis_coeffs(starts: torch.Tensor, ends: torch.Tensor, size: int) -> torch.Tensor:
    """Integral of each grid hat basis over [starts_k, ends_k]: starts/ends
    (P,) bin boundaries in pixel coordinates (centers at integers) -> (P,
    size) coefficients."""
    idx = torch.arange(size, dtype=torch.float32, device=starts.device)[None, :]
    return _hat_cumint(ends[:, None] - idx) - _hat_cumint(starts[:, None] - idx)


def prroi_pool_one(feature: torch.Tensor, roi_xyxy: torch.Tensor, pooled_h: int,
                   pooled_w: int, spatial_scale: float = 1.0) -> torch.Tensor:
    """feature (H, W, C); roi_xyxy (4,) in input-image coordinates -> (ph, pw, C)."""
    h, w = feature.shape[0], feature.shape[1]
    x1, y1, x2, y2 = (roi_xyxy[i] * spatial_scale for i in range(4))
    # per-axis clamp like the CUDA kernel (prroi_pooling_gpu_impl.cu:175-176):
    # a doubly inverted roi (x2 < x1 and y2 < y1) pools to 0, not to the
    # average over the reversed box
    bin_w = (x2 - x1).clamp_min(0.0) / pooled_w
    bin_h = (y2 - y1).clamp_min(0.0) / pooled_h
    dev = feature.device
    px = torch.arange(pooled_w, dtype=torch.float32, device=dev)
    py = torch.arange(pooled_h, dtype=torch.float32, device=dev)
    a = _axis_coeffs(x1 + px * bin_w, x1 + (px + 1) * bin_w, w)  # (pw, W)
    b = _axis_coeffs(y1 + py * bin_h, y1 + (py + 1) * bin_h, h)  # (ph, H)
    integral = torch.einsum("pH,HWc,qW->pqc", b, feature.float(), a)
    area = (bin_w * bin_h).clamp_min(0.0)
    return torch.where(area > 0, integral / area.clamp_min(1e-12), torch.zeros_like(integral))


def prroi_pool(features: torch.Tensor, rois: torch.Tensor, pooled_h: int, pooled_w: int,
               spatial_scale: float = 1.0) -> torch.Tensor:
    """features (N, H, W, C) NHWC; rois (R, 5) = [batch_idx, x1, y1, x2, y2] in
    input-image coordinates -> (R, pooled_h, pooled_w, C): the PyTorch
    binding's contract (PreciseRoIPooling/pytorch/prroi_pool/prroi_pool.py)
    in NHWC, as the JAX function."""
    gathered = features[rois[:, 0].long()]  # (R, H, W, C)
    outs = [prroi_pool_one(f, r, pooled_h, pooled_w, spatial_scale)
            for f, r in zip(gathered, rois[:, 1:5])]
    if not outs:
        return features.new_zeros((0, pooled_h, pooled_w, features.shape[-1]), dtype=torch.float32)
    return torch.stack(outs)
