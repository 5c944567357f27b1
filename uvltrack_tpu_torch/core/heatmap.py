"""Gaussian classification-label heatmaps, CenterNet style (port of
uvltrack_tpu/core/heatmap.py; reference lib/train/data/processing_utils.py:
15-57,143-157): a Gaussian of sigma (2r+1)/6 drawn in a (2r+1)^2 window at
the integer box center; the radius is fixed (2) or CenterNet's
gaussian_radius of the box size.

numpy in, numpy out: the labels are made on the host with the synthetic
batch (data/synthetic.py), in fp32 as the JAX package makes them.
"""

from __future__ import annotations

import numpy as np

_EPS64 = float(np.finfo(np.float64).eps)


def gaussian_radius(height, width, min_overlap: float):
    """CenterNet gaussian radius, elementwise over broadcastable h/w arrays."""
    a1 = 1.0
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 - np.sqrt(np.maximum(b1 ** 2 - 4 * a1 * c1, 0.0))) / (2 * a1)

    a2 = 4.0
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 - np.sqrt(np.maximum(b2 ** 2 - 4 * a2 * c2, 0.0))) / (2 * a2)

    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + np.sqrt(np.maximum(b3 ** 2 - 4 * a3 * c3, 0.0))) / (2 * a3)
    return np.minimum(np.minimum(r1, r2), r3)


def generate_cls_label(boxes_xywh: np.ndarray, out_size: int,
                       gaussian_iou: float = 0.7, dynamic: bool = False) -> np.ndarray:
    """(B, 4) normalized xywh -> (B, out_size, out_size) fp32 Gaussian maps.

    The center is the truncated box center in grid units; the Gaussian is
    non-zero only inside the radius window (|dx|, |dy| <= r) and where it is
    at least float64-eps, as the reference's draw_gaussian."""
    bx = np.asarray(boxes_xywh, np.float32) * np.float32(out_size)
    x, y, w, h = bx[:, 0], bx[:, 1], bx[:, 2], bx[:, 3]
    cx = (x + w / 2).astype(np.float32).astype(np.int32)
    cy = (y + h / 2).astype(np.float32).astype(np.int32)
    if dynamic:
        radius = np.maximum(0, gaussian_radius(h, w, gaussian_iou).astype(np.int32))
    else:
        radius = np.full(bx.shape[:1], 2, np.int32)
    sigma = (2.0 * radius.astype(np.float32) + 1.0) / np.float32(6.0)
    ii = np.arange(out_size, dtype=np.int32)
    dy = ii[None, :, None] - cy[:, None, None]
    dx = ii[None, None, :] - cx[:, None, None]
    d2 = dx.astype(np.float32) ** 2 + dy.astype(np.float32) ** 2
    g = np.exp(-d2 / (np.float32(2.0) * sigma[:, None, None] ** 2)).astype(np.float32)
    window = (np.abs(dy) <= radius[:, None, None]) & (np.abs(dx) <= radius[:, None, None])
    return np.where(window & (g >= _EPS64), g, np.float32(0.0)).astype(np.float32)
