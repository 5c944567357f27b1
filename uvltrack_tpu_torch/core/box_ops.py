"""Box conversions and clipping on torch tensors (port of
uvltrack_tpu/core/box_ops.py, the pieces the tracking step uses).

Conventions: boxes are (..., 4) tensors. `xywh` = top-left + size; `cxcywh` =
center + size; `xyxy` = corners. All ops broadcast over leading dims.
"""

from __future__ import annotations

import torch


def box_xywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    x, y, w, h = b.unbind(-1)
    return torch.stack([x, y, x + w, y + h], dim=-1)


def box_cxcywh_to_xywh(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, w, h], dim=-1)


def clip_box_xywh(box: torch.Tensor, h, w, margin: int = 0) -> torch.Tensor:
    """Clip an xywh box into the [0,W]x[0,H] image, keeping >= margin size
    (reference clip_box, lib/utils/box_ops.py:117-128)."""
    x1, y1, bw, bh = box.unbind(-1)
    x2, y2 = x1 + bw, y1 + bh
    x1 = x1.clamp(0, w - margin)
    x2 = x2.clamp(margin, w)
    y1 = y1.clamp(0, h - margin)
    y2 = y2.clamp(margin, h)
    bw = (x2 - x1).clamp_min(margin)
    bh = (y2 - y1).clamp_min(margin)
    return torch.stack([x1, y1, bw, bh], dim=-1)
