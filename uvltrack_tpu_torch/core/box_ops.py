"""Box conversions, IoU/GIoU and clipping on torch tensors (port of
uvltrack_tpu/core/box_ops.py: the pieces the tracking step and the training
losses use; reference lib/utils/box_ops.py).

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


def box_xywh_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x, y, w, h = b.unbind(-1)
    return torch.stack([x + w / 2, y + h / 2, w, h], dim=-1)


def box_xywh_to_cxcywh_scale(b: torch.Tensor, f: float = 1.0) -> torch.Tensor:
    """xywh -> cxcywh with width/height scaled by `f` about the center."""
    x, y, w, h = b.unbind(-1)
    return torch.stack([x + w / 2, y + h / 2, w * f, h * f], dim=-1)


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def box_xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)


def box_area(b: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes; returns (...)."""
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Elementwise IoU of paired xyxy boxes (N,4)x(N,4) -> (N,), plus union."""
    area1, area2 = box_area(boxes1), box_area(boxes2)
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    return inter / union.clamp_min(1e-9), union


def generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Elementwise GIoU of paired xyxy boxes. Returns (giou, iou); degenerate
    boxes give finite values (the training loss clamps the gt)."""
    iou, union = box_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp_min(0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area.clamp_min(1e-9), iou


def giou_loss(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Mean (1 - GIoU) over paired xyxy boxes; also returns the per-pair IoU."""
    giou, iou = generalized_box_iou(boxes1, boxes2)
    return (1.0 - giou).mean(), iou


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
