"""Crop geometry, token masks and box mapping on torch tensors (port of
uvltrack_tpu/core/geometry.py). Every function stays on the tensors' device:
the tracking step never reads a box back to the host.

- anno2mask     (lib/test/tracker/uvltrack.py:183-194)
- rotate_half_batch (the head's prompt mining without a prompt)
- cont_gt       (the training actor's contrastive target)
- crop_params / crop_box_normalized / map_box_back
                (lib/train/data/processing_utils.py:159-193,
                 lib/test/tracker/uvltrack.py:167-173)
"""

from __future__ import annotations

import torch

from ..parallel.dp import current as current_dp
from .box_ops import (box_cxcywh_to_xyxy, box_xywh_to_cxcywh,
                      box_xywh_to_cxcywh_scale, box_xywh_to_xyxy)


def anno2mask(boxes_xywh: torch.Tensor, size: int) -> torch.Tensor:
    """Rasterize normalized xywh boxes to (B, size*size) boolean token masks.

    A grid cell is inside if its center (i+0.5) lies strictly inside the box
    scaled to grid units; the cell containing the box center is always set.
    """
    b = boxes_xywh.shape[0]
    bx = box_xywh_to_xyxy(boxes_xywh) * size  # (B,4)
    cood = torch.arange(size, dtype=boxes_xywh.dtype,
                        device=boxes_xywh.device) + 0.5
    x_in = (cood[None, :] > bx[:, 0:1]) & (cood[None, :] < bx[:, 2:3])
    y_in = (cood[None, :] > bx[:, 1:2]) & (cood[None, :] < bx[:, 3:4])
    mask = y_in[:, :, None] & x_in[:, None, :]  # (B,h,w)
    cx = torch.floor((bx[:, 0] + bx[:, 2]) / 2).to(torch.int32).clamp(0, size - 1)
    cy = torch.floor((bx[:, 1] + bx[:, 3]) / 2).to(torch.int32).clamp(0, size - 1)
    idx = torch.arange(size, device=boxes_xywh.device)
    ctr = (idx[None, :, None] == cy[:, None, None]) & (
        idx[None, None, :] == cx[:, None, None])
    return (mask | ctr).reshape(b, size * size)


def rotate_half_batch(x: torch.Tensor) -> torch.Tensor:
    """Swap the two halves of the batch dim (context shuffling of the
    prompt-mining forward); batch 1 is left as it is. Under data
    parallelism the halves are the global batch's: with an even number of
    search frames in the frame-major flatten each row pairs with a row of
    its own sample, on this rank, and the local swap is the global one;
    with an odd number the rows are exchanged (parallel/dp.py)."""
    dp = current_dp()
    if dp is not None and dp.frames % 2:
        return dp.rotate_half_batch(x)
    h = x.shape[0] // 2
    return torch.cat([x[h:], x[:h]], dim=0)


def _inside(bx: torch.Tensor, size: int) -> torch.Tensor:
    """(B, 4) xyxy boxes in grid units -> (B, size, size): cell centers
    strictly inside."""
    cood = torch.arange(size, dtype=bx.dtype, device=bx.device) + 0.5
    x_in = (cood[None, :] > bx[:, 0:1]) & (cood[None, :] < bx[:, 2:3])
    y_in = (cood[None, :] > bx[:, 1:2]) & (cood[None, :] < bx[:, 3:4])
    return y_in[:, :, None] & x_in[:, None, :]


def cont_gt(boxes_xywh: torch.Tensor, size: int, ctr_ratio: float = 0.75) -> torch.Tensor:
    """Per-cell contrastive target (B, size*size) int32: 0 = center region
    (the box shrunk by ctr_ratio about its center, plus the center cell),
    -1 = ignore (inside the box, outside the center region), 1 = outside."""
    b = boxes_xywh.shape[0]
    bx_c = box_cxcywh_to_xyxy(box_xywh_to_cxcywh_scale(boxes_xywh, ctr_ratio)) * float(size)
    cx = torch.floor((bx_c[:, 0] + bx_c[:, 2]) / 2).to(torch.int32).clamp(0, size - 1)
    cy = torch.floor((bx_c[:, 1] + bx_c[:, 3]) / 2).to(torch.int32).clamp(0, size - 1)
    idx = torch.arange(size, device=boxes_xywh.device)
    ctr = (idx[None, :, None] == cy[:, None, None]) & (idx[None, None, :] == cx[:, None, None])
    mask_c = _inside(bx_c, size) | ctr
    bx_t = box_cxcywh_to_xyxy(box_xywh_to_cxcywh(boxes_xywh)) * float(size)
    mask_t = 1 - 2 * _inside(bx_t, size).to(torch.int32)
    return torch.where(mask_c, 0, mask_t).to(torch.int32).reshape(b, size * size)


def crop_params(box_xywh: torch.Tensor, search_area_factor: float,
                output_sz: int):
    """The square crop window around an xywh box, with the reference's
    rounding: crop_sz = ceil(sqrt(w*h)*factor); corner = round-half-even of
    center - crop/2 (torch.round, like jnp.round). Returns device tensors
    (x1, y1, crop_sz) int32 and resize_factor fp32."""
    x, y, w, h = box_xywh.unbind(-1)
    crop_sz = torch.ceil(torch.sqrt(w * h) * search_area_factor)
    # degenerate boxes clamp instead of dividing by zero (the reference
    # raises 'Too small bounding box.'; the device step cannot)
    crop_sz = crop_sz.clamp_min(1.0)
    x1 = torch.floor(torch.round(x + 0.5 * w - crop_sz * 0.5)).to(torch.int32)
    y1 = torch.floor(torch.round(y + 0.5 * h - crop_sz * 0.5)).to(torch.int32)
    resize_factor = output_sz / crop_sz
    return x1, y1, crop_sz.to(torch.int32), resize_factor


def crop_box_normalized(box_xywh: torch.Tensor,
                        search_area_factor: float) -> torch.Tensor:
    """Crop-relative normalized xywh of the centered target box
    (sample_target's returned bbox, processing_utils.py:215)."""
    w, h = box_xywh[..., 2], box_xywh[..., 3]
    crop_sz = torch.ceil(torch.sqrt(w * h) * search_area_factor)
    return torch.stack([0.5 - w / crop_sz / 2, 0.5 - h / crop_sz / 2,
                        w / crop_sz, h / crop_sz], dim=-1)


def map_box_back(pred_cxcywh_crop: torch.Tensor, prev_xywh: torch.Tensor,
                 resize_factor: torch.Tensor, search_size: int) -> torch.Tensor:
    """Map a predicted cxcywh box in crop pixels back to image xywh."""
    cx_prev = prev_xywh[..., 0] + 0.5 * prev_xywh[..., 2]
    cy_prev = prev_xywh[..., 1] + 0.5 * prev_xywh[..., 3]
    half_side = 0.5 * search_size / resize_factor
    cx = pred_cxcywh_crop[..., 0] + (cx_prev - half_side)
    cy = pred_cxcywh_crop[..., 1] + (cy_prev - half_side)
    w = pred_cxcywh_crop[..., 2]
    h = pred_cxcywh_crop[..., 3]
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, w, h], dim=-1)
