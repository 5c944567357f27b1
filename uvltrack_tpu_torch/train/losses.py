"""Training losses (port of uvltrack_tpu/train/losses.py): GIoU + L1 on the
selected box, the Gaussian-weighted focal loss on the cls map, the weighted
ignore-CE on the prompt-vs-search scores, and the per-layer aux contrastive
CE. Functional parity with the reference's GaussWeightedLoss
(lib/utils/box_ops.py:266-292) and UVLTrackActor.compute_losses
(lib/train/actors/uvltrack.py:111-177). Batched, fp32, static shapes.
Under data parallelism (parallel/dp.py) each loss is n x this rank's share
of the global batch's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.box_ops import box_cxcywh_to_xyxy, box_xywh_to_xyxy, giou_loss
from ..parallel.dp import current as current_dp


def gauss_weighted_focal_loss(pred: torch.Tensor, gt: torch.Tensor,
                              reduction: str = "mean", eps: float = 1e-12) -> torch.Tensor:
    """CenterNet-style focal loss of sigmoid maps against Gaussian targets
    (peak 1 at the centers); pred, gt (..., H, W) or flattened alike."""
    pred, gt = pred.float(), gt.float()
    pos = gt == 1.0
    neg_w = (1.0 - gt) ** 4
    pos_loss = torch.log(pred.clamp_min(eps)) * (1.0 - pred) ** 2
    neg_loss = torch.log((1.0 - pred).clamp_min(eps)) * pred ** 2 * neg_w
    total = torch.where(pos, pos_loss, neg_loss).sum()
    if reduction == "mean":
        return -total / pred.numel()
    dp = current_dp()  # data parallel: n x this rank's share of the global sum
    return -total if dp is None else -total * dp.size


def weighted_ce_ignore(logits: torch.Tensor, targets: torch.Tensor,
                       class_weights: torch.Tensor) -> torch.Tensor:
    """CrossEntropyLoss(weight=w, ignore_index=-1): logits (N, C), targets
    (N,) with -1 = ignore -> sum(w[y] * nll) / sum(w[y]) over kept rows."""
    valid = targets >= 0
    t = targets.clamp_min(0).long()
    nll = -torch.gather(F.log_softmax(logits.float(), dim=-1), 1, t[:, None])[:, 0]
    w = class_weights[t] * valid
    dp = current_dp()
    if dp is None:
        return (nll * w).sum() / w.sum().clamp_min(1e-12)
    # data parallel: n x this rank's share of the global ratio, over the
    # global denominator (no gradient flows through it)
    return (nll * w).sum() * dp.size / dp.all_reduce_(w.sum().detach()).clamp_min(1e-12)


def ce_mean(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Plain mean cross entropy (CrossEntropyLoss's default)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, 1, targets.long()[:, None])[:, 0].mean()


def _bilinear_sample_border(maps: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """(B, H, W) maps sampled at one normalized (x, y) point each in [-1, 1],
    border padding, align_corners=True (grid_sample's convention) -> (B,)."""
    b, h, w = maps.shape
    x = ((xy[:, 0] + 1.0) / 2.0 * (w - 1)).clamp(0.0, w - 1.0)
    y = ((xy[:, 1] + 1.0) / 2.0 * (h - 1)).clamp(0.0, h - 1.0)
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    x1, y1 = (x0 + 1).clamp_max(w - 1), (y0 + 1).clamp_max(h - 1)
    wx, wy = x - x0, y - y0
    bid = torch.arange(b, device=maps.device)
    return (maps[bid, y0, x0] * (1 - wx) * (1 - wy) + maps[bid, y0, x1] * wx * (1 - wy)
            + maps[bid, y1, x0] * (1 - wx) * wy + maps[bid, y1, x1] * wx * wy)


def aux_contrastive_loss(logits: torch.Tensor, gt_bbox_xywh: torch.Tensor,
                         num_neg: int = 9) -> torch.Tensor:
    """Per-layer backbone contrastive loss. logits (B, L, sz, sz) search-vs-
    token maps; gt (B, 4) normalized xywh. Positive: the bilinear sample at
    the gt center; negatives: the num_neg largest logits outside the gt box;
    CE with the positive as class 0."""
    b, n, sz, _ = logits.shape
    maps = logits.reshape(b * n, sz, sz).float()
    gt = box_xywh_to_xyxy(gt_bbox_xywh).clamp(0.0, 1.0).repeat_interleave(n, dim=0)
    ctr = (gt[:, :2] + gt[:, 2:]) / 2.0
    pos = _bilinear_sample_border(maps, ctr * 2.0 - 1.0)[:, None]
    cood = (torch.arange(sz, dtype=torch.float32, device=maps.device) + 0.5) / sz
    x_in = (cood[None, :] > gt[:, 0:1]) & (cood[None, :] < gt[:, 2:3])
    y_in = (cood[None, :] > gt[:, 1:2]) & (cood[None, :] < gt[:, 3:4])
    inside = (y_in[:, :, None] & x_in[:, None, :]).reshape(b * n, sz * sz)
    neg = torch.topk(maps.reshape(b * n, sz * sz) - 1e9 * inside, num_neg, dim=-1).values
    targets = torch.zeros(b * n, dtype=torch.long, device=maps.device)
    return ce_mean(torch.cat([pos, neg], dim=-1), targets)


def box_losses(pred_boxes: torch.Tensor, gt_bbox_xywh: torch.Tensor):
    """GIoU + L1 of the head's selected boxes (B, S, 4) cxcywh against the
    gt (B, 4) xywh, both normalized (the reference supervises the argmax
    box only, actors/uvltrack.py:146-155). Returns (giou, l1, mean IoU)."""
    s = pred_boxes.shape[1]
    pred = box_cxcywh_to_xyxy(pred_boxes.float()).reshape(-1, 4)
    gt = box_xywh_to_xyxy(gt_bbox_xywh.float()).clamp(0.0, 1.0)
    gt = gt[:, None, :].expand(-1, s, 4).reshape(-1, 4)
    gl, iou = giou_loss(pred, gt)
    return gl, (pred - gt).abs().mean(), iou.mean()
