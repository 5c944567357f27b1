"""The training actor: forward pass and loss assembly (port of
uvltrack_tpu/train/actor.py; functional parity with UVLTrackActor,
lib/train/actors/uvltrack.py:14-177).

(n_frames, B) batches are flattened to n*B rows with the template repeated
per search frame; the context mask is the half-batch-rotated search-box
mask; the loss is GIoU (2.0) + L1 (5.0) on the selected box, the
Gaussian-weighted focal loss on the cls map, the weighted ignore-CE on the
prompt-vs-search scores and the per-layer aux contrastive CE.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.box_ops import box_cxcywh_to_xyxy, box_iou, box_xywh_to_xyxy
from ..core.geometry import anno2mask, cont_gt, rotate_half_batch
from ..parallel.dp import current as current_dp
from ..parallel.dp import scope
from .losses import (aux_contrastive_loss, box_losses, gauss_weighted_focal_loss,
                     weighted_ce_ignore)


def flatten_batch(batch: dict) -> dict:
    """(n_frames, B, ...) -> (n*B, ...) with the template repeated per frame
    (the reference collate's stack_dim=1 layout)."""
    n, b = batch["search_images"].shape[:2]

    def per_frame(x):  # (B, ...) or (n, B, ...) -> (n*B, ...)
        return x.reshape(n * b, *x.shape[2:]) if x.ndim == 3 else x.repeat(n, 1)

    return {
        "search_images": batch["search_images"].reshape(n * b, *batch["search_images"].shape[2:]),
        "search_anno": batch["search_anno"].reshape(n * b, 4),
        "search_cls": batch["search_cls"].reshape(n * b, *batch["search_cls"].shape[2:]),
        "template_images": batch["template_images"][0].repeat(n, 1, 1, 1),
        "template_anno": batch["template_anno"][0].repeat(n, 1),
        "text": per_frame(batch["text"]),
        "text_mask": per_frame(batch["text_mask"]),
        "flag": batch["flag"].reshape(1, b).repeat(n, 1).reshape(n * b),
    }


def loss_weights(cfg) -> dict:
    return {"giou": float(cfg.TRAIN.GIOU_WEIGHT), "l1": float(cfg.TRAIN.L1_WEIGHT),
            "cls": 1.0, "aux": float(cfg.TRAIN.AUX_WEIGHT),
            "cont": float(cfg.TRAIN.CONT_WEIGHT)}


def cont_class_weights(cfg, device=None) -> torch.Tensor:
    w = torch.tensor([cfg.DATA.SEARCH.FACTOR ** 2, cfg.TRAIN.CTR_RATIO ** 2],
                     dtype=torch.float32, device=device)
    return w / w.sum()


def forward_and_loss(model, batch: dict, cfg, train: bool = True,
                     generator: torch.Generator | None = None) -> Tuple[torch.Tensor, dict]:
    """The train forward (train=True: batch-statistics BN, whose running
    stats the model updates in place, and stochastic depth from `generator`)
    and the weighted loss. Returns (loss, metrics), the metrics as 0-d
    tensors; train=False adds Acc@0.5.

    batch (frame-major tensors on the model's device): template_images
    (1,B,Ht,Wt,3), search_images (n,B,Hs,Ws,3), template_anno (1,B,4),
    search_anno (n,B,4), search_cls (n,B,hc,wc), text and text_mask (B,Nt)
    or (n,B,Nt), flag (B,) or (B,1).

    Under data parallelism (parallel/dp.py, the rows this rank holds of the
    global batch) the loss is n x this rank's share of the global batch's,
    and the rows follow the frame-major flatten of n search frames."""
    with scope(current_dp(), frames=batch["search_images"].shape[0]):
        return _forward_and_loss(model, batch, cfg, train, generator)


def _forward_and_loss(model, batch, cfg, train, generator):
    fb = flatten_batch(batch)
    wt = fb["template_images"].shape[2] // 16
    ws = fb["search_images"].shape[2] // 16
    template_mask = anno2mask(fb["template_anno"], wt)
    context_mask = rotate_half_batch(anno2mask(fb["search_anno"], ws))
    out = model(fb["template_images"], fb["search_images"], fb["text"], fb["text_mask"],
                template_mask, context_mask, fb["flag"], train=train, generator=generator)

    w = loss_weights(cfg)
    gt_bbox = fb["search_anno"].float()
    gl, l1, mean_iou = box_losses(out["pred_boxes"], gt_bbox)
    cls_loss = gauss_weighted_focal_loss(
        out["cls_score"], fb["search_cls"].reshape(out["cls_score"].shape),
        reduction=cfg.TRAIN.REDUCTION)
    gt_cont = cont_gt(gt_bbox, ws, float(cfg.TRAIN.CTR_RATIO))
    cont_loss = weighted_ce_ignore(out["cont_score"].reshape(-1, 2), gt_cont.reshape(-1),
                                   cont_class_weights(cfg, gt_bbox.device))
    aux_loss = torch.zeros((), dtype=torch.float32, device=gt_bbox.device)
    if w["aux"] > 0 and "logits" in out:
        aux_loss = aux_contrastive_loss(out["logits"], gt_bbox)
    loss = (w["giou"] * gl + w["l1"] * l1 + w["cls"] * cls_loss
            + w["aux"] * aux_loss + w["cont"] * cont_loss)
    metrics = {"Loss/total": loss, "Loss/giou": gl, "Loss/l1": l1, "Loss/cls": cls_loss,
               "Loss/aux": aux_loss, "Loss/cont": cont_loss, "IoU": mean_iou}
    if not train:  # validation accuracy at IoU 0.5 (actors/uvltrack.py:174-176)
        pred = box_cxcywh_to_xyxy(out["pred_boxes"][:, 0].float())
        best_iou, _ = box_iou(pred, box_xywh_to_xyxy(gt_bbox).clamp(0.0, 1.0))
        metrics["Acc@0.5"] = (best_iou > 0.5).float().mean()
    return loss, {k: v.detach() for k, v in metrics.items()}
