"""Host-side (numpy/cv2) crop, letterbox, and label utilities for the
training data pipeline.

Functional parity with lib/train/data/processing_utils.py: sample_target
(:159-243), jittered_center_crop (:272-300), transform_image_to_crop
(:246-269), grounding_resize (:60-141), generate_cls_label (:143-157).
Training augmentation runs on dataloader workers, so this is deliberately
numpy/cv2 (the *inference* path has torch equivalents in track/pipeline.py).

The port's own copy of uvltrack_tpu/data/processing_utils.py (framework-free; the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import cv2
import numpy as np


def sample_target_np(im: np.ndarray, target_bb, search_area_factor: float,
                     output_sz: Optional[int] = None):
    """Square crop of area factor^2*wh centered on an xywh box; constant pad.

    Returns (crop, resize_factor, att_mask) with att_mask=1 on padding.
    """
    x, y, w, h = [float(v) for v in target_bb]
    crop_sz = math.ceil(math.sqrt(w * h) * search_area_factor)
    if crop_sz < 1:
        raise ValueError("Too small bounding box.")

    x1 = int(round(x + 0.5 * w - crop_sz * 0.5))
    x2 = int(x1 + crop_sz)
    y1 = int(round(y + 0.5 * h - crop_sz * 0.5))
    y2 = int(y1 + crop_sz)

    x1_pad = max(0, -x1)
    x2_pad = max(x2 - im.shape[1] + 1, 0)
    y1_pad = max(0, -y1)
    y2_pad = max(y2 - im.shape[0] + 1, 0)

    crop = im[y1 + y1_pad: y2 - y2_pad, x1 + x1_pad: x2 - x2_pad]
    crop = cv2.copyMakeBorder(crop, y1_pad, y2_pad, x1_pad, x2_pad,
                              cv2.BORDER_CONSTANT)
    h_c, w_c = crop.shape[:2]
    # Mask is 1 only on the pad bands. Building it as full-frame np.ones and
    # resizing float64 was 42% of loader sample time (profiled, 720p LaSOT);
    # interior crops (the common case) skip the mask work entirely, padded
    # crops touch only the bands of a zeros (calloc) float32 buffer.
    # bool-cast equivalence with the old ones-based float64 path: bilinear
    # weights are non-negative, so a resized pixel is zero iff every
    # contributing source pixel is zero, in f32 as in f64.
    has_pad = bool(x1_pad or x2_pad or y1_pad or y2_pad)
    if has_pad:
        att = np.zeros((h_c, w_c), np.float32)
        if y1_pad:
            att[:y1_pad] = 1.0
        if y2_pad:
            att[h_c - y2_pad:] = 1.0
        if x1_pad:
            att[:, :x1_pad] = 1.0
        if x2_pad:
            att[:, w_c - x2_pad:] = 1.0

    if output_sz is None:
        return crop, 1.0, (att.astype(bool) if has_pad
                           else np.zeros((h_c, w_c), bool))
    resize_factor = output_sz / crop_sz
    crop = cv2.resize(crop, (output_sz, output_sz))
    if not has_pad:
        return crop, resize_factor, np.zeros((output_sz, output_sz), bool)
    att = cv2.resize(att, (output_sz, output_sz)).astype(bool)
    return crop, resize_factor, att


def transform_image_to_crop(box_in: np.ndarray, box_extract: np.ndarray,
                            resize_factor: float, crop_sz: float,
                            normalize: bool = False) -> np.ndarray:
    """Map an xywh box from image coords into crop coords."""
    box_in = np.asarray(box_in, np.float64)
    box_extract = np.asarray(box_extract, np.float64)
    extract_center = box_extract[:2] + 0.5 * box_extract[2:]
    in_center = box_in[:2] + 0.5 * box_in[2:]
    out_center = (crop_sz - 1) / 2 + (in_center - extract_center) * resize_factor
    out_wh = box_in[2:] * resize_factor
    out = np.concatenate([out_center - 0.5 * out_wh, out_wh])
    return out / crop_sz if normalize else out


def jittered_center_crop(frames: List[np.ndarray], box_extract: List[np.ndarray],
                         box_gt: List[np.ndarray], search_area_factor: float,
                         output_sz: int):
    """Crop each frame around its (jittered) box_extract; remap box_gt into
    crop coords (normalized). Returns (crops, norm_boxes, att_masks)."""
    crops, boxes, atts = [], [], []
    for f, be, bg in zip(frames, box_extract, box_gt):
        crop, rf, att = sample_target_np(f, be, search_area_factor, output_sz)
        crops.append(crop)
        atts.append(att)
        boxes.append(transform_image_to_crop(bg, be, rf, output_sz, normalize=True))
    return crops, boxes, atts


def grounding_resize_np(im: np.ndarray, output_sz: int, bbox) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Aspect-preserving resize + center zero-pad (letterbox).

    Returns (padded image, normalized xywh box, att_mask with 1 on padding).
    """
    h, w = im.shape[:2]
    if w > h:
        ow = output_sz
        oh = int(output_sz * h / w)
    else:
        oh = output_sz
        ow = int(output_sz * w / h)
    img = cv2.resize(im, (ow, oh))

    y1_pad = int((output_sz - oh) / 2)
    x1_pad = int((output_sz - ow) / 2)
    if 2 * y1_pad + oh != output_sz:
        y1_pad += 1
    if 2 * x1_pad + ow != output_sz:
        x1_pad += 1
    y2_pad = output_sz - oh - y1_pad
    x2_pad = output_sz - ow - x1_pad
    padded = cv2.copyMakeBorder(img, y1_pad, y2_pad, x1_pad, x2_pad,
                                cv2.BORDER_CONSTANT, value=(0, 0, 0))

    box = np.asarray(bbox, np.float64).copy()
    box[0] = box[0] * ow / w + x1_pad
    box[1] = box[1] * oh / h + y1_pad
    box[2] = box[2] * ow / w
    box[3] = box[3] * oh / h
    box /= output_sz

    att = np.ones((output_sz, output_sz))
    end_x = -x2_pad if x2_pad else None
    end_y = -y2_pad if y2_pad else None
    att[y1_pad:end_y, x1_pad:end_x] = 0
    return padded, box, att


def gaussian_radius_np(h: float, w: float, min_overlap: float) -> float:
    b1 = h + w
    c1 = w * h * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 - math.sqrt(max(b1 ** 2 - 4 * c1, 0.0))) / 2
    b2 = 2 * (h + w)
    c2 = (1 - min_overlap) * w * h
    r2 = (b2 - math.sqrt(max(b2 ** 2 - 16 * c2, 0.0))) / 8
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (h + w)
    c3 = (min_overlap - 1) * w * h
    r3 = (b3 + math.sqrt(max(b3 ** 2 - 4 * a3 * c3, 0.0))) / (2 * a3)
    return min(r1, r2, r3)


def generate_cls_label_np(bbox_norm, out_size: int, gaussian_iou: float = 0.7,
                          dynamic: bool = False) -> np.ndarray:
    """One normalized xywh box -> (out,out) Gaussian heatmap (CenterNet draw)."""
    x, y, w, h = np.asarray(bbox_norm, np.float64) * out_size
    cx, cy = int(x + w / 2), int(y + h / 2)
    radius = max(0, int(gaussian_radius_np(h, w, gaussian_iou))) if dynamic else 2
    diameter = 2 * radius + 1
    sigma = diameter / 6
    m = (diameter - 1) / 2
    yy, xx = np.ogrid[-m: m + 1, -m: m + 1]
    g = np.exp(-(xx * xx + yy * yy) / (2 * sigma * sigma))
    g[g < np.finfo(g.dtype).eps * g.max()] = 0
    heat = np.zeros((out_size, out_size))
    left, right = min(cx, radius), min(out_size - cx, radius + 1)
    top, bottom = min(cy, radius), min(out_size - cy, radius + 1)
    if right > -left and bottom > -top and 0 <= cy < out_size + radius and 0 <= cx < out_size + radius:
        ys = slice(max(cy - top, 0), max(cy + bottom, 0))
        xs = slice(max(cx - left, 0), max(cx + right, 0))
        gy = slice(radius - top, radius + bottom)
        gx = slice(radius - left, radius + right)
        if heat[ys, xs].shape == g[gy, gx].shape and heat[ys, xs].size:
            np.maximum(heat[ys, xs], g[gy, gx], out=heat[ys, xs])
    return heat


def perturb_box(box: np.ndarray, min_iou: float = 0.5,
                sigma_factor: float = 0.1,
                rng: Optional[np.random.Generator] = None) -> Tuple[np.ndarray, float]:
    """Randomly perturb an xywh box s.t. IoU with the original >= min_iou."""
    rng = rng or np.random.default_rng()
    from ..eval.metrics import calc_iou_overlap

    box = np.asarray(box, np.float64)
    for _ in range(100):
        c_x = box[0] + 0.5 * box[2]
        c_y = box[1] + 0.5 * box[3]
        sf = sigma_factor * np.sqrt(box[2] * box[3])
        c_x_per = rng.normal(c_x, sf)
        c_y_per = rng.normal(c_y, sf)
        w_per = max(1.0, rng.normal(box[2], sigma_factor * box[2]))
        h_per = max(1.0, rng.normal(box[3], sigma_factor * box[3]))
        box_per = np.array([c_x_per - 0.5 * w_per, c_y_per - 0.5 * h_per,
                            w_per, h_per])
        iou = calc_iou_overlap(box_per[None], box[None])[0]
        if iou > min_iou:
            return box_per, iou
    return box.copy(), 1.0
