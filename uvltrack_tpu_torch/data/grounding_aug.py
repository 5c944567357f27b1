"""Grounding-specific train-time augmentation.

Behavioral parity with lib/train/data/processing_utils_grounding2.py —
the live grounding augmentation chain (grounding_resize, :347-516):
per-output-size resize menus, an IoU-checked RandomSizeCrop (:112-138),
PIL-ImageEnhance-semantics ColorJitter (:156-216), horizontal flip with
left<->right phrase rewriting (:140-153), and a random-translate letterbox
(:455-480). All numpy/cv2 on uint8 RGB, used inside dataloader workers —
host-side work, so fidelity to the reference distributions is the goal here
(the device pipeline in track/pipeline.py handles the inference-time path).

Boxes are xyxy float inside this module (the reference converts at entry).

The port's own copy of uvltrack_tpu/data/grounding_aug.py (framework-free; the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

import cv2
import numpy as np

DIRECTION_WORDS = ("left", "right", "top", "bottom", "middle")
# BERT ids [2187, 2157, 2327, 3953, 2690] in the reference (processing.py:188)


def has_directions(phrase: str) -> bool:
    words = set(re.findall(r"[a-z]+", phrase.lower()))
    return any(w in words for w in DIRECTION_WORDS)


def flip_phrase(phrase: str) -> str:
    """Swap 'left' and 'right' words — the string-level equivalent of the
    reference's token-id swap 2187<->2157 (grounding2.py:148-151)."""

    def swap(m):
        # lowercase before comparing — the IGNORECASE match also catches
        # 'Left'/'LEFT', which must still swap (the reference swaps BERT
        # token ids post-lowercasing, so it cannot mis-swap)
        return "right" if m.group(0).lower() == "left" else "left"

    return re.sub(r"\b(left|right)\b", swap, phrase, flags=re.IGNORECASE)


def size_menus(output_sz: int) -> Tuple[List[int], List[int], Tuple[int, int]]:
    """(long-side menu, short-side menu, (min,max) crop sizes) per output
    size — the explicit tables of grounding2.py:383-396; other sizes use the
    384-row formulas."""
    if output_sz == 384:
        sizes1 = [384 - 16 * i for i in range(384 // 48)]
        sizes2 = [384 - 32 * i for i in range(1, 384 // 64 - 1)]
        return sizes1, sizes2, (256, 360)
    if output_sz == 256:
        return [180, 210, 240], [186, 192, 208, 224, 240], (186, 240)
    if output_sz == 320:
        return [172, 236, 300], [180, 210, 240, 270, 300], (180, 300)
    sizes1 = [output_sz - 16 * i for i in range(max(output_sz // 48, 1))]
    sizes2 = [output_sz - 32 * i for i in range(1, max(output_sz // 64 - 1, 2))]
    return sizes1, sizes2, (output_sz * 2 // 3, output_sz * 15 // 16)


def random_resize(sizes: Sequence[int], im: np.ndarray, box: np.ndarray,
                  rng: np.random.Generator, resize_long_side: bool = True
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Scale so the chosen side hits a random menu entry (grounding2.py:71-84).
    Box scales by the *rounded* ratios, like the reference."""
    choose = max if resize_long_side else min
    size = int(sizes[int(rng.integers(0, len(sizes)))])
    h, w = im.shape[:2]
    ratio = float(size) / choose(h, w)
    nh, nw = max(1, round(h * ratio)), max(1, round(w * ratio))
    out = cv2.resize(im, (nw, nh), interpolation=cv2.INTER_LINEAR)
    return out, box * np.array([nw / w, nh / h, nw / w, nh / h])


def _box_iou_single(a: np.ndarray, b: np.ndarray) -> float:
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, ix2 - ix1) * max(0.0, iy2 - iy1)
    ua = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter)
    return inter / ua if ua > 0 else 0.0


def random_size_crop(im: np.ndarray, box: np.ndarray, rng: np.random.Generator,
                     min_size: int, max_size: int, max_cnt: int = 20,
                     iou_thres: float = 0.9) -> Tuple[np.ndarray, np.ndarray]:
    """RandomSizeCrop with the reference's retention check
    (grounding2.py:112-138): propose a crop, clamp the box into it, accept
    only if IoU(clamped, original) >= iou_thres; otherwise retry up to
    max_cnt times and fall back to no crop."""
    h, w = im.shape[:2]
    for _ in range(max_cnt):
        tw = int(rng.integers(min_size, max(min(w, max_size), min_size) + 1))
        th = int(rng.integers(min_size, max(min(h, max_size), min_size) + 1))
        tw, th = min(tw, w), min(th, h)
        j = int(rng.integers(0, w - tw + 1))
        i = int(rng.integers(0, h - th + 1))
        shifted = box - np.array([j, i, j, i], np.float64)
        clamped = np.clip(shifted, 0.0, None)
        clamped = np.minimum(clamped.reshape(2, 2), np.array([tw, th], np.float64)).reshape(-1)
        restored = clamped + np.array([j, i, j, i], np.float64)
        if _box_iou_single(restored, box) >= iou_thres:
            return im[i:i + th, j:j + tw].copy(), clamped
    return im, box.copy()


def _pil_l_channel(im: np.ndarray) -> np.ndarray:
    """PIL 'L' conversion (ITU-R 601-2, truncating like PIL)."""
    f = im.astype(np.float64)
    return np.floor(f[..., 0] * 299 / 1000 + f[..., 1] * 587 / 1000
                    + f[..., 2] * 114 / 1000)


def _blend(degenerate: np.ndarray, im: np.ndarray, factor: float) -> np.ndarray:
    out = degenerate + factor * (im.astype(np.float64) - degenerate)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def color_jitter(im: np.ndarray, rng: np.random.Generator,
                 brightness: float = 0.4, contrast: float = 0.4,
                 saturation: float = 0.4) -> np.ndarray:
    """ColorJitter with PIL ImageEnhance semantics (grounding2.py:156-216):
    with p=0.8, apply Brightness/Contrast/Color in a random order, each with
    a factor uniform in [1-a, 1+a]; each enhancer blends the image with its
    degenerate (black / solid-mean-gray / per-pixel grayscale)."""
    if rng.random() >= 0.8:
        return im
    out = im
    for which in rng.permutation(3):
        if which == 0:
            f = rng.uniform(1 - brightness, 1 + brightness)
            out = _blend(np.zeros_like(out, np.float64), out, f)
        elif which == 1:
            f = rng.uniform(1 - contrast, 1 + contrast)
            mean = np.floor(_pil_l_channel(out).mean() + 0.5)
            out = _blend(np.full_like(out, mean, np.float64), out, f)
        else:
            f = rng.uniform(1 - saturation, 1 + saturation)
            gray = _pil_l_channel(out)[..., None].repeat(3, axis=2)
            out = _blend(gray, out, f)
    return out


def random_horizontal_flip(im: np.ndarray, phrase: str, box: np.ndarray,
                           rng: np.random.Generator
                           ) -> Tuple[np.ndarray, str, np.ndarray]:
    """p=0.5 flip; box mirrored, left<->right swapped in the phrase
    (grounding2.py:140-153). Direction words do NOT suppress the flip in the
    reference — they only pin the resize branch."""
    if rng.random() < 0.5:
        im = im[:, ::-1].copy()
        w = im.shape[1]
        box = np.array([w - box[2], box[1], w - box[0], box[3]])
        phrase = flip_phrase(phrase)
    return im, phrase, box


def random_translate_letterbox(im: np.ndarray, box: np.ndarray, output_sz: int,
                               rng: Optional[np.random.Generator]
                               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Zero-pad the (already <= output_sz) image onto the canvas at a random
    offset (grounding2.py:455-480; centered when rng is None). Returns
    (canvas, normalized xywh box, att_mask with 1 on padding)."""
    new_h, new_w = im.shape[:2]
    dh, dw = output_sz - new_h, output_sz - new_w
    if rng is None:
        y1_pad, x1_pad = dh // 2, dw // 2
    else:
        x1_pad = int(rng.integers(0, dw + 1))
        y1_pad = int(rng.integers(0, dh + 1))
    y2_pad = output_sz - y1_pad - new_h
    x2_pad = output_sz - x1_pad - new_w
    canvas = np.zeros((output_sz, output_sz, 3), im.dtype)
    canvas[y1_pad:y1_pad + new_h, x1_pad:x1_pad + new_w] = im
    xywh = np.array([box[0] + x1_pad, box[1] + y1_pad,
                     box[2] - box[0], box[3] - box[1]]) / output_sz
    att = np.ones((output_sz, output_sz))
    att[y1_pad:y1_pad + new_h, x1_pad:x1_pad + new_w] = 0
    return canvas, xywh, att


def grounding_resize_train(im: np.ndarray, output_sz: int, bbox_xywh: np.ndarray,
                           phrase: str, rng: np.random.Generator
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, str]:
    """The full train-time chain of grounding2.py::grounding_resize:

    - direction words in the phrase pin the geometry to a plain long-side
      menu resize (:398-402); otherwise p=0.5 picks either that or
      short-side resize -> IoU-0.9 RandomSizeCrop -> long-side resize;
    - ColorJitter, then flip with phrase rewrite;
    - random-translate letterbox to output_sz, box normalized to [0,1].

    Returns (canvas uint8 HWC, xywh box in [0,1], att_mask, phrase)."""
    box = np.array([bbox_xywh[0], bbox_xywh[1],
                    bbox_xywh[0] + bbox_xywh[2], bbox_xywh[1] + bbox_xywh[3]],
                   np.float64)
    sizes1, sizes2, (min_size, max_size) = size_menus(output_sz)
    if has_directions(phrase):
        im, box = random_resize(sizes1, im, box, rng, resize_long_side=True)
    elif rng.random() < 0.5:
        im, box = random_resize(sizes1, im, box, rng, resize_long_side=True)
    else:
        im, box = random_resize(sizes2, im, box, rng, resize_long_side=False)
        im, box = random_size_crop(im, box, rng, min_size, max_size,
                                   max_cnt=20, iou_thres=0.9)
        im, box = random_resize(sizes1, im, box, rng, resize_long_side=True)
    im = color_jitter(im, rng)
    im, phrase, box = random_horizontal_flip(im, phrase, box, rng)
    canvas, xywh, att = random_translate_letterbox(im, box, output_sz, rng)
    return canvas, xywh, att, phrase
