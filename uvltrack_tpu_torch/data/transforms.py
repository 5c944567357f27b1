"""Joint image/box augmentation transforms for training.

Parity with lib/train/data/transforms.py: a Transform pipeline applying the
same random roll to all images of one sample (joint=True semantics), with
brightness jitter, horizontal flip (+ box rewrite), grayscale, and
normalization. Implemented on numpy arrays in dataloader workers.

The port's own copy of uvltrack_tpu/data/transforms.py (framework-free; the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import cv2
import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class Transform:
    """Compose: each op draws its random state once per sample and applies it
    to every (image, box, att) in the sample jointly."""

    def __init__(self, *ops):
        self.ops = ops

    def __call__(self, images: List[np.ndarray], boxes: List[np.ndarray],
                 atts: Optional[List[np.ndarray]] = None,
                 rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        for op in self.ops:
            images, boxes, atts = op(images, boxes, atts, rng)
        return images, boxes, atts


class ToFloatAndJitterBrightness:
    """uint8 -> float [0,1] with multiplicative brightness jitter."""

    def __init__(self, brightness_jitter: float = 0.2):
        self.bj = brightness_jitter

    def __call__(self, images, boxes, atts, rng):
        factor = rng.uniform(max(0, 1 - self.bj), 1 + self.bj)
        images = [np.clip(im.astype(np.float32) / 255.0 * factor, 0.0, 1.0)
                  for im in images]
        return images, boxes, atts


class RandomGrayscale:
    def __init__(self, probability: float = 0.05):
        self.p = probability

    def __call__(self, images, boxes, atts, rng):
        if rng.random() < self.p:
            out = []
            for im in images:
                g = cv2.cvtColor((im * 255).astype(np.uint8), cv2.COLOR_RGB2GRAY)
                out.append(np.stack([g, g, g], -1).astype(np.float32) / 255.0)
            images = out
        return images, boxes, atts


class RandomHorizontalFlip:
    """Flip images and rewrite normalized xywh boxes: x -> 1 - x - w."""

    def __init__(self, probability: float = 0.5):
        self.p = probability

    def __call__(self, images, boxes, atts, rng):
        if rng.random() < self.p:
            images = [im[:, ::-1].copy() for im in images]
            boxes = [np.array([1.0 - b[0] - b[2], b[1], b[2], b[3]]) for b in boxes]
            if atts is not None:
                atts = [a[:, ::-1].copy() for a in atts]
        return images, boxes, atts


class Normalize:
    def __call__(self, images, boxes, atts, rng):
        images = [(im - IMAGENET_MEAN) / IMAGENET_STD for im in images]
        return images, boxes, atts


def default_transform(grayscale_prob: float = 0.05,
                      brightness_jitter: float = 0.2,
                      flip_prob: float = 0.5) -> Transform:
    return Transform(
        ToFloatAndJitterBrightness(brightness_jitter),
        RandomGrayscale(grayscale_prob),
        RandomHorizontalFlip(flip_prob),
        Normalize(),
    )


def eval_transform() -> Transform:
    return Transform(ToFloatAndJitterBrightness(0.0), Normalize())
