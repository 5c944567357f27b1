"""Per-sample crop/augment processing for training.

Parity with TrackProcessing (lib/train/data/processing.py:45-309):
- track_process: jitter the target box, jittered_center_crop to template /
  search, joint photometric+flip transforms, Gaussian cls label per search
  frame, validity checks with resampling handled by the sampler.
- grounding_process: full grounding2 aug chain on the grounding frame (size
  menus / IoU-crop / color jitter / flip with "left"<->"right" phrase
  rewrite / random-translate letterbox), jittered center crops for the extra
  search frames, and the direction-word substitution rule — when the phrase
  has direction words the grounding frame replaces the search crops
  (processing.py:285-291); template is zeros (:297-298).

Outputs are frame-major numpy dicts; images NHWC float32 (ImageNet-normalized).

The port's own copy of uvltrack_tpu/data/processing.py (framework-free; the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import List, Optional

import cv2
import numpy as np

from .grounding_aug import (flip_phrase,  # noqa: F401 (re-export)
                            grounding_resize_train, has_directions)
from .processing_utils import (generate_cls_label_np, grounding_resize_np,
                               jittered_center_crop)
from .transforms import IMAGENET_MEAN, IMAGENET_STD

DIRECTION_WORDS = ("left", "right", "top", "bottom", "middle")


def _normalize_img(im: np.ndarray) -> np.ndarray:
    return (im.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


class TrackProcessing:
    def __init__(self, cfg, rng: Optional[np.random.Generator] = None,
                 seed: Optional[int] = None):
        self.cfg = cfg
        if rng is not None:
            self._rng, self._fixed_rng = None, rng
        else:
            # loader workers call this from multiple threads; numpy Generators
            # are not thread-safe, so default to per-thread streams
            from .sampler import _ThreadLocalRng

            self._rng, self._fixed_rng = _ThreadLocalRng(seed), None
        self.template_size = int(cfg.DATA.TEMPLATE.SIZE)
        self.search_size = int(cfg.DATA.SEARCH.SIZE)
        self.template_factor = float(cfg.DATA.TEMPLATE.FACTOR)
        self.search_factor = float(cfg.DATA.SEARCH.FACTOR)
        self.tpl_center_jitter = float(cfg.DATA.TEMPLATE.CENTER_JITTER)
        self.tpl_scale_jitter = float(cfg.DATA.TEMPLATE.SCALE_JITTER)
        self.srch_center_jitter = float(cfg.DATA.SEARCH.CENTER_JITTER)
        self.srch_scale_jitter = float(cfg.DATA.SEARCH.SCALE_JITTER)
        self.gaussian_iou = float(cfg.TRAIN.GAUSSIAN_IOU)
        self.dynamic_cls = bool(cfg.TRAIN.DYNAMIC_CLS)
        self.brightness_jitter = 0.2
        self.flip_prob = 0.5
        self.gray_prob = 0.05

    @property
    def rng(self) -> np.random.Generator:
        return self._fixed_rng if self._fixed_rng is not None else self._rng.get()

    def reseed(self, key: int) -> None:
        """Disjoint stream for a forked loader worker (no-op with a fixed
        caller-owned generator — unit-test mode)."""
        if self._rng is not None:
            self._rng.reseed(key)

    # ----------------------------------------------------------------- utils
    def _jitter_box(self, box: np.ndarray, center_jitter: float,
                    scale_jitter: float) -> np.ndarray:
        """Jitter an xywh box in scale and center (processing.py:81-111)."""
        box = np.asarray(box, np.float64)
        jittered_size = box[2:4] * np.exp(self.rng.normal(0, scale_jitter, 2))
        max_offset = np.sqrt(jittered_size.prod()) * center_jitter
        jittered_center = (box[:2] + 0.5 * box[2:4]
                           + max_offset * (self.rng.random(2) - 0.5))
        return np.concatenate([jittered_center - 0.5 * jittered_size, jittered_size])

    def _photometric(self, images: List[np.ndarray]) -> List[np.ndarray]:
        factor = self.rng.uniform(max(0.0, 1 - self.brightness_jitter),
                                  1 + self.brightness_jitter)
        out = [np.clip(im.astype(np.float32) * factor, 0, 255) for im in images]
        if self.rng.random() < self.gray_prob:
            out = [np.repeat(cv2.cvtColor(im.astype(np.uint8),
                                          cv2.COLOR_RGB2GRAY)[..., None], 3, -1).astype(np.float32)
                   for im in out]
        return out

    # ----------------------------------------------------------------- track
    def track_process(self, template_frames, template_boxes,
                      search_frames, search_boxes, language: Optional[str]):
        """Returns the sample dict or None if a crop came out degenerate."""
        for _ in range(10):
            tpl_jit = [self._jitter_box(b, self.tpl_center_jitter,
                                        self.tpl_scale_jitter)
                       for b in template_boxes]
            srch_jit = [self._jitter_box(b, self.srch_center_jitter,
                                         self.srch_scale_jitter)
                       for b in search_boxes]
            if all(b[2] > 0 and b[3] > 0 for b in tpl_jit + srch_jit):
                break
        else:
            return None
        try:
            tpl_crops, tpl_norm, _ = jittered_center_crop(
                template_frames, tpl_jit, template_boxes,
                self.template_factor, self.template_size)
            srch_crops, srch_norm, _ = jittered_center_crop(
                search_frames, srch_jit, search_boxes,
                self.search_factor, self.search_size)
        except ValueError:
            return None

        # validity: gt box must retain positive area inside the crop
        for b in tpl_norm + srch_norm:
            inter_w = min(b[0] + b[2], 1.0) - max(b[0], 0.0)
            inter_h = min(b[1] + b[3], 1.0) - max(b[1], 0.0)
            if inter_w <= 0 or inter_h <= 0:
                return None

        images = self._photometric(tpl_crops + srch_crops)
        boxes = [np.asarray(b, np.float64) for b in tpl_norm + srch_norm]
        if self.rng.random() < self.flip_prob:
            images = [im[:, ::-1].copy() for im in images]
            boxes = [np.array([1.0 - b[0] - b[2], b[1], b[2], b[3]]) for b in boxes]
        nt = len(tpl_crops)
        tpl_imgs = np.stack([_normalize_img(im) for im in images[:nt]], 0)
        srch_imgs = np.stack([_normalize_img(im) for im in images[nt:]], 0)
        srch_boxes = np.stack(boxes[nt:], 0)
        cls = np.stack([generate_cls_label_np(b, self.search_size // 16,
                                              self.gaussian_iou, self.dynamic_cls)
                        for b in srch_boxes], 0)
        return {
            "template_images": tpl_imgs.astype(np.float32),
            "template_anno": np.stack(boxes[:nt], 0).astype(np.float32),
            "search_images": srch_imgs.astype(np.float32),
            "search_anno": srch_boxes.astype(np.float32),
            "search_cls": cls.astype(np.float32),
            "language": language,
        }

    # -------------------------------------------------------------- grounding
    def _att_survives_downsample(self, att: np.ndarray) -> bool:
        """processing.py:262-274 validity: the attention mask, nearest-
        downsampled to the feature grid, must keep at least one content
        cell (att==0). Nearest downsample samples at stride origins."""
        stride = att.shape[0] // (self.search_size // 16)
        return not (att[::stride, ::stride] == 1).all()

    def grounding_process(self, grounding_frames, grounding_boxes,
                          search_frames, search_boxes,
                          language: Optional[str], n_search: int):
        """Grounding task sample (processing.py:191-309): the grounding
        frame goes through the full grounding2 aug chain (size menus,
        IoU-crop, color jitter, flip with phrase rewrite, random-translate
        letterbox); the extra search frames get the usual jittered center
        crop. The final search stack is [grounding | search...] — and when
        the phrase has direction words the grounding frame SUBSTITUTES the
        search crops (processing.py:285-291). Template is zeros."""
        phrase = language or "object, thing or stuff"
        has_direction = has_directions(phrase)

        g_im = np.ascontiguousarray(grounding_frames[0]).astype(np.uint8)
        g_box = np.asarray(grounding_boxes[0], np.float64)
        if g_box[2] <= 0 or g_box[3] <= 0:
            return None
        canvas, g_norm, att, phrase = grounding_resize_train(
            g_im, self.search_size, g_box, phrase, self.rng)
        if g_norm[2] <= 0 or g_norm[3] <= 0 or not self._att_survives_downsample(att):
            return None
        # transform['grounding'] = ToTensorAndJitter(0.2) + Normalize
        factor = self.rng.uniform(max(0.0, 1 - self.brightness_jitter),
                                  1 + self.brightness_jitter)
        canvas = np.clip(canvas.astype(np.float32) * factor, 0, 255)
        g_images = [_normalize_img(canvas)]
        g_annos = [g_norm]

        s_images, s_annos = [], []
        if search_frames:
            # the reference runs the search branch (jitter, crop, validity)
            # BEFORE the direction-word substitution (processing.py:203-276
            # precede :285-291), so its accept/reject distribution applies to
            # direction-word samples too — match that here
            for _ in range(10):
                s_jit = [self._jitter_box(b, self.srch_center_jitter,
                                          self.srch_scale_jitter)
                         for b in search_boxes]
                if all(b[2] > 0 and b[3] > 0 for b in s_jit):
                    break
            else:
                return None
            try:
                crops, norms, atts = jittered_center_crop(
                    search_frames, s_jit, search_boxes,
                    self.search_factor, self.search_size)
            except ValueError:
                return None
            for att in atts:
                # processing.py:262-274: the crop's attention mask must keep
                # content after nearest-downsample to the feature grid
                if (att == 1).all() or not self._att_survives_downsample(att):
                    return None
            for b in norms:
                iw = min(b[0] + b[2], 1.0) - max(b[0], 0.0)
                ih = min(b[1] + b[3], 1.0) - max(b[1], 0.0)
                if iw <= 0 or ih <= 0:
                    return None
            imgs = self._photometric(crops)
            boxes = [np.asarray(b, np.float64) for b in norms]
            if self.rng.random() < self.flip_prob:
                # per-stream flip (RandomHorizontalFlip_Norm) — phrase is NOT
                # rewritten for these crops in the reference either
                imgs = [im[:, ::-1].copy() for im in imgs]
                boxes = [np.array([1.0 - b[0] - b[2], b[1], b[2], b[3]])
                         for b in boxes]
            s_images = [_normalize_img(im) for im in imgs]
            s_annos = boxes

        if has_direction:
            # direction words: the grounding frame substitutes the search
            # crops (processing.py:285-291) — after their validity ran
            s_images, s_annos = [], []
        srch = g_images + s_images
        anno = g_annos + s_annos
        while len(srch) < n_search:  # direction words / image datasets:
            srch.append(srch[0].copy())  # the grounding frame substitutes
            anno.append(anno[0].copy())
        srch_imgs = np.stack(srch[:n_search], 0)
        srch_boxes = np.stack(anno[:n_search], 0)
        cls = np.stack([generate_cls_label_np(b, self.search_size // 16,
                                              self.gaussian_iou, self.dynamic_cls)
                        for b in srch_boxes], 0)
        ts = self.template_size
        return {
            "template_images": np.zeros((1, ts, ts, 3), np.float32),
            "template_anno": np.zeros((1, 4), np.float32),
            "search_images": srch_imgs.astype(np.float32),
            "search_anno": srch_boxes.astype(np.float32),
            "search_cls": cls.astype(np.float32),
            "language": phrase,
        }

    def grounding_process_test(self, frames, boxes, language, n_search: int):
        """Validation grounding sample (sampler.py:496-522 + the has_search
        False branch of processing.py:252-257): frame [0] of the sequence
        through the PLAIN aspect-preserving letterbox (prutils.
        grounding_resize — no size menus, no crop, no flip), repeated to
        n_search frames; only the brightness jitter of transform['grounding']
        applies."""
        phrase = language or "object, thing or stuff"
        im = np.ascontiguousarray(frames[0]).astype(np.uint8)
        box = np.asarray(boxes[0], np.float64)
        if box[2] <= 0 or box[3] <= 0:
            return None
        padded, nb, att = grounding_resize_np(im, self.search_size, box)
        if nb[2] <= 0 or nb[3] <= 0 or not self._att_survives_downsample(att):
            return None
        factor = self.rng.uniform(max(0.0, 1 - self.brightness_jitter),
                                  1 + self.brightness_jitter)
        img = _normalize_img(np.clip(padded.astype(np.float32) * factor, 0, 255))
        srch_imgs = np.stack([img.copy() for _ in range(n_search)], 0)
        srch_boxes = np.stack([nb.copy() for _ in range(n_search)], 0)
        cls = np.stack([generate_cls_label_np(b, self.search_size // 16,
                                              self.gaussian_iou, self.dynamic_cls)
                        for b in srch_boxes], 0)
        ts = self.template_size
        return {
            "template_images": np.zeros((1, ts, ts, 3), np.float32),
            "template_anno": np.zeros((1, 4), np.float32),
            "search_images": srch_imgs.astype(np.float32),
            "search_anno": srch_boxes.astype(np.float32),
            "search_cls": cls.astype(np.float32),
            "language": phrase,
        }
