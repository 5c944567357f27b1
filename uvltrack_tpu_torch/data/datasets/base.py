"""Training dataset contract.

Parity with BaseVideoDataset (lib/train/dataset/base_video_dataset.py:6-110):
datasets expose sequence sampling (get_sequence_info -> validity masks,
get_frames -> images + annos + language meta) plus capability flags that the
task-mixing sampler uses to route tracking / grounding / vision-language
samples (e.g. lib/train/dataset/lasot.py:83-89).

The port's own copy of uvltrack_tpu/data/datasets/base.py (framework-free; the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import cv2
import numpy as np


def opencv_loader(path: str) -> np.ndarray:
    """Default train-side image loader. JPEGs go through the native libjpeg
    decoder when its library builds (bit-identical to cv2's output, measured
    1.6x faster at 720p — decode is ~half the per-sample loader cost);
    everything else (and any decode failure) falls back to cv2."""
    from ...native import imread_rgb

    return imread_rgb(path)


def opencv_only_loader(path: str) -> np.ndarray:
    im = cv2.imread(path, cv2.IMREAD_COLOR)
    if im is None:
        raise IOError(f"could not read image {path}")
    return cv2.cvtColor(im, cv2.COLOR_BGR2RGB)


class BaseVideoDataset:
    """A video (or pseudo-video image) dataset for training."""

    def __init__(self, name: str, root: str, image_loader=opencv_loader):
        self.name = name
        self.root = root
        self.image_loader = image_loader
        self.sequence_list: List = []

    # ------------------------------------------------------------ capability
    def is_video_sequence(self) -> bool:
        return True

    def is_tracking_sequence(self) -> bool:
        return True

    def is_grounding_sequence(self) -> bool:
        return False

    def is_vl_sequence(self) -> bool:
        return False

    def has_class_info(self) -> bool:
        return False

    # -------------------------------------------------------------- contract
    def get_name(self) -> str:
        return self.name

    def get_num_sequences(self) -> int:
        return len(self.sequence_list)

    def get_sequence_info(self, seq_id: int) -> Dict[str, np.ndarray]:
        """Returns {'bbox': (N,4) xywh, 'valid': (N,), 'visible': (N,)}"""
        raise NotImplementedError

    def get_frames(self, seq_id: int, frame_ids: List[int],
                   anno: Optional[dict] = None) -> Tuple[List[np.ndarray], dict, dict]:
        """Returns (frames, frame_annos, object_meta). frame_annos holds per-
        frame 'bbox' list; object_meta may hold 'language'."""
        raise NotImplementedError

    def get_language(self, seq_id: int) -> Optional[str]:
        return None

    def __len__(self) -> int:
        return self.get_num_sequences()


def valid_visible(bbox: np.ndarray, min_size: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    valid = (bbox[:, 2] > min_size) & (bbox[:, 3] > min_size)
    return valid, valid.copy()
