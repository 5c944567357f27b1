"""Evaluation sequence containers (parity: lib/test/evaluation/data.py; a
copy of uvltrack_tpu/eval/data.py)."""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class Sequence:
    def __init__(self, name: str, frames: List[str], dataset: str,
                 ground_truth_rect: np.ndarray, object_class: Optional[str] = None,
                 target_visible: Optional[np.ndarray] = None,
                 language: Optional[str] = None):
        self.name = name
        self.frames = frames
        self.dataset = dataset
        self.ground_truth_rect = np.asarray(ground_truth_rect, np.float64).reshape(-1, 4)
        self.object_class = object_class
        self.target_visible = target_visible
        self.language = language

    def init_info(self) -> dict:
        info = {"init_bbox": list(self.ground_truth_rect[0])}
        if self.language is not None:
            info["language"] = self.language
        return info

    def __repr__(self):
        return f"Sequence({self.name}, {len(self.frames)} frames, {self.dataset})"


class SequenceList(list):
    def __getitem__(self, item):
        if isinstance(item, str):
            for s in self:
                if s.name == item:
                    return s
            raise KeyError(item)
        out = super().__getitem__(item)
        return SequenceList(out) if isinstance(item, slice) else out
