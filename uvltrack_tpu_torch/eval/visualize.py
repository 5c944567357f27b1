"""Debug visualization: tracked boxes and response maps.

Parity with the reference's debug hooks (lib/test/tracker/uvltrack.py:
save_visualization, lib/test/tracker/tracker_utils.py:vis_attn_maps):
draw predicted/gt boxes on frames, dump cls/contrastive response heatmaps.
A copy of uvltrack_tpu/eval/visualize.py; cv2 is imported where it is used.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def draw_box(image: np.ndarray, box, color=(0, 255, 0), width: int = 2) -> np.ndarray:
    import cv2

    out = np.ascontiguousarray(image.copy())
    x, y, w, h = (int(round(float(v))) for v in box)
    cv2.rectangle(out, (x, y), (x + w, y + h), color, width)
    return out


def save_frame_with_boxes(path: str, image: np.ndarray, boxes: Sequence,
                          colors: Optional[Sequence] = None):
    import cv2

    colors = colors or [(0, 255, 0), (255, 0, 0), (0, 0, 255)]
    out = image
    for i, b in enumerate(boxes):
        out = draw_box(out, b, colors[i % len(colors)])
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cv2.imwrite(path, cv2.cvtColor(out, cv2.COLOR_RGB2BGR))


def save_response_map(path: str, response: np.ndarray, upscale: int = 200):
    """Save a (sz, sz) or flat (sz*sz,) response map as a colored heatmap."""
    import cv2

    r = np.asarray(response, np.float32)
    if r.ndim == 1:
        sz = int(round(len(r) ** 0.5))
        r = r.reshape(sz, sz)
    r = r - r.min()
    r = r / max(r.max(), 1e-9)
    img = cv2.applyColorMap((r * 255).astype(np.uint8), cv2.COLORMAP_VIRIDIS)
    img = cv2.resize(img, (upscale, upscale), interpolation=cv2.INTER_NEAREST)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cv2.imwrite(path, img)


def save_sequence_video(path: str, frames, boxes, fps: float = 30.0):
    """Write an mp4 with tracked boxes drawn on each frame."""
    import cv2

    frames = list(frames)
    h, w = frames[0].shape[:2]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for img, box in zip(frames, boxes):
        writer.write(cv2.cvtColor(draw_box(img, box), cv2.COLOR_RGB2BGR))
    writer.release()
