"""Device-side image pipeline: crop/resize/normalize on torch tensors (port
of uvltrack_tpu/track/pipeline.py; reference sample_target,
lib/train/data/processing_utils.py:159-243, grounding_resize, :60-141, and
Preprocessor_wo_mask, lib/test/tracker/tracker_utils.py:20-29).

The square crop uses the reference's window geometry (integer-rounded
corner, ceil crop size) and cv2.INTER_LINEAR sampling (half-pixel centers,
edge clamping within the crop, zero outside the image) as a separable
two-tap bilinear gather. The crop corner and size stay device tensors, so a
tracking step reads nothing back to the host.

The grounding letterbox resizes the whole frame as the JAX package's
jax.image.resize(..., "linear", antialias=False) does: half-pixel sample
positions with a triangle kernel whose out-of-image taps drop out and whose
weights are renormalized, i.e. edge clamping. F.interpolate(bilinear,
align_corners=False, antialias=False) computes that function; the CPU tests
hold the two within 2e-5 of a pixel value at the borders, downscaling
(720p -> 256) and upscaling (a frame smaller than 256), and the whole
letterbox within 1e-4 after normalization.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.geometry import crop_params

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _axis_taps(out_sz: int, crop_sz: torch.Tensor, offset: torch.Tensor,
               limit: int):
    """Bilinear taps along one axis: (idx0, idx1, w0, w1), indices clamped
    into the image and weights zeroed for out-of-image taps.

    The reference pads the far side by max(x2 - W + 1, 0), so on any
    bottom/right spill -- an exact fit x2 == W included -- the last in-image
    row/col is dropped to zero too: valid indices are
    [max(x1, 0), min(x2, W - 1)).
    """
    dev = crop_sz.device
    j = torch.arange(out_sz, dtype=torch.float32, device=dev)
    crop_f = crop_sz.float()
    s = (j + 0.5) * (crop_f / out_sz) - 0.5
    s = torch.minimum(s.clamp_min(0.0), crop_f - 1.0)
    c0 = torch.floor(s)
    w1 = s - c0
    w0 = 1.0 - w1
    c0i = c0.to(torch.int32)
    c1i = torch.minimum(c0i + 1, crop_sz - 1)
    i0, i1 = offset + c0i, offset + c1i
    upper = torch.clamp_max(offset + crop_sz, limit - 1)
    v0 = ((i0 >= 0) & (i0 < upper)).float()
    v1 = ((i1 >= 0) & (i1 < upper)).float()
    return (i0.clamp(0, limit - 1).long(), i1.clamp(0, limit - 1).long(),
            w0 * v0, w1 * v1)


def crop_resize(frame: torch.Tensor, x1, y1, crop_sz, out_sz: int) -> torch.Tensor:
    """frame (H,W,3) uint8 or float -> (out_sz, out_sz, 3) fp32 bilinear
    crop. Rows are gathered first (contiguous (W, 3) rows) and cast to fp32
    after the gather, so the frame is never copied whole as fp32."""
    h, w = frame.shape[0], frame.shape[1]
    ry0, ry1, wy0, wy1 = _axis_taps(out_sz, crop_sz, y1, h)
    rx0, rx1, wx0, wx1 = _axis_taps(out_sz, crop_sz, x1, w)
    rows = (frame[ry0].float() * wy0[:, None, None]
            + frame[ry1].float() * wy1[:, None, None])
    return rows[:, rx0] * wx0[None, :, None] + rows[:, rx1] * wx1[None, :, None]


def normalize(img: torch.Tensor) -> torch.Tensor:
    """uint8-range (H,W,3) -> ImageNet-normalized fp32."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=img.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=img.device)
    return (img / 255.0 - mean) / std


def sample_target_device(frame: torch.Tensor, box_xywh: torch.Tensor,
                         search_area_factor: float, out_sz: int):
    """Square crop of area factor^2 * wh centered on the box, resized to
    out_sz and normalized. Returns (patch (1,out,out,3), resize_factor)."""
    x1, y1, crop_i, resize_factor = crop_params(box_xywh, search_area_factor, out_sz)
    patch = crop_resize(frame, x1, y1, crop_i, out_sz)
    return normalize(patch)[None], resize_factor


def letterbox_params(h: int, w: int, out_sz: int):
    """Static letterbox geometry (grounding_resize, processing_utils.py:60-141):
    (oh, ow, y_pad, x_pad) as Python ints. The longer side becomes out_sz;
    an odd margin puts its extra pixel before the image (the reference's
    y1 = y2 = int((out - oh) / 2), then y1 += 1 when short by one)."""
    if w > h:
        ow, oh = out_sz, int(out_sz * h / w)
    else:
        oh, ow = out_sz, int(out_sz * w / h)
    y_pad, x_pad = int((out_sz - oh) / 2), int((out_sz - ow) / 2)
    if 2 * y_pad + oh != out_sz:
        y_pad += 1
    if 2 * x_pad + ow != out_sz:
        x_pad += 1
    return oh, ow, y_pad, x_pad


def grounding_letterbox(frame: torch.Tensor, out_sz: int) -> torch.Tensor:
    """frame (H, W, 3) uint8 or float -> (1, out_sz, out_sz, 3) fp32:
    aspect-preserving bilinear resize of the whole frame (in fp32), centered
    on a zero canvas, ImageNet-normalized (the padding normalizes too)."""
    h, w = frame.shape[0], frame.shape[1]
    oh, ow, y_pad, x_pad = letterbox_params(h, w, out_sz)
    resized = F.interpolate(frame.float().permute(2, 0, 1)[None], size=(oh, ow),
                            mode="bilinear", align_corners=False, antialias=False)
    canvas = torch.zeros((out_sz, out_sz, 3), dtype=torch.float32, device=frame.device)
    canvas[y_pad:y_pad + oh, x_pad:x_pad + ow] = resized[0].permute(1, 2, 0)
    return normalize(canvas)[None]
