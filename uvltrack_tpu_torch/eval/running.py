"""Benchmark runner: drive a tracker over a SequenceList and save results.

Parity with lib/test/evaluation/running.py: results saved as
<results_dir>/<seq>.txt with integer xywh per line (tab-separated) plus
<seq>_time.txt; sequences whose result file exists are skipped (resumable);
per-sequence exceptions are caught and reported.

A copy of uvltrack_tpu/eval/running.py (framework-free; it takes the
tracker from the caller, here track/tracker.py's Tracker). Instead of a
GPU-process pool, sequences run in one process feeding one card.
Multi-stream batched tracking lives in track/batch.py and
eval/running_batched.py.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np

from .data import Sequence, SequenceList


def save_results(results_dir: str, seq_name: str, boxes: np.ndarray,
                 times: np.ndarray) -> None:
    os.makedirs(results_dir, exist_ok=True)
    np.savetxt(os.path.join(results_dir, f"{seq_name}.txt"),
               np.round(boxes).astype(int), delimiter="\t", fmt="%d")
    np.savetxt(os.path.join(results_dir, f"{seq_name}_time.txt"), times, fmt="%.8f")


def dispatching_loader(base_load):
    """Wrap an image loader so LMDB-packed (db_path, key) frame refs decode
    through lmdb_utils (parity: lib/test/evaluation/tracker.py _read_image
    list dispatch); plain path strings go to base_load."""

    def load(f):
        if isinstance(f, (tuple, list)):
            from ..utils.lmdb_utils import decode_img

            return decode_img(f[0], f[1])
        return base_load(f)

    return load


def _save_sequence_vis(vis_dir: str, seq: Sequence, boxes, load, stride: int):
    """Debug overlays: predicted box (green) + ground truth (red) per frame.

    Parity: lib/test/tracker/uvltrack.py:142-163 save_visualization — which
    the reference ships disabled (its save_dir assignment at :34 is commented
    out, so enabling debug there crashes). Here it runs host-side AFTER the
    sequence finishes so the saved per-frame times stay measurement-clean.
    """
    from .visualize import save_frame_with_boxes

    out = os.path.join(vis_dir, seq.name)
    gt = np.asarray(seq.ground_truth_rect, np.float64)
    for i in range(0, len(boxes), max(stride, 1)):
        overlays = [boxes[i]]
        if gt.ndim == 2 and gt.shape[0] > i and np.isfinite(gt[i]).all():
            overlays.append(gt[i])
        save_frame_with_boxes(os.path.join(out, f"{i:04d}.jpg"),
                              load(seq.frames[i]), overlays,
                              colors=[(0, 255, 0), (255, 0, 0)])


def run_sequence(tracker, seq: Sequence, results_dir: str,
                 image_loader: Optional[Callable] = None, rerun: bool = False,
                 prefetch: int = 8, chunk: int = 0,
                 save_vis: Optional[str] = None, vis_stride: int = 1,
                 vis_response: bool = False):
    """Run one sequence; returns (n_frames, elapsed_s) or None if skipped.

    Frames are decoded by the native prefetcher `prefetch` frames ahead of
    the device, so IO overlaps the tracking step. With chunk>1 and a tracker
    exposing track_many, boxes are read back once per chunk of frames
    (per-frame times become amortized).
    """
    result_path = os.path.join(results_dir, f"{seq.name}.txt")
    if os.path.isfile(result_path) and not rerun:
        return None
    from ..native import SequencePrefetcher, imread_rgb

    load = dispatching_loader(image_loader or imread_rgb)
    boxes, times = [], []
    start = time.time()
    frames = SequencePrefetcher(seq.frames, depth=max(prefetch, chunk + 1),
                                loader=load) \
        if prefetch > 1 and len(seq.frames) > 2 else map(load, seq.frames)
    it = iter(frames)
    img0 = next(it)
    t0 = time.time()
    out = tracker.initialize(img0, seq.init_info())
    times.append(time.time() - t0)
    boxes.append(out.get("target_bbox", list(seq.ground_truth_rect[0])))
    if chunk > 1 and hasattr(tracker, "track_many"):
        pending = []
        for img in it:
            pending.append(img)
            if len(pending) == chunk:
                t0 = time.time()
                packed = tracker.track_many(pending, chunk=chunk)
                dt = (time.time() - t0) / len(pending)
                boxes.extend(packed[:, :4].tolist())
                times.extend([dt] * len(pending))
                pending = []
        if pending:
            t0 = time.time()
            packed = tracker.track_many(pending, chunk=chunk)
            dt = (time.time() - t0) / len(pending)
            boxes.extend(packed[:, :4].tolist())
            times.extend([dt] * len(pending))
    else:
        # response maps must be captured inside the loop; it costs an extra
        # readback per frame, so the saved per-frame times are debug-grade
        # when vis_response is on (the box math itself is unchanged)
        debug_maps = (save_vis and vis_response
                      and hasattr(tracker, "track_debug"))
        resp = []
        for img in it:
            t0 = time.time()
            out = (tracker.track_debug(img) if debug_maps
                   else tracker.track(img))
            times.append(time.time() - t0)
            boxes.append(out["target_bbox"])
            if debug_maps and (len(boxes) - 1) % max(vis_stride, 1) == 0:
                resp.append((len(boxes) - 1, out["cls_map"],
                             out["merged_map"]))
        if debug_maps:
            from .visualize import save_response_map

            for i, cls_map, merged in resp:
                base = os.path.join(save_vis, seq.name)
                save_response_map(os.path.join(base, f"{i:04d}_cls.png"),
                                  cls_map)
                save_response_map(os.path.join(base, f"{i:04d}_merged.png"),
                                  merged)
    elapsed = time.time() - start
    save_results(results_dir, seq.name, np.asarray(boxes, np.float64),
                 np.asarray(times))
    if save_vis:
        _save_sequence_vis(save_vis, seq, boxes, load, vis_stride)
    return len(seq.frames), elapsed


def run_dataset(tracker_factory: Callable[[], object], dataset: SequenceList,
                results_dir: str, image_loader: Optional[Callable] = None,
                rerun: bool = False, verbose: bool = True, chunk: int = 0,
                save_vis: Optional[str] = None, vis_stride: int = 1,
                vis_response: bool = False):
    """Run a tracker over every sequence (resumable)."""
    tracker = tracker_factory()
    total_frames, total_time, done = 0, 0.0, 0
    for i, seq in enumerate(dataset):
        try:
            r = run_sequence(tracker, seq, results_dir, image_loader, rerun,
                             chunk=chunk, save_vis=save_vis,
                             vis_stride=vis_stride, vis_response=vis_response)
        except Exception as e:  # keep going like the reference harness
            print(f"[{seq.name}] ERROR: {e}")
            continue
        if r is None:
            if verbose:
                print(f"[{i+1}/{len(dataset)}] {seq.name}: skipped (result exists)")
            continue
        n, dt = r
        total_frames += n
        total_time += dt
        done += 1
        if verbose:
            print(f"[{i+1}/{len(dataset)}] {seq.name}: {n} frames, {n/dt:.1f} FPS")
    if verbose and total_time > 0:
        print(f"Done: {done} sequences, overall {total_frames/total_time:.1f} FPS")
    return dict(sequences=done, frames=total_frames, seconds=total_time)


def default_image_loader(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"could not read image {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
