"""Batched benchmark evaluation: S sequences advance in lockstep on one card.

A copy of uvltrack_tpu/eval/running_batched.py (framework-free; it takes a
BatchTracker factory, here track/batch.py's). In place of the reference's
GPU process pool (lib/test/evaluation/running.py:93-102): sequences are
bucketed by frame resolution, S stream slots are filled per bucket, and
every step advances all live streams with one batched forward
(track/batch.BatchTracker). When a stream finishes it is frozen
(active=False) until the whole slot group drains, then slots refill with
the next sequences. Output files are identical to the sequential runner's.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from typing import Callable, List, Optional

import numpy as np

from .data import Sequence, SequenceList
from .running import dispatching_loader, save_results


def _resolution(seq: Sequence, image_loader) -> tuple:
    return image_loader(seq.frames[0]).shape[:2]


def _run_group(batch_tracker_factory, group: List["Sequence"],
               results_dir: str, load) -> tuple:
    """Track one lockstep stream group to completion and save its results.
    Returns (n_frames, elapsed_seconds, n_failed_streams).

    Failures are isolated PER STREAM: a corrupt frame or a mid-sequence
    resolution change (bucketing only sees frame 0) freezes that stream and
    skips saving its result file (a re-run or --streams 1 retries it); the
    other streams in the group keep tracking."""
    S = len(group)
    bt = batch_tracker_factory(S)
    t_start = time.time()
    frames0 = [load(s.frames[0]) for s in group]
    # placeholder for NL streams — BatchTracker.initialize overrides their
    # boxes with the grounding forward's prediction and returns the boxes
    # actually used, so GT cannot leak into the grounding protocol
    boxes0 = np.stack([np.asarray(s.ground_truth_rect[0], np.float32)
                       for s in group])
    langs = [s.language for s in group]
    init_boxes = bt.initialize(frames0, boxes0, languages=langs)
    if init_boxes is None:  # older tracker stubs without a return value
        init_boxes = boxes0

    max_len = max(len(s.frames) for s in group)
    outs = [[list(np.asarray(init_boxes[i], np.float64))] for i in range(S)]
    failed = {}
    frame_idx = 1
    while frame_idx < max_len:
        rows = []
        active = np.zeros(S, bool)
        for i, s in enumerate(group):
            if i in failed or frame_idx >= len(s.frames):
                rows.append(frames0[i])
                continue
            try:
                f = load(s.frames[frame_idx])
                if f.shape != frames0[i].shape:
                    raise ValueError(
                        f"shape change {f.shape} vs {frames0[i].shape} "
                        f"at frame {frame_idx}")
            except Exception as e:
                failed[i] = e
                rows.append(frames0[i])
                continue
            rows.append(f)
            active[i] = True
        if not active.any():
            break
        bt.set_active(active)
        packed = bt.step(np.stack(rows))
        for i in range(S):
            if active[i]:
                outs[i].append(packed[i, :4].tolist())
        frame_idx += 1

    elapsed = time.time() - t_start
    n_frames = 0
    for i, s in enumerate(group):
        if i in failed:
            print(f"{s.name} failed ({type(failed[i]).__name__}: {failed[i]});"
                  " result not saved — re-run (or --streams 1) to retry")
            continue
        n_frames += len(s.frames)
        times = np.full(len(s.frames), elapsed / max(len(s.frames), 1))
        save_results(results_dir, s.name,
                     np.asarray(outs[i], np.float64), times)
    return n_frames, elapsed, len(failed)


def run_dataset_batched(batch_tracker_factory: Callable[[int], object],
                        dataset: SequenceList, results_dir: str,
                        num_streams: int = 8,
                        image_loader: Optional[Callable] = None,
                        rerun: bool = False, verbose: bool = True):
    """batch_tracker_factory(num_streams) -> BatchTracker-like object."""
    from ..native import imread_rgb

    load = dispatching_loader(image_loader or imread_rgb)
    pending = [s for s in dataset
               if rerun or not os.path.isfile(os.path.join(results_dir, f"{s.name}.txt"))]
    skipped = len(dataset) - len(pending)
    if verbose and skipped:
        print(f"skipping {skipped} sequences with existing results")

    # bucket by resolution of the first frame; frames are re-decoded
    # per-group (one extra ~5ms decode each) rather than held for the whole
    # dataset — 700 decoded 720p first frames is ~2GB of host RAM
    buckets = defaultdict(list)
    for s in pending:
        buckets[_resolution(s, load)].append(s)

    total_frames, total_time, done, failed = 0, 0.0, 0, 0
    for hw, seqs in buckets.items():
        for g0 in range(0, len(seqs), num_streams):
            group: List[Sequence] = seqs[g0: g0 + num_streams]
            S = len(group)
            try:
                n_frames, elapsed, n_failed = _run_group(
                    batch_tracker_factory, group, results_dir, load)
            except Exception as e:
                # group-level isolation for init-time errors (frame-0 load,
                # tracker init), like the sequential runner's per-sequence
                # try/except: one bad group must not abort the remaining
                # multi-hour benchmark; runtime errors are isolated
                # per-stream inside _run_group
                failed += S
                print(f"group of {S} @ {hw} failed "
                      f"({', '.join(s.name for s in group)}): "
                      f"{type(e).__name__}: {e}")
                continue
            failed += n_failed
            total_frames += n_frames
            total_time += elapsed
            done += S - n_failed
            if verbose:
                print(f"[{done}/{len(pending)}] {S} streams @ {hw}: "
                      f"{n_frames} frames, {n_frames/elapsed:.1f} FPS aggregate")
    if failed:
        print(f"WARNING: {failed} sequences failed; re-run to retry them "
              "(results for completed sequences are saved)")
    if verbose and total_time > 0:
        print(f"Done: {done} sequences, {total_frames/total_time:.1f} FPS aggregate")
    return dict(sequences=done, frames=total_frames, seconds=total_time)
