"""Lockstep multi-stream tracking: S streams advance together, one batched
forward a step (port of uvltrack_tpu/track/batch.py; the reference runs one
process per GPU over its eval sequences, lib/test/evaluation/running.py:93-102).

A step crops every stream's search region from its own frame (the batched
crop of track/pipeline.py), runs UVLTrack.forward_test_cached (forward_test
under TPU.CACHE_TEXT=False) at batch S, decodes each row and updates every
stream's state: the step of tracker.py's LockstepTracker, which Tracker
runs at S=1. The
kernels take the batch as (B, N, .) rows and a (B, N) key bias, so a step
launches what one Tracker step launches, once for S stream-frames.

All frames of one step share a resolution. Each stream may be frozen
(set_active): it keeps its box, score and features, and its frame_id does
not advance, so ragged sequence lengths batch cleanly.

Flags follow the JAX BatchTracker, not the single Tracker: a stream gets
flag 2 only if it has a sentence, a tokenizer is given and its mode is not
BBOX; else flag 0. NL streams take their init box from the grounding
forward, at batch 1 one stream at a time: the forward without a prompt
mines prompts against the half-batch-rotated search features
(models/head.py), which at batch S would pair one stream's template with
another's search. A box supplied for an NL stream is ignored.

mesh= (a parallel/mesh.py Mesh; the JAX BatchTracker's mesh=) shards the
streams over the mesh's data axis: S is padded to S_pad, a multiple of the
data shards n, with pad streams that replay the last real stream, stay
frozen and are sliced off (the JAX package's rule); each data index runs a
replica, a BatchTracker of S_pad/n streams on its device with its own
JitTracker (graphs captured on that device) and a copy of the weights per
distinct device (parallel/mesh.replicated). A step uploads and launches
every replica before it reads any back, then concatenates the rows:
BatchTracker(..., mesh=mesh) returns a MeshBatchTracker, which has the
BatchTracker's interface.

frame_id and active stay on the host, as in the port's Tracker. On a CUDA
device a step replays the JitTracker's CUDA graphs at batch S (the step,
and the re-mine on a step where some active stream is due, its refresh =
due & (max_score > threshold) decided on the device), with the S frames
staged through a pinned buffer; step_many replays them T times after one
upload. graphs=False (and CPU tensors) run the eager step, whose re-mine
makes its one host read, max_score > threshold, on due steps.
UVLTRACK_BATCH_COND_REMINE=0 (read at call time) re-mines every step,
where-selected, with no host read: the same boxes. BatchTrackers and
Trackers that share a JitTracker (jit_tracker=) share its graphs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch

from ..utils import tracing
from .tracker import BatchState, JitTracker, LockstepTracker, frame_cost


def always_remine() -> bool:
    """UVLTRACK_BATCH_COND_REMINE="0" (read at call time): re-mine every step."""
    return os.environ.get("UVLTRACK_BATCH_COND_REMINE", "1") != "1"


class BatchTracker(LockstepTracker):
    """Tracks S streams in lockstep: initialize(frames, boxes) from their
    first frames, then step(frames (S, H, W, 3)). The model's weights are
    prepared in place by prepare_inference_model, as by Tracker:
    BatchTracker(cfg, model, num_streams, tokenizer=None, jit_tracker=None,
    graphs=True, mesh=None); with a mesh, a MeshBatchTracker."""

    def __new__(cls, *args, mesh=None, **kwargs):
        if mesh is None:
            return super().__new__(cls)
        return MeshBatchTracker(*args, mesh=mesh, **kwargs)

    def __init__(self, cfg, model, num_streams: int, tokenizer=None, jit_tracker=None,
                 graphs: bool = True, mesh=None):
        super().__init__(cfg, model, num_streams, tokenizer, jit_tracker=jit_tracker,
                         graphs=graphs)

    @property
    def S_pad(self) -> int:
        """The streams the step runs: S (a mesh pads them)."""
        return self.S

    @property
    def replicas(self) -> list:
        return [self]

    def locate(self, i: int):
        """(the BatchTracker that steps stream i, its row there)."""
        return self, i

    def text_row(self, language: Optional[str], mode: str):
        """(ids (Nt,), mask (Nt,), flag) of one stream: flag 2 with a
        sentence, a tokenizer and a mode other than BBOX, else zero ids and
        flag 0 (the JAX BatchTracker's rule)."""
        ids = np.zeros((self.nt,), np.int32)
        mask = np.zeros((self.nt,), np.int32)
        if language is not None and self.tokenizer is not None and mode != "BBOX":
            ii, mm = self.tokenizer.encode_query(language, self.nt)
            ids[:], mask[:] = ii, mm
            return ids, mask, 2
        return ids, mask, 0

    @property
    def remines(self) -> np.ndarray:
        """(S,) prompt re-mines of each stream since its initialize."""
        return self._remines.cpu().numpy().copy()

    # ------------------------------------------------------------------ init
    @torch.no_grad()
    @tracing.spanned("setup.initialize")
    def initialize(self, frames, boxes, languages: Optional[List[Optional[str]]] = None,
                   modes: Optional[List[str]] = None) -> np.ndarray:
        """frames: S first frames (one resolution); boxes: (S, 4) xywh.
        Returns the (S, 4) boxes each stream started from (grounded for NL
        streams)."""
        S = self.S
        if len(frames) != S:
            raise ValueError(f"{len(frames)} frames for {S} streams")
        languages = list(languages) if languages else [None] * S
        modes = list(modes) if modes else [self.cfg.TEST.MODE] * S
        # a copy: NL rows are overwritten, and the caller's array stays as it is
        boxes = np.array(boxes, np.float32)
        rows = [self.text_row(lang, mode) for lang, mode in zip(languages, modes)]
        self.text_ids = self.to_device(np.stack([r[0] for r in rows]))
        self.text_mask = self.to_device(np.stack([r[1] for r in rows]))
        self.flags = self.to_device(np.asarray([r[2] for r in rows], np.int32))
        stacked = self.device_frames(frames)
        for i in (i for i in range(S) if modes[i] == "NL"):
            boxes[i] = self.ground(stacked[i], self.text_ids[i:i + 1],
                                   self.text_mask[i:i + 1])
        box = self.to_device(boxes)
        self.template, self.template_mask, prompt = self.init_rows(
            stacked, box, self.text_ids, self.text_mask, self.flags)
        # per-sequence constant consumed by the step: the cached pre-fusion
        # text features, or the raw ids under TPU.CACHE_TEXT=False
        self.txt = (self.model.encode_text(self.text_ids, self.text_mask)
                    if self.cache_text else self.text_ids)
        self.state = self.fresh_state(box, prompt, np.ones((S,), bool))
        self._remines.zero_()
        self.consts_changed()
        return boxes.copy()

    def set_active(self, active) -> None:
        active = np.asarray(active, bool)
        if active.shape != (self.S,):
            raise ValueError(f"active must have shape ({self.S},), got {active.shape}")
        self.state = dataclasses.replace(self.state, active=active.copy())

    # ------------------------------------------------------------------ step
    def step_async(self, frames, debug: bool = False):
        """Advance every active stream one frame; returns the (S, 5)
        [x, y, w, h, score] device tensor without reading it back, and with
        debug=True also the (S, 3, fsz*fsz) [cls, cont, merged] maps."""
        return self.step_rows(frames, always_remine=always_remine(), debug=debug)

    def step(self, frames) -> np.ndarray:
        """frames: (S, H, W, 3) or a list of S frames. Returns (S, 5)
        [x, y, w, h, score]."""
        return self.step_async(frames).double().cpu().numpy()

    def step_many_async(self, frames_t) -> torch.Tensor:
        """frames_t: (T, S, H, W, 3), or T lists of S frames: T lockstep
        steps; returns the (T, S, 5) device tensor without reading it back
        (the JAX package scans the T steps in one dispatch; on the graph
        path the frames go up in one pinned copy, up to STAGE_BYTES, and
        the step graph is replayed T times)."""
        if self.graphs:
            return self._chunk_steps(frames_t, always_remine())
        return torch.stack([self.step_async(f) for f in frames_t])

    def step_many(self, frames_t) -> np.ndarray:
        return self.step_many_async(frames_t).double().cpu().numpy()

    def step_many_cost(self, frames_t) -> dict:
        """{"flops", "bytes", "streams"} of one lockstep step of a frame
        block shaped like `frames_t` ((T, S, H, W, 3), or T lists of S
        frames), counted from the shapes (frame_cost): S streams' products,
        the weights read once for the batch at their stored width, and the
        S frames' bytes. "streams" is the S the step runs at (S_pad in the
        JAX package, whose step_many_cost reads XLA's cost analysis of the
        scan body, a step's program, and which callers divide by it for
        per-frame figures)."""
        first = frames_t[0]
        hw = first[0].shape[:2] if isinstance(first, (list, tuple)) else first.shape[1:3]
        cost = frame_cost(self.model, self.nt)
        return {"flops": cost["flops"] * self.S,
                "bytes": cost["weight_bytes"] + self.S * int(np.prod(tuple(hw))) * 3,
                "streams": self.S}


def on_device(device):
    """The device current while a replica launches (its kernels' stream)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class MeshBatchTracker:
    """S streams over a mesh's data axis: one BatchTracker replica of
    S_pad/n streams per data index (the module docstring). The interface
    of BatchTracker: initialize, set_active, step(_async), step_many(_async),
    step_many_cost, remines, state; replicas and locate(i) name the replica
    and row of stream i."""

    def __init__(self, cfg, model, num_streams: int, tokenizer=None, jit_tracker=None,
                 graphs: bool = True, mesh=None):
        from ..models.uvltrack import prepare_inference_model
        from ..parallel.mesh import replicated

        if num_streams < 1:
            raise ValueError(f"num_streams must be >= 1, got {num_streams}")
        self.cfg, self.mesh, self.tokenizer = cfg, mesh, tokenizer
        n = mesh.data
        self.S = num_streams
        self.S_pad = -(-num_streams // n) * n
        self.per = self.S_pad // n
        # the prepared weights (bf16, int8) are what each device holds a copy of
        base = prepare_inference_model(cfg, jit_tracker.model if jit_tracker is not None
                                       else model)
        weights = replicated(mesh, base)
        self.replicas = []
        for dev in mesh.data_devices():
            with on_device(dev):
                self.replicas.append(BatchTracker(cfg, None, self.per, tokenizer=tokenizer,
                                                  jit_tracker=JitTracker(cfg, weights[dev]),
                                                  graphs=graphs))
        self.device = self.replicas[0].device

    def locate(self, i: int):
        return self.replicas[i // self.per], i % self.per

    def _pad(self, rows, axis: int = 0):
        """S rows (a list, an array or a tensor; along `axis`) -> S_pad, the
        last one replayed."""
        pad = self.S_pad - self.S
        if isinstance(rows, (list, tuple)):
            return list(rows) + [rows[-1]] * pad
        if not pad:
            return rows
        if isinstance(rows, torch.Tensor):
            return torch.cat([rows] + [rows.narrow(axis, rows.shape[axis] - 1, 1)] * pad, axis)
        return np.concatenate([rows] + [np.take(rows, [rows.shape[axis] - 1], axis)] * pad, axis)

    def _split(self, rows) -> list:
        """S_pad rows (a list, an array or a tensor) -> one share a replica."""
        return [rows[i * self.per:(i + 1) * self.per] for i in range(len(self.replicas))]

    # ------------------------------------------------------------------ init
    def initialize(self, frames, boxes, languages: Optional[List[Optional[str]]] = None,
                   modes: Optional[List[str]] = None) -> np.ndarray:
        """BatchTracker.initialize over the replicas; pad streams replay the
        last real stream."""
        if len(frames) != self.S:
            raise ValueError(f"{len(frames)} frames for {self.S} streams")
        frames = self._pad(list(frames))
        boxes = self._pad(np.array(boxes, np.float32))
        languages = self._pad(list(languages) if languages else [None] * self.S)
        modes = self._pad(list(modes) if modes else [self.cfg.TEST.MODE] * self.S)
        out = []
        for rep, f, b, lang, mode in zip(self.replicas, self._split(frames), self._split(boxes),
                                         self._split(languages), self._split(modes)):
            with on_device(rep.device):
                out.append(rep.initialize(f, b, lang, mode))
        return np.concatenate(out)[:self.S]

    def set_active(self, active) -> None:
        active = np.asarray(active, bool)
        if active.shape != (self.S,):
            raise ValueError(f"active must have shape ({self.S},), got {active.shape}")
        padded = np.concatenate([active, np.zeros(self.S_pad - self.S, bool)])
        for rep, a in zip(self.replicas, self._split(padded)):
            rep.set_active(a)

    @property
    def remines(self) -> np.ndarray:
        return np.concatenate([rep.remines for rep in self.replicas])[:self.S]

    @property
    def state(self) -> BatchState:
        """The S real streams' state, the replicas' rows concatenated (on the
        first replica's device)."""
        parts = [rep.state for rep in self.replicas]
        fields = {}
        for f in dataclasses.fields(BatchState):
            rows = [getattr(p, f.name) for p in parts]
            if isinstance(rows[0], np.ndarray):
                fields[f.name] = np.concatenate(rows)[:self.S]
            else:
                fields[f.name] = torch.cat([r.to(self.device) for r in rows])[:self.S]
        return BatchState(**fields)

    @state.setter
    def state(self, st: BatchState) -> None:
        """Set the S streams' state (the pad streams take the last one's,
        frozen)."""
        parts = [{} for _ in self.replicas]
        for f in dataclasses.fields(BatchState):
            v = getattr(st, f.name)
            if f.name == "active":
                v = np.concatenate([np.asarray(v, bool), np.zeros(self.S_pad - self.S, bool)])
            else:
                v = self._pad(v)
            for part, rep, share in zip(parts, self.replicas, self._split(v)):
                part[f.name] = (share.copy() if isinstance(share, np.ndarray)
                                else share.to(rep.device).clone())
        for rep, part in zip(self.replicas, parts):
            rep.state = BatchState(**part)

    # ------------------------------------------------------------------ step
    def _launch(self, shares, fn):
        """fn(replica, its share) on every replica, each under its device,
        none read back."""
        outs = []
        for rep, share in zip(self.replicas, shares):
            with on_device(rep.device):
                outs.append(fn(rep, share))
        return outs

    def step_async(self, frames, debug: bool = False):
        """BatchTracker.step_async: the (S, 5) rows (and with debug the maps)
        on the first replica's device."""
        outs = self._launch(self._split(self._pad(frames)),
                            lambda rep, f: rep.step_async(f, debug=debug))
        if debug:
            return tuple(torch.cat([o[k].to(self.device) for o in outs])[:self.S]
                         for k in range(2))
        return torch.cat([o.to(self.device) for o in outs])[:self.S]

    def step(self, frames) -> np.ndarray:
        outs = self._launch(self._split(self._pad(frames)),
                            lambda rep, f: rep.step_async(f))
        return np.concatenate([o.double().cpu().numpy() for o in outs])[:self.S]

    def _block_shares(self, frames_t) -> list:
        """A (T, S, H, W, 3) block (or T lists of S frames) cut into one
        (T, S_pad/n, ...) share a replica."""
        if isinstance(frames_t, (list, tuple)):
            rows = [self._split(self._pad(list(f))) for f in frames_t]
            return [[r[i] for r in rows] for i in range(len(self.replicas))]
        padded = self._pad(frames_t, axis=1)
        return [padded[:, i * self.per:(i + 1) * self.per] for i in range(len(self.replicas))]

    def step_many_async(self, frames_t) -> torch.Tensor:
        outs = self._launch(self._block_shares(frames_t),
                            lambda rep, f: rep.step_many_async(f))
        return torch.cat([o.to(self.device) for o in outs], dim=1)[:, :self.S]

    def step_many(self, frames_t) -> np.ndarray:
        outs = self._launch(self._block_shares(frames_t),
                            lambda rep, f: rep.step_many_async(f))
        return np.concatenate([o.double().cpu().numpy() for o in outs], axis=1)[:, :self.S]

    def step_many_cost(self, frames_t) -> dict:
        """The replicas' step_many_cost summed: every device's streams, the
        pad streams included ("streams" = S_pad, the JAX package's count),
        and the weights once per replica."""
        costs = [rep.step_many_cost(f) for rep, f in zip(self.replicas,
                                                          self._block_shares(frames_t))]
        return {k: sum(c[k] for c in costs) for k in ("flops", "bytes", "streams")}
