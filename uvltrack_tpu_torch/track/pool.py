"""Continuous batching for tracking: streams join and leave a fixed-capacity
lockstep batch (port of uvltrack_tpu/track/pool.py; the reference serves
nothing).

BatchTracker advances S streams that start together. StreamPool keeps S
slots of one BatchTracker and lets streams come and go:

- open(stream, frame, info): claims a free slot (slot 0 first) and
  initializes it alone -- NL grounding, template crop, prompt, text row --
  writing its rows in place into the batched tensors; the other slots'
  rows are not touched;
- submit({stream: frame}): one BatchTracker.step over the full capacity
  with only the pending slots active; the others keep their state. On a
  CUDA device it replays the JitTracker's graphs at batch `capacity`: each
  replay copies the BatchTracker's state in, so the rows open wrote reach
  the graph (and its constants, whose token open renews);
- close(stream): frees the slot; its stale rows wait for the next open.

All frames of one submit share a resolution; a stream may change
resolution between rounds.

mesh= (a parallel/mesh.py Mesh) shards the slots over its data axis as
BatchTracker(mesh=) does: the capacity is padded to a multiple of the data
shards, and the pad slots stay free and frozen; open writes a stream's
rows into the replica that holds its slot.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .batch import BatchTracker, on_device


class StreamPool:
    """Continuous-batching pool over one BatchTracker of `capacity` streams:
    StreamPool(cfg, model, capacity, tokenizer=None, jit_tracker=None,
    graphs=True, mesh=None)."""

    def __init__(self, cfg, model, capacity: int, tokenizer=None, jit_tracker=None,
                 graphs: bool = True, mesh=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.bt = BatchTracker(cfg, model, capacity, tokenizer=tokenizer,
                               jit_tracker=jit_tracker, graphs=graphs, mesh=mesh)
        self.capacity = capacity
        self.slot_of: Dict[str, int] = {}
        self._free = list(range(capacity - 1, -1, -1))  # pop() -> slot 0 first
        for bt in self.bt.replicas:
            S, dev, ts = bt.S, bt.device, bt.template_size
            z = (ts // 16) ** 2
            # the batched tensors BatchTracker.initialize would make, all zero
            # and every slot free; the text rows typed by the encoder on zero
            # ids, so a row write always matches
            bt.text_ids = torch.zeros((S, bt.nt), dtype=torch.int32, device=dev)
            bt.text_mask = torch.zeros((S, bt.nt), dtype=torch.int32, device=dev)
            bt.flags = torch.zeros((S,), dtype=torch.int32, device=dev)
            bt.template = torch.zeros((S, ts, ts, 3), dtype=torch.float32, device=dev)
            bt.template_mask = torch.zeros((S, z), dtype=torch.bool, device=dev)
            with torch.no_grad(), on_device(dev):
                bt.txt = (bt.model.encode_text(bt.text_ids, bt.text_mask) if bt.cache_text
                          else bt.text_ids)
            prompt = torch.zeros((S, 3, bt.embed_dim), dtype=bt.model.box_head.dtype,
                                 device=dev)
            bt.state = bt.fresh_state(torch.zeros((S, 4), dtype=torch.float32, device=dev),
                                      prompt, np.zeros((S,), bool))
            bt.consts_changed()

    # ------------------------------------------------------------ lifecycle
    @torch.no_grad()
    def open(self, stream: str, frame: np.ndarray, info: dict) -> list:
        """Claim a slot and initialize it alone; returns the frame-0 box
        (grounded in NL mode, else info["init_bbox"]) like
        Tracker.initialize."""
        if stream in self.slot_of:
            slot = self.slot_of[stream]  # re-initialize in place
        elif self._free:
            slot = self._free.pop()
        else:
            raise RuntimeError(f"pool full ({self.capacity} slots); close a stream first")
        bt, i = self.bt.locate(slot)  # the replica holding the slot, and its row there
        with on_device(bt.device):
            box = self._init_row(bt, i, frame, info)
        self.slot_of[stream] = slot
        return box

    @staticmethod
    def _init_row(bt, i: int, frame: np.ndarray, info: dict) -> list:
        """Initialize row i of BatchTracker bt alone, in place."""
        mode = bt.cfg.TEST.MODE
        ids, mask, flag = bt.text_row(info.get("language"), mode)
        ids, mask = bt.to_device(ids[None]), bt.to_device(mask[None])
        flag = bt.to_device(np.asarray([flag], np.int32))
        frame_t = bt.device_frames(frame[None])
        if mode == "NL":
            box = bt.ground(frame_t[0], ids, mask)
        else:
            box = [float(v) for v in info["init_bbox"]]
        box_t = bt.to_device(np.asarray([box], np.float32))
        template, template_mask, prompt = bt.init_rows(frame_t, box_t, ids, mask, flag)
        txt = bt.model.encode_text(ids, mask) if bt.cache_text else ids
        st = bt.state
        for batched, row in ((bt.text_ids, ids), (bt.text_mask, mask), (bt.flags, flag),
                             (bt.template, template), (bt.template_mask, template_mask),
                             (bt.txt, txt), (st.box, box_t), (st.prompt, prompt)):
            batched[i] = row[0]
        for batched in (st.max_score, st.best_box_net, st.best_search, st.best_template,
                        st.best_vis_token, st.best_txt_token, bt._remines):
            batched[i] = 0
        st.frame_id[i] = 0
        # the rows were written in place: a graph copies the constants in again
        bt.consts_changed()
        return box

    def close(self, stream: str) -> None:
        i = self.slot_of.pop(stream, None)
        if i is None:
            raise LookupError(f"stream {stream!r} not open")
        self._free.append(i)

    # -------------------------------------------------------------- serving
    def submit(self, frames: Dict[str, np.ndarray]) -> Dict[str, dict]:
        """Advance every stream with a pending frame in one batched step;
        streams not in `frames` keep their state. Returns {stream: {"bbox":
        [...], "score": s}} for the pending streams."""
        if not frames:
            return {}
        unknown = [s for s in frames if s not in self.slot_of]
        if unknown:
            raise LookupError(f"streams not open: {unknown}")
        hws = {f.shape[:2] for f in frames.values()}
        if len(hws) != 1:
            raise ValueError(f"one submit = one resolution (got {sorted(hws)}); "
                             "bucket mixed-resolution rounds upstream")
        (h, w), = hws
        batch = np.zeros((self.capacity, h, w, 3), np.uint8)
        active = np.zeros((self.capacity,), bool)
        for stream, f in frames.items():
            batch[self.slot_of[stream]] = f
            active[self.slot_of[stream]] = True
        self.bt.set_active(active)
        packed = self.bt.step(batch)
        return {stream: {"bbox": packed[self.slot_of[stream], :4].tolist(),
                         "score": float(packed[self.slot_of[stream], 4])}
                for stream in frames}

    @property
    def open_streams(self) -> list:
        return sorted(self.slot_of)
