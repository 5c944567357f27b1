"""Host-to-device uploads through pinned host buffers, shared by the
tracker's frame uploads and the trainer's batch uploads (traced as the
spans stage.wait, stage.fill and stage.copy, utils/tracing.py)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import tracing


class PinnedStage:
    """Host-to-device uploads through pinned host buffers, two of each
    shape used in turn: a buffer is rewritten only after the copy that last
    read it has finished (its event), so the host never changes memory that
    a non-blocking copy still reads. On the CPU a plain copy."""

    def __init__(self):
        self._slots: Dict[tuple, list] = {}

    def upload(self, rows, out: torch.Tensor) -> None:
        """Copy `rows` -- an array, or a sequence of arrays, one per index
        of out's first dimension -- into the device tensor `out`."""
        if out.device.type != "cuda":
            with tracing.span("stage.fill"):
                arr = np.stack(rows) if isinstance(rows, (list, tuple)) else rows
                out.copy_(torch.from_numpy(np.ascontiguousarray(arr)).reshape(out.shape))
            return
        key = (tuple(out.shape), out.dtype)
        slots = self._slots.get(key)
        if slots is None:
            if len(self._slots) >= 8:  # a few shapes at a time
                for old in self._slots.values():
                    for _, ev in old[:2]:
                        ev.synchronize()
                self._slots.clear()
            slots = self._slots[key] = [
                [torch.empty(out.shape, dtype=out.dtype, pin_memory=True), torch.cuda.Event()]
                for _ in range(2)] + [0]
        buf, ev = slots[slots[2]]
        slots[2] ^= 1
        with tracing.span("stage.wait"):
            ev.synchronize()  # the copy that read this buffer last has finished
        with tracing.span("stage.fill"):
            host = buf.numpy()
            if isinstance(rows, (list, tuple)):
                for i, row in enumerate(rows):
                    host[i] = row
            else:
                host[...] = np.asarray(rows).reshape(host.shape)
        with tracing.span("stage.copy"):
            out.copy_(buf, non_blocking=True)
            ev.record(torch.cuda.current_stream(out.device))
