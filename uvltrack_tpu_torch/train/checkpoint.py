"""Checkpoint save and restore with the reference's retention and resume
contract (port of uvltrack_tpu/train/checkpoint.py; BaseTrainer
checkpointing, lib/train/trainers/base_trainer.py:115-232): atomic writes
(a tmp file, then os.rename), the last 10 epochs kept plus every 20th,
resume from the latest, a given epoch or an explicit path.

A checkpoint is ep%04d.pt: torch.save of {"state": the TrainState's state
dict (model, optimizer, step), "extra": ..., "epoch": ...}, every tensor
copied to the host first.
"""

from __future__ import annotations

import glob
import os
import re
import threading
from typing import Any, Optional, Tuple

import torch


def to_host(obj):
    """A copy of a (nested) state dict with every tensor detached and cloned
    on the CPU: the snapshot save_async takes before the step moves on."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 10, keep_every: int = 20):
        self.directory = os.path.abspath(directory)
        self.keep_last = keep_last
        self.keep_every = keep_every
        os.makedirs(self.directory, exist_ok=True)
        self._inflight: Optional[threading.Thread] = None
        self._inflight_error: Optional[BaseException] = None

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"ep{epoch:04d}.pt")

    def wait(self) -> None:
        """Join an in-flight async save (a no-op when none) and re-raise any
        error its write hit: a checkpoint lost in silence would defeat the
        fail-safe restart."""
        t = self._inflight
        if t is None or t is threading.current_thread():
            return  # none, or _gc -> epochs() inside the save worker itself
        t.join()
        self._inflight = None
        if self._inflight_error is not None:
            err, self._inflight_error = self._inflight_error, None
            raise err

    def _write(self, payload: dict, path: str) -> None:
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.rename(tmp, path)  # atomic
        self._gc()

    def save_async(self, epoch: int, state: Any, extra: Optional[dict] = None) -> str:
        """Non-blocking save: the host snapshot happens here, synchronously
        (the next step updates the state in place), and the write plus the
        retention GC run in a thread, overlapping the next epoch. At most
        one save is in flight; a second call joins the first. Durable at
        wait() (restore, epochs and has_checkpoint join implicitly)."""
        self.wait()
        payload = {"state": to_host(state.state_dict()), "extra": extra or {}, "epoch": epoch}
        path = self._path(epoch)

        def work():
            try:
                self._write(payload, path)
            except BaseException as e:  # surfaced by the next wait()
                self._inflight_error = e

        t = threading.Thread(target=work, name=f"ckpt-save-ep{epoch}", daemon=True)
        t.start()
        self._inflight = t
        return path

    def save(self, epoch: int, state: Any, extra: Optional[dict] = None) -> str:
        path = self._path(epoch)
        self._write({"state": to_host(state.state_dict()), "extra": extra or {},
                     "epoch": epoch}, path)
        return path

    def epochs(self):
        self.wait()
        out = []
        for p in glob.glob(os.path.join(self.directory, "ep*.pt")):
            m = re.match(r"ep(\d+)\.pt$", os.path.basename(p))
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _gc(self):
        eps = self.epochs()
        keep = set(eps[-self.keep_last:]) | {e for e in eps if e % self.keep_every == 0}
        for e in eps:
            if e not in keep:
                try:
                    os.remove(self._path(e))
                except OSError:
                    pass

    def _latest_path(self) -> str:
        eps = self.epochs()
        if not eps:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return self._path(eps[-1])

    def restore(self, state: Any, epoch: Optional[int] = None,
                path: Optional[str] = None) -> Tuple[Any, dict, int]:
        """Load a checkpoint into `state` in place (its model, optimizer and
        step); returns (state, extra, epoch). epoch=None: the latest."""
        self.wait()
        if path is None:
            path = self._latest_path() if epoch is None else self._path(epoch)
        payload = torch.load(path, map_location="cpu", weights_only=True)
        state.load_state_dict(payload["state"])
        return state, payload.get("extra", {}), int(payload["epoch"])

    def restore_raw(self, path: Optional[str] = None) -> Tuple[dict, dict, int]:
        """Without a state to load into: (the state dict, extra, epoch)."""
        self.wait()
        payload = torch.load(path or self._latest_path(), map_location="cpu",
                             weights_only=True)
        return payload["state"], payload.get("extra", {}), int(payload["epoch"])

    def has_checkpoint(self) -> bool:
        return bool(self.epochs())
