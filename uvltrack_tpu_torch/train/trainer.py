"""Epoch-loop trainer with fail-safe restart, metric meters and logging
(port of uvltrack_tpu/train/trainer.py; BaseTrainer/LTRTrainer,
lib/train/trainers/base_trainer.py:63-110, ltr_trainer.py:67-190): per-epoch
train and interval validation, loss/IoU AverageMeters with FPS printed every
PRINT_INTERVAL, a checkpoint per epoch with crash-resume (reload the latest
and continue), an append-only log and its .jsonl twin.

Data parallel (mesh=, a parallel/mesh.py Mesh over a process group): every
rank runs the loop on the same global batches (the step keeps its rows);
only process 0 logs and writes checkpoints, but every rank enters the
state snapshot (ZeRO-1 gathers the Adam moments there, a collective).
Each batch fetch ends in an agreement (one all_reduce): when one rank's
loader raises, every rank aborts the epoch, so no rank waits alone in a
collective, and the fail-safe restarts all of them from the last
checkpoint (written and visible before any rank reads it).
"""

from __future__ import annotations

import json
import os
import time
import traceback
from collections import defaultdict
from typing import Callable, Iterable, Optional

from .checkpoint import CheckpointManager


class AverageMeter:
    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


def _fmt_stats(d: dict) -> str:
    """'k: v.vvvvv' pairs, key-sorted: the stats-line format of the interval,
    val and epoch-summary log lines (meters or plain floats)."""
    return "  ".join(f"{k}: {(v.avg if isinstance(v, AverageMeter) else v):.5f}"
                     for k, v in sorted(d.items()))


def _rows(batch: dict) -> int:
    """Search frames x samples of a (global) batch."""
    return batch["search_images"].shape[0] * batch["search_images"].shape[1]


class Trainer:
    def __init__(self, cfg, train_step: Callable, state, train_loader: Iterable,
                 val_loaders: Optional[dict] = None, eval_step: Optional[Callable] = None,
                 checkpoint_dir: str = "checkpoints/train/uvltrack/default",
                 log_path: Optional[str] = None, to_device: Optional[Callable] = None,
                 mesh=None):
        self.cfg = cfg
        self.train_step = train_step
        self.eval_step = eval_step
        self.state = state
        self.train_loader = train_loader
        self.val_loaders = val_loaders or {}
        self.to_device = to_device or (lambda b: b)
        self.ckpt = CheckpointManager(checkpoint_dir)
        self.log_path = log_path
        self.mesh = mesh if mesh is not None and mesh.distributed else None
        # one writer: ranks saving to one path would interleave their writes
        self.is_main = self.mesh is None or self.mesh.is_main
        self.epoch = 0
        if log_path and self.is_main:
            os.makedirs(os.path.dirname(log_path), exist_ok=True)

    def _log(self, msg: str):
        if not self.is_main:
            return
        print(msg, flush=True)
        if self.log_path:
            with open(self.log_path, "a") as f:
                f.write(msg + "\n")

    def _log_metrics(self, record: dict):
        if self.log_path and self.is_main:
            with open(self.log_path + ".jsonl", "a") as f:
                f.write(json.dumps(record) + "\n")

    def train_epoch(self) -> dict:
        meters = defaultdict(AverageMeter)
        t_start = time.time()
        n_frames = 0
        interval = int(self.cfg.TRAIN.PRINT_INTERVAL)
        # the metrics stay on the device until a print boundary: reading
        # them every step would stall the host on each step's scalars
        pending = []

        def drain():
            for metrics, bs in pending:
                for k, v in metrics.items():
                    meters[k].update(float(v), bs)
            pending.clear()

        for i, batch in enumerate(self._batches(self.train_loader), start=1):
            bs = _rows(batch)  # the global batch's, before a rank takes its share
            batch = self.to_device(batch)
            self.state, metrics = self.train_step(self.state, batch)
            n_frames += bs
            pending.append((metrics, bs))
            if i % interval == 0:
                drain()
                fps = n_frames / (time.time() - t_start)
                self._log(f"[train: {self.epoch}, {i}] FPS: {fps:.1f}  " + _fmt_stats(meters))
        drain()
        return {k: m.avg for k, m in meters.items()}

    def validate(self) -> dict:
        out = {}
        if self.eval_step is None:
            return out
        for name, loader in self.val_loaders.items():
            meters = defaultdict(AverageMeter)
            for batch in self._batches(loader):
                bs = _rows(batch)
                batch = self.to_device(batch)
                metrics = self.eval_step(self.state, batch)
                for k, v in metrics.items():
                    meters[k].update(float(v), bs)
            out[name] = {k: m.avg for k, m in meters.items()}
            self._log(f"[val {name}: {self.epoch}] " + _fmt_stats(meters))
        return out

    def _batches(self, loader):
        """The loader's batches; under a process group each fetch ends in an
        agreement, and a rank whose loader raised, or ran out, makes every
        rank raise, or stop, there."""
        if self.mesh is None:
            yield from loader
            return
        from ..parallel.dp import agree

        it = iter(loader)
        while True:
            error, done, batch = None, False, None
            try:
                batch = next(it)
            except StopIteration:
                done = True
            except Exception as e:  # raised below, on every rank alike
                error = e
            failed, finished = agree([error is not None, done], self.mesh.devices[0])
            if failed:
                raise error or RuntimeError("another rank's loader failed")
            if finished:
                return
            yield batch

    def _sync(self) -> None:
        """Every rank here, process 0's in-flight save written (a no-op in one
        process)."""
        if self.mesh is not None:
            from ..parallel.dp import agree

            agree([False], self.mesh.devices[0])

    def _save(self, epoch: int, extra: dict) -> None:
        """The epoch's checkpoint: every rank takes the snapshot, process 0
        writes it (in the background; durable at ckpt.wait())."""
        if self.mesh is None:
            self.ckpt.save_async(epoch, self.state, extra)
            return
        snapshot = _Snapshot(self.state.state_dict())  # a collective under ZeRO-1
        if self.is_main:
            self.ckpt.save_async(epoch, snapshot, extra)  # copies to the host here

    def train(self, max_epochs: int, load_latest: bool = True, fail_safe: bool = True,
              max_retries: int = 10):
        if load_latest and self.ckpt.has_checkpoint():
            self.state, _, self.epoch = self.ckpt.restore(self.state)
            self._log(f"resumed from epoch {self.epoch}")
        retries = 0
        while self.epoch < max_epochs:
            try:
                self.epoch += 1
                train_stats = self.train_epoch()
                val_interval = int(self.cfg.TRAIN.VAL_EPOCH_INTERVAL)
                val_stats = (self.validate() if val_interval > 0
                             and self.epoch % val_interval == 0 else {})
                # the host snapshot happens inside save_async; the write
                # overlaps the next epoch, and wait() below makes it durable
                self._save(self.epoch, {"train": train_stats, "val": val_stats})
                self._log_metrics({"epoch": self.epoch, "train": train_stats,
                                   "val": val_stats, "time": time.time()})
                self._log(f"[epoch {self.epoch}/{max_epochs}] " + _fmt_stats(train_stats))
                retries = 0
            except Exception:
                if not fail_safe or retries >= max_retries:
                    raise
                retries += 1
                self._log(f"epoch {self.epoch} crashed (retry {retries}):\n"
                          + traceback.format_exc())
                self.epoch -= 1
                # a deferred async-save error first: re-raised out of
                # has_checkpoint()/restore() it would replace the recovery
                # with a stale disk error; the restore reads the last save
                # that landed
                try:
                    self.ckpt.wait()
                except Exception:
                    self._log("async checkpoint save had failed:\n" + traceback.format_exc())
                self._sync()
                if self.ckpt.has_checkpoint():
                    self.state, _, self.epoch = self.ckpt.restore(self.state)
                    self._log(f"restarted from epoch {self.epoch}")
        self.ckpt.wait()  # the last epoch's save is durable on return
        self._sync()
        return self.state


class _Snapshot:
    """A state dict taken already, for CheckpointManager.save_async."""

    def __init__(self, state: dict):
        self._state = state

    def state_dict(self) -> dict:
        return self._state
