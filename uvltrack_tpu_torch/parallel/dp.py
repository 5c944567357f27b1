"""Data parallelism across processes: the context the train step sets and
the collectives of the computations that span rows.

The JAX mesh step is one SPMD program over the global batch, so its result
is the single-device step on the global batch. The port's dp=n step holds
to that: each rank runs the forward and backward on its rows, and the four
places that compute across rows read the context (`current()`) and reach
the other ranks:

- BatchNorm's batch statistics: the per-channel sums, sums of squares and
  count, all-reduced (models/head.py);
- the half-batch rotation of the prompt mining and the context mask: local
  when the frame-major flatten has an even number of search frames (row
  (f, b) pairs with ((f + n/2) mod n, b), the same sample), else an
  exchange of the rows (core/geometry.py);
- the weighted CE's denominator, all-reduced (train/losses.py);
- drop path's keep masks, drawn for the global rows from the same-seeded
  generator on every rank (models/mufe.py).

Convention: each rank's loss is n x its share of the global loss, so the
mean over ranks of the losses, and of the gradients (the gradient
all-reduce divides by n), is the global one. A mean over rows of equal
size is already such a share; a sum (the weighted CE's numerator, the focal
loss under REDUCTION 'sum') is scaled by n. The autograd Functions below
all-reduce their gradients, so a rank's backward carries what every rank's
loss owes its rows. Without a context (world size 1, inference) every
caller runs its single-device code.

Collectives used: all_reduce and all_gather, nothing else.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class DataParallel:
    """This rank's place among `size` data shards: its `index`, the process
    `group` (None: the default group) and the search frames of the
    frame-major flatten its rows follow (`frames`, set by the actor)."""
    size: int
    index: int
    group: Any = None
    frames: int = 1

    @classmethod
    def of(cls, mesh) -> Optional["DataParallel"]:
        """The context of a parallel/mesh.py Mesh; None when it has one data shard."""
        return cls(mesh.data, mesh.data_index, mesh.group) if mesh.data > 1 else None

    # ------------------------------------------------------------ no grad
    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """In place: the sum over ranks."""
        dist.all_reduce(t, group=self.group)
        return t

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over ranks of a tensor (a copy)."""
        return self.all_reduce_(t.detach().clone()).div_(self.size)

    # ------------------------------------------------------------ autograd
    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks; its gradient is the sum of every rank's."""
        return _AllReduce.apply(t, self)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """(frames * B_local, ...) rows of every rank in the global frame-major
        order, (frames * B_global, ...); the gradient of this rank's rows
        sums every rank's."""
        return _GatherRows.apply(x, self)

    def local_rows(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's rows of a global frame-major tensor along `dim`."""
        x = x.movedim(dim, 0)
        rows = x.shape[0] // (self.frames * self.size)
        x = x.reshape(self.frames, self.size, rows, *x.shape[1:])[:, self.index]
        return x.reshape(self.frames * rows, *x.shape[2:]).movedim(0, dim)

    def rotate_half_batch(self, x: torch.Tensor) -> torch.Tensor:
        """geometry.rotate_half_batch of the global rows, this rank's share."""
        g = self.gather_rows(x)
        h = g.shape[0] // 2
        return self.local_rows(torch.cat([g[h:], g[:h]], dim=0))


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dp):
        ctx.dp = dp
        return dp.all_reduce_(t.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.dp.all_reduce_(g.clone()), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
        parts = [torch.empty_like(wire) for _ in range(dp.size)]
        dist.all_gather(parts, wire, group=dp.group)
        rows = x.shape[0] // dp.frames
        g = torch.stack(parts).reshape(dp.size, dp.frames, rows, *x.shape[1:]).transpose(0, 1)
        return g.reshape(dp.frames * dp.size * rows, *x.shape[1:]).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return ctx.dp.local_rows(ctx.dp.all_reduce_(g.contiguous().clone())), None


_CURRENT: contextvars.ContextVar = contextvars.ContextVar("uvltrack_data_parallel",
                                                         default=None)


def current() -> Optional[DataParallel]:
    """The data-parallel context of this thread's step, or None."""
    return _CURRENT.get()


@contextlib.contextmanager
def scope(dp: Optional[DataParallel], frames: Optional[int] = None):
    """Run the body under `dp` (None: no data parallelism), its frames set
    when given."""
    if dp is not None and frames is not None:
        dp = dataclasses.replace(dp, frames=frames)
    token = _CURRENT.set(dp)
    try:
        yield dp
    finally:
        _CURRENT.reset(token)


# elements a gradient all_reduce carries at most: bounds the flat copy's memory
BUCKET = 1 << 24


def reduce_gradients(params, dp: DataParallel) -> None:
    """Average every parameter's gradient over the ranks: the gradients
    flattened into buckets of at most BUCKET elements (one bigger gradient
    alone), one all_reduce a bucket after the backward."""
    grads = [p.grad for p in params if p.grad is not None]
    start = 0
    while start < len(grads):
        end, n = start + 1, grads[start].numel()
        while end < len(grads) and n + grads[end].numel() <= BUCKET:
            n += grads[end].numel()
            end += 1
        chunk = grads[start:end]
        flat = dp.all_reduce_(torch.cat([g.reshape(-1) for g in chunk])).div_(dp.size)
        for g, part in zip(chunk, flat.split([g.numel() for g in chunk])):
            g.copy_(part.view_as(g))
        start = end


def agree(flags, device, group=None) -> list:
    """Each flag true on every rank if it is true on any (one all_reduce)."""
    t = torch.tensor([1.0 if f else 0.0 for f in flags], device=device)
    dist.all_reduce(t, group=group)
    return [bool(v > 0) for v in t.tolist()]
