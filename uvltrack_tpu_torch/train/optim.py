"""Optimizer and LR schedules (port of uvltrack_tpu/train/optim.py; parity
with get_optimizer_scheduler, lib/train/base_functions.py:196-224).

AdamW (betas 0.9/0.999, eps 1e-8, decoupled weight decay) in two parameter
groups, the backbone at LR x BACKBONE_MULTIPLIER, after a clip of the
gradients' global norm (GRAD_CLIP_NORM), with step / multi-step /
warmup-multistep / cosine schedules stepped per epoch. The position
embeddings are frozen unless MODEL.LEARNABLE_POSITION (the model's
`backbone.learnable_pos`, which build_model sets from it): they keep their
gradients (autograd computes them) and are never updated, as the JAX
package's optax `set_to_zero` group.

The JAX package chains the clip BEFORE multi_transform, so the global norm
(and the logged grad_norm) counts the frozen leaves' gradients too;
TrainOptimizer.step does the same.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn


def param_labels(model: nn.Module, learnable_pos: bool = False) -> dict:
    """{parameter name: 'backbone' (LR x multiplier), 'head' or 'frozen'};
    learnable_pos (MODEL.LEARNABLE_POSITION, requires_grad of the
    reference's pos_embed_z/x, mae_vit.py:120-121) moves the position
    embeddings from 'frozen' into the backbone group."""
    def label(name):
        if not learnable_pos and ("pos_embed_z" in name or "pos_embed_x" in name):
            return "frozen"
        return "backbone" if name.startswith("backbone") else "head"

    return {name: label(name) for name, _ in model.named_parameters()}


def lr_schedule(cfg, steps_per_epoch: int) -> Callable[[int], float]:
    """step -> LR: the reference's torch schedulers, stepped per epoch
    (epoch = step // steps_per_epoch)."""
    base = float(cfg.TRAIN.LR)
    kind = cfg.TRAIN.SCHEDULER.TYPE
    epochs = int(cfg.TRAIN.EPOCH)
    sch = cfg.TRAIN.SCHEDULER

    def epoch_of(step):
        return int(step) // steps_per_epoch

    if kind == "step":
        drop, rate = int(cfg.TRAIN.LR_DROP_EPOCH), float(sch.DECAY_RATE)
        return lambda step: base * (rate if epoch_of(step) >= drop else 1.0)
    if kind == "Mstep":
        milestones, gamma = list(sch.MILESTONES), float(sch.GAMMA)
        return lambda step: base * gamma ** sum(epoch_of(step) >= m for m in milestones)
    if kind == "WarmMstep":
        warm, milestones, gamma = int(sch.WARM_EPOCH), list(sch.MILESTONES), float(sch.GAMMA)

        def warm_mstep(step):
            e = epoch_of(step)
            if e < warm:
                return base * (e + 1) / max(warm, 1)
            return base * gamma ** sum(e >= m for m in milestones)
        return warm_mstep
    if kind == "CosineAnnealingLR":  # T_max=EPOCH, eta_min=0
        return lambda step: base * 0.5 * (1.0 + math.cos(math.pi * epoch_of(step) / epochs))
    raise ValueError(f"unknown scheduler {kind!r}")


def global_norm(tensors, split=(), tp=None) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm).
    Under tensor parallelism `split` are this rank's slices of the split
    leaves, whose squares are summed over the model group (tp, a parallel/
    tp.py TensorParallel); `tensors`, replicated, count once."""
    sq = sum((t.float() ** 2).sum() for t in tensors)
    if split:
        sq = sq + tp.all_reduce_(sum((t.float() ** 2).sum() for t in split))
    return torch.sqrt(sq)


class TrainOptimizer:
    """clip_by_global_norm, then AdamW per group at the scheduled LR (the
    JAX package's optax chain). `params` are every parameter with a
    gradient (the frozen ones too, for the norm); `adamw` holds the two
    trained groups, each with its LR scale.

    zero1 (a parallel/dp.py DataParallel of n > 1 shards; TPU.ZERO1): the
    Adam moments of each trained parameter are kept only for this rank's
    slice along the axis parallel/mesh.zero1_axis picks (the JAX package's
    zero1_moment_sharding rule on the torch layout; a parameter no axis of
    which n divides stays whole). A step clips the full (reduced, equal on
    every rank) gradients, runs AdamW on this rank's slices and all-gathers
    the slices back into the parameters. state_dict() gathers the moments
    (a collective every rank enters) and returns the replicated optimizer's
    state dict, so a checkpoint resumes at any data-parallel width.

    tp (a parallel/tp.py TensorParallel; the model split by
    shard_params_tp): the global norm sums the split leaves' squares over
    the model group and counts the replicated ones once; ZeRO-1 partitions
    each rank's slices over the data axis; state_dict() also gathers the
    split parameters' moments into whole tensors in JAX's layout (and
    load_state_dict takes whole ones), so a checkpoint resumes at tp=1."""

    def __init__(self, cfg, model: nn.Module, steps_per_epoch: int = 1, zero1=None, tp=None):
        from ..parallel.tp import split_params

        # the model's own MODEL.LEARNABLE_POSITION (build_model reads it)
        labels = param_labels(model, model.backbone.learnable_pos)
        named = dict(model.named_parameters())
        self.params = list(named.values())
        self.zero1, self.tp = zero1, tp
        # tensor parallelism: {id of a split parameter: (its name, split dim)}
        self.split = ({id(named[n]): (n, d) for n, d in split_params(model).items()}
                      if tp is not None else {})
        self.slices = []  # ZeRO-1: (parameter, its slice, axis), in the groups' order
        mult = float(cfg.TRAIN.BACKBONE_MULTIPLIER)
        groups = [{"params": [self._owned(named[n]) for n, lab in labels.items() if lab == group],
                   "scale": scale, "label": group}
                  for group, scale in (("backbone", mult), ("head", 1.0))]
        self.schedule = lr_schedule(cfg, steps_per_epoch)
        self.clip = float(cfg.TRAIN.GRAD_CLIP_NORM)
        self.adamw = torch.optim.AdamW([g for g in groups if g["params"]], lr=float(cfg.TRAIN.LR),
                                       betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=float(cfg.TRAIN.WEIGHT_DECAY))

    def _owned(self, p: torch.Tensor) -> torch.Tensor:
        """What AdamW updates for parameter p: p itself, or under ZeRO-1 a
        tensor of this rank's slice of it (refreshed from p every step)."""
        from ..parallel.mesh import zero1_axis

        axis = zero1_axis(tuple(p.shape), self.zero1.size) if self.zero1 is not None else None
        if axis is None:
            return p
        piece = self._slice(p, axis).detach().clone()
        self.slices.append((p, piece, axis))
        return piece

    def _slice(self, t: torch.Tensor, axis: int) -> torch.Tensor:
        n = t.shape[axis] // self.zero1.size
        return t.narrow(axis, self.zero1.index * n, n)

    def step(self, step: int) -> torch.Tensor:
        """Clip the gradients in place and update; returns the global norm
        of the gradients before the clip (the step's grad_norm)."""
        rest = [p.grad for p in self.params if p.grad is not None and id(p) not in self.split]
        split = [p.grad for p in self.params if p.grad is not None and id(p) in self.split]
        norm = global_norm(rest, split, self.tp)
        grads = rest + split
        if self.clip > 0:
            # optax: g / norm * clip where norm >= clip (no device->host read)
            scale = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
            for g in grads:
                g.mul_(scale)
        for p, piece, axis in self.slices:
            with torch.no_grad():
                piece.copy_(self._slice(p, axis))
            piece.grad = None if p.grad is None else self._slice(p.grad, axis).contiguous()
        lr = self.schedule(step)
        for group in self.adamw.param_groups:
            group["lr"] = lr * group["scale"]
        self.adamw.step()
        if self.slices:
            self._gather_params()
        return norm

    def _gather(self, pieces, axes) -> list:
        """Every rank's slices of `pieces` (one all_gather of their
        concatenation), each concatenated along its axis: the full tensors."""
        import torch.distributed as dist

        flat = torch.cat([t.reshape(-1) for t in pieces])
        parts = [torch.empty_like(flat) for _ in range(self.zero1.size)]
        dist.all_gather(parts, flat, group=self.zero1.group)
        sizes = [t.numel() for t in pieces]
        per_rank = [part.split(sizes) for part in parts]
        return [torch.cat([r[j].view_as(t) for r in per_rank], dim=axis)
                for j, (t, axis) in enumerate(zip(pieces, axes))]

    @torch.no_grad()
    def _gather_params(self) -> None:
        full = self._gather([piece for _, piece, _ in self.slices],
                            [axis for _, _, axis in self.slices])
        for (p, _, _), value in zip(self.slices, full):
            p.copy_(value)

    def moment_bytes(self) -> int:
        """Bytes of the Adam moments this rank holds."""
        return sum(v.numel() * v.element_size() for st in self.adamw.state.values()
                   for k, v in st.items() if k in ("exp_avg", "exp_avg_sq"))

    def _sliced_indices(self) -> dict:
        """{index in the state dict: axis} of the ZeRO-1 slices."""
        owned = [p for g in self.adamw.param_groups for p in g["params"]]
        axis_of = {id(piece): axis for _, piece, axis in self.slices}
        return {i: axis_of[id(p)] for i, p in enumerate(owned) if id(p) in axis_of}

    def _split_indices(self) -> dict:
        """{index in the state dict: (name, dim)} of the tensor-parallel
        split parameters."""
        of_piece = {id(piece): id(p) for p, piece, _ in self.slices}
        owned = [p for g in self.adamw.param_groups for p in g["params"]]
        return {i: self.split[of_piece.get(id(p), id(p))] for i, p in enumerate(owned)
                if of_piece.get(id(p), id(p)) in self.split}

    def state_dict(self) -> dict:
        state = self.adamw.state_dict()
        sliced = self._sliced_indices()
        split = self._split_indices()
        if not (sliced or split):
            return state
        out = {"state": {i: dict(st) for i, st in state["state"].items()},
               "param_groups": state["param_groups"]}
        keys = [(i, k) for i in sliced if i in state["state"]
                for k in ("exp_avg", "exp_avg_sq")]
        full = self._gather([state["state"][i][k] for i, k in keys],
                            [sliced[i] for i, _ in keys]) if keys else []
        for (i, k), value in zip(keys, full):
            out["state"][i][k] = value
        for i in sorted(split):  # the same order on every rank of the model group
            if i in out["state"]:
                name, dim = split[i]
                for k in ("exp_avg", "exp_avg_sq"):
                    out["state"][i][k] = self.tp.gather(name, out["state"][i][k], dim)
        return out

    def load_state_dict(self, state: dict) -> None:
        from ..parallel.tp import shard_tensor

        split = self._split_indices()
        if split:  # whole moments -> this rank's slices
            state = {"state": {i: {k: (shard_tensor(split[i][0], v, split[i][1], self.tp.size,
                                                    self.tp.index).clone()
                                       if i in split and k in ("exp_avg", "exp_avg_sq") else v)
                                   for k, v in st.items()}
                               for i, st in state["state"].items()},
                     "param_groups": state["param_groups"]}
        sliced = self._sliced_indices()
        if sliced:
            state = {"state": {i: {k: (self._slice(v, sliced[i]).clone()
                                       if i in sliced and k in ("exp_avg", "exp_avg_sq") else v)
                                   for k, v in st.items()}
                               for i, st in state["state"].items()},
                     "param_groups": state["param_groups"]}
        self.adamw.load_state_dict(state)


def build_optimizer(cfg, model: nn.Module, steps_per_epoch: int = 1,
                    zero1=None, tp=None) -> TrainOptimizer:
    return TrainOptimizer(cfg, model, steps_per_epoch, zero1=zero1, tp=tp)
