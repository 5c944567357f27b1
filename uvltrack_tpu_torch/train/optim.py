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


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm)."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


class TrainOptimizer:
    """clip_by_global_norm, then AdamW per group at the scheduled LR (the
    JAX package's optax chain). `params` are every parameter with a
    gradient (the frozen ones too, for the norm); `adamw` holds the two
    trained groups, each with its LR scale."""

    def __init__(self, cfg, model: nn.Module, steps_per_epoch: int = 1):
        # the model's own MODEL.LEARNABLE_POSITION (build_model reads it)
        labels = param_labels(model, model.backbone.learnable_pos)
        named = dict(model.named_parameters())
        self.params = list(named.values())
        mult = float(cfg.TRAIN.BACKBONE_MULTIPLIER)
        groups = [{"params": [named[n] for n, lab in labels.items() if lab == group],
                   "scale": scale, "label": group}
                  for group, scale in (("backbone", mult), ("head", 1.0))]
        self.schedule = lr_schedule(cfg, steps_per_epoch)
        self.clip = float(cfg.TRAIN.GRAD_CLIP_NORM)
        self.adamw = torch.optim.AdamW([g for g in groups if g["params"]], lr=float(cfg.TRAIN.LR),
                                       betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=float(cfg.TRAIN.WEIGHT_DECAY))

    def step(self, step: int) -> torch.Tensor:
        """Clip the gradients in place and update; returns the global norm
        of the gradients before the clip (the step's grad_norm)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = global_norm(grads)
        if self.clip > 0:
            # optax: g / norm * clip where norm >= clip (no device->host read)
            scale = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
            for g in grads:
                g.mul_(scale)
        lr = self.schedule(step)
        for group in self.adamw.param_groups:
            group["lr"] = lr * group["scale"]
        self.adamw.step()
        return norm

    def state_dict(self) -> dict:
        return self.adamw.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state)


def build_optimizer(cfg, model: nn.Module, steps_per_epoch: int = 1) -> TrainOptimizer:
    return TrainOptimizer(cfg, model, steps_per_epoch)
