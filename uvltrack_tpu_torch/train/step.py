"""The training step: loss -> gradients -> clip -> AdamW (port of
uvltrack_tpu/train/step.py; the reference's DDP step,
lib/train/trainers/ltr_trainer.py:75-100).

TrainState holds the model (fp32 parameters and the BN running stats, its
buffers), the TrainOptimizer (Adam moments) and the step count; the step
updates all three in place.

Data parallel (setup_sharded_training over a parallel/mesh.py Mesh of n > 1
data shards, one process a shard): each rank steps its rows of the global
batch (parallel/mesh.shard_batch) under the parallel/dp.py context, so BN
statistics, the half-batch rotation, the weighted CE's denominator and drop
path span the global batch; after the backward (every microbatch's, under
TPU.GRAD_ACCUM) one bucketed all_reduce averages the gradients, and the
clip and AdamW then run on equal gradients on every rank (ZeRO-1 with
TPU.ZERO1, train/optim.py). The logged metrics are the global batch's,
averaged over the ranks. The result is the single-device step on the global
batch, as the JAX package's mesh step, up to the order of fp32 sums.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..parallel.dp import DataParallel, reduce_gradients, scope
from .actor import forward_and_loss
from .optim import TrainOptimizer, build_optimizer


@dataclass
class TrainState:
    model: nn.Module
    optimizer: TrainOptimizer
    step: int = 0

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])


def create_train_state(model: nn.Module, optimizer: TrainOptimizer) -> TrainState:
    return TrainState(model, optimizer, 0)


def _split_microbatches(batch: dict, k: int) -> dict:
    """Every leaf's B axis split into k leading microbatches (the JAX
    package's axis rule, step.py:38-56): leaves of ndim >= 3 are frame-major
    (n, B, ...) -> (k, n, B/k, ...); ndim <= 2 leaves are batch-leading,
    text/text_mask (B, Nt) and flag (B,) or (B, 1) -> (k, B/k, ...)."""
    b = batch["flag"].shape[0]

    def split(x):
        if x.ndim >= 3:
            assert x.shape[1] == b, (x.shape, b)
            return x.reshape(x.shape[0], k, b // k, *x.shape[2:]).transpose(0, 1)
        assert x.shape[0] == b, (x.shape, b)
        return x.reshape(k, b // k, *x.shape[1:])

    return {key: split(v) for key, v in batch.items()}


def _batch_norms(model: nn.Module):
    return [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]


def _mean_metrics(metrics: dict, dp: DataParallel) -> dict:
    """The metrics averaged over the ranks (one all_reduce)."""
    keys = sorted(metrics)
    values = dp.mean(torch.stack([metrics[k].float() for k in keys]))
    return dict(zip(keys, values.unbind(0)))


def make_train_step(model: nn.Module, optimizer: TrainOptimizer, cfg,
                    generator: torch.Generator | None = None,
                    dp: DataParallel | None = None):
    """train_step(state, batch) -> (state, metrics), metrics 0-d tensors on
    the device (the caller reads them when it logs). dp: the rank's
    data-parallel context (batch: its rows, shard_batch's), or None.

    cfg.TPU.GRAD_ACCUM > 1 sums the gradients of that many microbatches
    (backward after each, so activation memory scales with B/accum), then
    scales them by 1/accum under TRAIN.REDUCTION='mean', averages the
    metrics and keeps the BN running stats of the last microbatch's update
    (each microbatch starts from the step's stats), as the JAX scan does."""
    accum = int(getattr(cfg.TPU, "GRAD_ACCUM", 1) or 1)
    mean = str(cfg.TRAIN.REDUCTION).lower() == "mean"

    def train_step(state: TrainState, batch: dict):
        with scope(dp):
            metrics = _gradients(state, batch)
        if dp is not None:
            reduce_gradients(state.model.parameters(), dp)
            metrics = _mean_metrics(metrics, dp)
        metrics["grad_norm"] = state.optimizer.step(state.step)
        state.step += 1
        return state, metrics

    def _gradients(state: TrainState, batch: dict) -> dict:
        for p in state.model.parameters():
            p.grad = None
        if accum > 1:
            bsz = batch["flag"].shape[0]
            if bsz % accum:
                raise ValueError(f"batch size {bsz} not divisible by TPU.GRAD_ACCUM={accum}")
            micro = _split_microbatches(batch, accum)
            bns = _batch_norms(state.model)
            stats0 = [(m.running_mean.clone(), m.running_var.clone()) for m in bns]
            steps = []
            for i in range(accum):
                for m, (rm, rv) in zip(bns, stats0):
                    m.running_mean.copy_(rm)
                    m.running_var.copy_(rv)
                loss, metrics = forward_and_loss(state.model, {k: v[i] for k, v in micro.items()},
                                                 cfg, train=True, generator=generator)
                loss.backward()
                steps.append(metrics)
            if mean:
                for p in state.model.parameters():
                    if p.grad is not None:
                        p.grad.mul_(1.0 / accum)
            metrics = {k: torch.stack([m[k] for m in steps]).mean(0) for k in steps[0]}
        else:
            loss, metrics = forward_and_loss(state.model, batch, cfg, train=True,
                                             generator=generator)
            loss.backward()
        return metrics

    return train_step


def make_eval_step(model: nn.Module, cfg, dp: DataParallel | None = None):
    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict):
        with scope(dp):
            _, metrics = forward_and_loss(state.model, batch, cfg, train=False)
        return metrics if dp is None else _mean_metrics(metrics, dp)

    return eval_step


def setup_sharded_training(cfg, mesh, steps_per_epoch: int, device=None, seed: int = 0,
                           prepare_model=None, zero1: bool = False):
    """cfg -> (model, state, train_step) of this rank of `mesh` (a
    parallel/mesh.py Mesh; None: one device): build_model (fp32 parameters
    on `device`, "cuda" by default, seeded init: the same on every rank),
    prepare_model(model) (where cli/train loads pretrained weights), the
    optimizer (ZeRO-1 with zero1 and more than one data shard), the
    TrainState and the step, whose stochastic depth draws from a
    torch.Generator on the device seeded with `seed`."""
    from ..models.uvltrack import build_model, resolve_device

    dp = DataParallel.of(mesh) if mesh is not None else None
    device = resolve_device(device)
    model = build_model(cfg, device=device, seed=seed)
    if prepare_model is not None:
        model = prepare_model(model)
    optimizer = build_optimizer(cfg, model, steps_per_epoch,
                                zero1=dp if zero1 and dp is not None else None)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    state = create_train_state(model, optimizer)
    return model, state, make_train_step(model, optimizer, cfg, generator, dp=dp)


def setup_training(cfg, steps_per_epoch: int, device=None, seed: int = 0,
                   prepare_model=None):
    """setup_sharded_training on one device."""
    return setup_sharded_training(cfg, None, steps_per_epoch, device, seed, prepare_model)
