"""Tensor parallelism (Megatron-style) of the ViT blocks, the BERT layers and
the head's prompter MLP over the mesh's model axis: the port of
uvltrack_tpu/parallel/tp.py.

Which parameters split is the JAX package's rule, taken on its flax paths
(tp_spec_for): the qkv and MLP-up kernels and biases (BERT's query, key,
value and intermediate too) on their output column, the projection and
MLP-down kernels (BERT's attention-output and output denses) on their input
row; everything else replicated (the row-parallel biases, the norms, the
embeddings, the 4-D patch-embedding kernel). The head's prompter MLP is
caught by the "mlp/fc1" and "mlp/fc2" substrings and splits as a block's
MLP does. The port's torch names map onto those paths through
models/convert.py::uvltrack_rules, so the two tables cannot drift; on the
torch (out, in) layout column-parallel is dim 0 and row-parallel dim 1.

The JAX package device_puts the split leaves and lets GSPMD place the
collectives. The port runs one process a model index, each holding its
slice (shard_params_tp), and places Megatron's two collectives itself
(TensorParallel.enter / .reduce, read from the context the train step sets,
current()):

- a column-parallel input is the identity forward, its gradient all-reduced
  over the model group in the backward (each rank's heads carry a share);
- a row-parallel output is the rank's fp32 partial product, all-reduced in
  the forward, its gradient passed through in the backward; the bias and
  the residual are added once, after the sum.

JAX's contiguous split of qkv's 3C columns gives rank 0 all of q and half of
k at tp=2: under GSPMD only a layout. A rank of a Megatron forward needs q,
k and v of its own H/tp heads, so each rank's rows of the (3C, C) weight
(and of the bias) are cat(q[r], k[r], v[r]). gather_params_tp undoes that,
so a gathered state is the whole tensor in JAX's logical layout. Without a
context (tp=1, inference) every module runs its single-device code.
"""

from __future__ import annotations

import contextlib
import contextvars
import re
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist

# the JAX package's substrings on flax paths (uvltrack_tpu/parallel/tp.py:22-37)
_COLUMN_KERNEL = ("qkv/kernel", "mlp/fc1/kernel", "query/kernel", "key/kernel", "value/kernel",
                  "intermediate/kernel")
_COLUMN_BIAS = ("qkv/bias", "mlp/fc1/bias", "query/bias", "key/bias", "value/bias",
                "intermediate/bias")
_ROW_KERNEL = ("proj/kernel", "mlp/fc2/kernel", "attn_out/kernel", "output/kernel")
# split per head: rows [q | k | v], each H heads x D
_PER_HEAD = ".attn.qkv."


def _jax_split_axis(path: str, ndim: int) -> Optional[int]:
    """The axis of a flax leaf at `path` ("a/b/c") that JAX's tp_spec_for
    splits over "model" (flax kernels are (in, out)), or None."""
    if any(s in path for s in _COLUMN_KERNEL):
        return 1 if ndim == 2 else None
    if any(s in path for s in _COLUMN_BIAS):
        return 0 if ndim == 1 else None
    if any(s in path for s in _ROW_KERNEL):
        return 0 if ndim == 2 else None
    return None


def _flax_paths() -> Dict[str, tuple]:
    """{torch name with block/layer index 0: (flax path, transposed)} from
    models/convert.py's rule table (one block, one BERT layer), text_proj
    and LayerScale included."""
    from ..models.convert import (_t_linear, layer_scale_rules, state_key, text_proj_rules,
                                  uvltrack_rules)

    rules, _ = uvltrack_rules(1, 1)
    return {state_key(src): ("/".join(dst), tf is _t_linear)
            for src, dst, tf in rules + text_proj_rules() + layer_scale_rules(0)}


_PATHS: Dict[str, tuple] = {}
_INDEX = re.compile(r"\.(blocks|layer)\.\d+\.")


def tp_spec_for(name: str, shape: Sequence[int]) -> Optional[int]:
    """The dim of the port's parameter `name` (torch layout, `shape`) that
    tensor parallelism splits: 0 column-parallel (weight rows, bias), 1
    row-parallel (weight columns), None replicated. JAX's rule on the flax
    path the name maps to."""
    if not _PATHS:
        _PATHS.update(_flax_paths())
    hit = _PATHS.get(_INDEX.sub(lambda m: f".{m.group(1)}.0.", name))
    if hit is None:
        return None
    path, transposed = hit
    axis = _jax_split_axis(path, len(shape))
    if axis is None:
        return None
    return 1 - axis if transposed else axis


def shard_tensor(name: str, t: torch.Tensor, dim: int, size: int, index: int) -> torch.Tensor:
    """Rank `index`'s slice of the whole tensor `t` split `size` ways on
    `dim` (qkv per head: its q, k and v rows)."""
    if _PER_HEAD in name:
        rows = t.shape[0] // (3 * size)
        return t.reshape(3, size, rows, *t.shape[1:])[:, index].reshape(3 * rows, *t.shape[1:])
    n = t.shape[dim] // size
    return t.narrow(dim, index * n, n)


def merge_tensor(name: str, parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """The whole tensor from every rank's slice, in rank order: the inverse
    of shard_tensor."""
    if _PER_HEAD in name:
        rows = parts[0].shape[0] // 3
        stacked = torch.stack([p.reshape(3, rows, *p.shape[1:]) for p in parts], dim=1)
        return stacked.reshape(3 * rows * len(parts), *parts[0].shape[1:])
    return torch.cat(list(parts), dim=dim)


def split_params(model: torch.nn.Module) -> Dict[str, int]:
    """{parameter name: split dim} of every parameter tensor parallelism splits."""
    return {n: d for n, p in model.named_parameters()
            if (d := tp_spec_for(n, tuple(p.shape))) is not None}


@dataclass(frozen=True)
class TensorParallel:
    """This rank's place among `size` model shards: its `index` and the
    model group (the ranks of one data index; None: the default group)."""
    size: int
    index: int
    group: Any = None

    @classmethod
    def of(cls, mesh) -> Optional["TensorParallel"]:
        """The context of a parallel/mesh.py Mesh; None when it has one model shard."""
        return cls(mesh.model, mesh.model_index, mesh.model_group) if mesh.model > 1 else None

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """In place: the sum over the model group, in fp32 for a 16-bit tensor."""
        if t.dtype in (torch.bfloat16, torch.float16):
            wide = t.float()
            dist.all_reduce(wide, group=self.group)
            return t.copy_(wide)
        dist.all_reduce(t, group=self.group)
        return t

    def enter(self, t: torch.Tensor) -> torch.Tensor:
        """A column-parallel region's input: the identity; its gradient is
        the sum of every rank's."""
        return _Enter.apply(t, self)

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        """A row-parallel region's output: the sum of every rank's partial;
        its gradient passes through."""
        return _Reduce.apply(t, self)

    def gather(self, name: str, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole tensor of parameter `name` from every rank's slice `t`
        (an all_gather)."""
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return merge_tensor(name, parts, dim)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, tp):
        ctx.tp = tp
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce_(g.contiguous().clone()), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, tp):
        return tp.all_reduce_(t.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


_CURRENT: contextvars.ContextVar = contextvars.ContextVar("uvltrack_tensor_parallel",
                                                         default=None)


def current() -> Optional[TensorParallel]:
    """The tensor-parallel context of this thread's step, or None."""
    return _CURRENT.get()


@contextlib.contextmanager
def scope(tp: Optional[TensorParallel]):
    """Run the body under `tp` (None: no tensor parallelism)."""
    token = _CURRENT.set(tp)
    try:
        yield tp
    finally:
        _CURRENT.reset(token)


def _context(mesh_or_tp) -> TensorParallel:
    tp = mesh_or_tp if isinstance(mesh_or_tp, TensorParallel) else TensorParallel.of(mesh_or_tp)
    if tp is None:
        raise ValueError("tensor parallelism needs a mesh with more than one model shard")
    return tp


@torch.no_grad()
def shard_params_tp(mesh, model: torch.nn.Module) -> torch.nn.Module:
    """Keep this rank's slice of every split parameter of `model` (whole and
    equal on every rank before), in place, and give each split attention
    (ViT blocks, BERT layers) its H/tp heads. `mesh`: a Mesh with model > 1
    or a TensorParallel. Returns the model."""
    tp = _context(mesh)
    if getattr(model, "tp_size", 1) != 1:
        raise ValueError(f"model is already split {model.tp_size} ways")
    names = split_params(model)
    if any(n.endswith("weight_q") for n, _ in model.named_buffers()):
        raise ValueError("tensor parallelism splits fp weights; this model holds int8 ones "
                         "(TPU.WEIGHT_QUANT, inference only)")
    if any(".text_proj." in n for n in names):
        # JAX splits text_proj's kernel on its input row, which a Megatron
        # forward would feed a slice of the replicated BERT output; no
        # configuration of the repo has it (BERT width == ViT width)
        raise ValueError("tensor parallelism of a model with backbone.text_proj (BERT width "
                         "!= ViT width) is not supported")
    from ..models.bert import BertLayer
    from ..models.vit import Attention

    for m in model.modules():
        heads = m.num_heads if isinstance(m, Attention) else (
            m.heads if isinstance(m, BertLayer) else None)
        if heads is not None and heads % tp.size:
            raise ValueError(f"{heads} heads do not split {tp.size} ways")
    params = dict(model.named_parameters())
    for n, dim in names.items():
        p = params[n]
        if p.shape[dim] % tp.size:
            raise ValueError(f"{n} {tuple(p.shape)}: dim {dim} does not split {tp.size} ways")
        p.data = shard_tensor(n, p.data, dim, tp.size, tp.index).contiguous()
    for m in model.modules():
        if isinstance(m, Attention):
            m.num_heads //= tp.size
        elif isinstance(m, BertLayer):
            m.heads //= tp.size
    model.tp_size = tp.size
    return model


@torch.no_grad()
def gather_params_tp(mesh, model: torch.nn.Module) -> dict:
    """The model's state dict with every split parameter whole, in JAX's
    logical layout (a collective: every rank of the model group calls it)."""
    tp = _context(mesh)
    names = split_params(model)
    return {k: (tp.gather(k, v, names[k]) if k in names else v)
            for k, v in model.state_dict().items()}


def full_state_dict(model: torch.nn.Module, tp: Optional[TensorParallel]) -> dict:
    """model.state_dict(), gathered when tensor parallelism split it."""
    return gather_params_tp(tp, model) if tp is not None else model.state_dict()


@torch.no_grad()
def load_full_state(model: torch.nn.Module, state: dict, tp: Optional[TensorParallel]) -> None:
    """Load a whole (gathered or single-device) state dict into a model split
    by `tp` (None: load_state_dict as it is)."""
    if tp is None:
        model.load_state_dict(state)
        return
    names = split_params(model)
    model.load_state_dict({k: (shard_tensor(k, v, names[k], tp.size, tp.index).contiguous()
                               if k in names else v) for k, v in state.items()})
