"""The work of the program that runs: FLOPs and bytes, counted as it runs
(port of uvltrack_tpu/utils/costs.py::compiled_cost).

The JAX package reads XLA's cost analysis of the compiled program. PyTorch
runs eagerly and the kernels launch through ctypes, which no PyTorch
counter sees, so the port counts the same program as it runs:

- FLOPs: `torch.utils.flop_counter.FlopCounterMode` over the aten ops, which
  counts the products and convolutions (2 per multiply-add) and, unlike
  XLA, no elementwise op;
- bytes: each aten op's tensor inputs read once and outputs written once
  (views and allocations move nothing and count nothing), XLA's "bytes
  accessed" of an unfused program;
- each kernel and its plain version is one unit (`counted`): its FLOPs and
  bytes are declared from its shapes (products only; inputs read once,
  outputs written once), and whatever runs inside it (a launch, or the plain
  version's ops) counts nothing more. So a kernel launch and its plain
  version count the same work, and a program counts the same whichever
  backend runs it.

A counter is active for the `with CostCount()` block only; outside one the
units cost a list check a call.
"""

from __future__ import annotations

import functools
from typing import Callable, List

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

_ACTIVE: List["CostCount"] = []  # the counters of enclosing `with CostCount()` blocks


def nbytes(*tensors) -> int:
    """Bytes of tensors (and of QuantizedTensors: payload and scale); None
    counts nothing."""
    total = 0
    for t in tensors:
        if t is None:
            continue
        if not torch.is_tensor(t):  # a QuantizedTensor
            total += nbytes(t.q, t.scale)
            continue
        total += t.numel() * t.element_size()
    return total


class _Bytes(TorchDispatchMode):
    """Sums each aten op's tensor inputs and outputs, views and allocations
    aside."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view or func.overloadpacket in _NO_BYTES):
            self.total += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out)) if torch.is_tensor(t))
        return out


_NO_BYTES = {torch.ops.aten.empty, torch.ops.aten.empty_like, torch.ops.aten.empty_strided,
             torch.ops.aten.detach, torch.ops.aten.lift_fresh}


class CostCount:
    """`with CostCount() as cc: ...` counts the aten ops and units run in the
    block; cc.totals() -> {"flops", "bytes"}."""

    def __init__(self):
        self._flop_mode = FlopCounterMode(display=False)
        self._byte_mode = _Bytes()
        self._depth = 0  # units open
        self._flops_adjust = 0  # declared work less what ran inside units
        self._bytes_adjust = 0

    def __enter__(self) -> "CostCount":
        self._flop_mode.__enter__()
        self._byte_mode.__enter__()
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        self._byte_mode.__exit__(*exc)
        self._flop_mode.__exit__(*exc)

    def _run_unit(self, flops: int, nbytes_: int, fn, args, kwargs):
        if self._depth:  # a unit inside a unit: the outer one counts
            return fn(*args, **kwargs)
        f0, b0 = self._flop_mode.get_total_flops(), self._byte_mode.total
        self._depth += 1
        try:
            return fn(*args, **kwargs)
        finally:
            self._depth -= 1
            self._flops_adjust += flops - (self._flop_mode.get_total_flops() - f0)
            self._bytes_adjust += nbytes_ - (self._byte_mode.total - b0)

    def totals(self) -> dict:
        return {"flops": float(self._flop_mode.get_total_flops() + self._flops_adjust),
                "bytes": float(self._byte_mode.total + self._bytes_adjust)}


def counted(work: Callable) -> Callable:
    """Decorator: a call of the function is one unit whose (flops, bytes) is
    work(*args, **kwargs), computed from the shapes."""
    def deco(fn):
        @functools.wraps(fn)
        def unit(*args, **kwargs):
            if not _ACTIVE:
                return fn(*args, **kwargs)
            return _ACTIVE[-1]._run_unit(*work(*args, **kwargs), fn, args, kwargs)
        return unit
    return deco


def program_cost(fn: Callable, *args, **kwargs) -> dict:
    """{"flops", "bytes"} of one call fn(*args, **kwargs), run under
    torch.no_grad."""
    with torch.no_grad(), CostCount() as cc:
        fn(*args, **kwargs)
    return cc.totals()
