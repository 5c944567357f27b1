"""The hi and lo bf16 planes of an fp32 weight, split once and cached: the
weight side of the GEMM core's fp32-weight mode (csrc/gemm_sm90.cuh, HiLo),
which the fp32-compute model's kernels run (TPU.COMPUTE_DTYPE=float32:
`ln_qkv[fp32x-fp32w]`, `proj_residual[fp32x-fp32a-fp32w]`,
`ln_mlp[fp32x-fp32w]`).

The card's fp32 products run as bf16 tensor-core passes (no TF32), so an
fp32 weight w is split, w = hi + lo + r with |r| <= 2^-17 |w|:

    hi = bf16_rn(w),  lo = bf16_rn(w - hi)       (common.cuh::split_bf16)

`split_hilo` (csrc/split_hilo.cu) writes both planes, (2, *w.shape) bf16,
hi then lo; the product kernels stream them by TMA as they stream a bf16
weight and run three passes, hi.hi + lo.hi + hi.lo. `planes(w)` keeps the
planes of each weight it has split: keyed by the weight tensor itself (an
entry goes when the tensor is freed) and valid while its storage, layout
and `_version` are unchanged, so an in-place update (an optimizer step,
`load_state_dict`) splits it again into the same planes. A split launched
while the stream captures a CUDA graph would be replayed with every replay:
`planes` refuses to fill then, and a caller warms the weight up first (the
tracker's graphs run their body eagerly before the capture). The cache
costs 4 bytes a weight value: for UVLTrack-B with the fused projection and
MLP on, the qkv, proj, fc1 and fc2 weights of 12 blocks, 340 MB.

A CPU tensor takes the plain version and never reaches the cache (the
wrappers take their plain versions first).
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass

import torch

from . import build
from .build import I64, PTR, check_cuda, require


@dataclass
class _Entry:
    ref: weakref.ref  # the weight
    key: tuple  # its storage, layout and version when split
    planes: torch.Tensor  # (2, *w.shape) bf16


_CACHE: dict = {}  # id(weight) -> _Entry


def split_hilo_plain(w: torch.Tensor) -> torch.Tensor:
    """(2, *w.shape) bf16: hi = bf16_rn(w), lo = bf16_rn(w - hi)."""
    hi = w.to(torch.bfloat16)
    return torch.stack((hi, (w - hi.float()).to(torch.bfloat16)))


def hilo_dot_plain(a: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """The three passes of an fp32 a (..., K) against a weight's planes
    (2, N, K), each pass's bf16 operands exact in fp32: a_hi.w_hi + a_lo.w_hi
    + a_hi.w_lo, fp32 (the kernels' terms; their sums run in another order)."""
    a_hi = a.to(torch.bfloat16).float()
    a_lo = (a - a_hi).to(torch.bfloat16).float()
    w_hi, w_lo = planes.float().unbind(0)
    return a_hi @ w_hi.t() + a_lo @ w_hi.t() + a_hi @ w_lo.t()


def split_hilo(w: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """w fp32, contiguous, numel % 8 == 0 -> its planes (2, *w.shape) bf16,
    into `out` when given. One launch of csrc/split_hilo.cu on a CUDA
    tensor; a CPU tensor takes the plain version."""
    if w.device.type == "cpu":
        planes = split_hilo_plain(w)
        return planes if out is None else out.copy_(planes)
    require(w.dtype == torch.float32, f"split_hilo: w must be fp32, got {w.dtype}")
    require(w.numel() % 8 == 0, f"split_hilo: w must hold a multiple of 8 values, got "
            f"{w.numel()}")
    if out is None:
        out = torch.empty((2, *w.shape), dtype=torch.bfloat16, device=w.device)
    require(out.dtype == torch.bfloat16 and tuple(out.shape) == (2, *w.shape),
            "split_hilo: out must be (2, *w.shape) bf16")
    check_cuda("split_hilo", w, out)
    build.launch("split_hilo", "fp32w", [PTR, PTR, I64], w.data_ptr(), out.data_ptr(),
                 w.numel(), stream_of=w)
    return out


def _capturing(w: torch.Tensor) -> bool:
    return w.is_cuda and torch.cuda.is_current_stream_capturing()


def _key(w: torch.Tensor) -> tuple:
    return (w.data_ptr(), tuple(w.shape), w.stride(), w.device, w._version)


def planes(w: torch.Tensor) -> torch.Tensor:
    """The cached planes of the fp32 weight w on the card: split on the first
    call for this tensor and again after it changed, else as they are. A
    tensor made under torch.inference_mode keeps no version counter, so its
    planes are split on every call."""
    if w.is_inference():
        return split_hilo(w)
    entry = _CACHE.get(id(w))
    key = _key(w)
    if entry is not None and entry.ref() is w and entry.key == key:
        return entry.planes
    require(not _capturing(w),
            "split_hilo: an fp32 weight's planes are filled outside CUDA-graph capture; "
            "run the captured body once eagerly first")
    if entry is not None and entry.ref() is w and entry.planes.shape[1:] == w.shape \
            and entry.planes.device == w.device:
        split_hilo(w, out=entry.planes)  # in place: the planes keep their address
        entry.key = key
        return entry.planes
    got = split_hilo(w)
    wid = id(w)

    def drop(ref, wid=wid):
        if wid in _CACHE and _CACHE[wid].ref is ref:
            del _CACHE[wid]

    _CACHE[wid] = _Entry(weakref.ref(w, drop), key, got)
    return got


def cache_bytes() -> int:
    """Bytes the cached planes hold."""
    return sum(e.planes.numel() * e.planes.element_size() for e in _CACHE.values())


def clear_cache() -> None:
    _CACHE.clear()
