"""Frozen arithmetic of the yardstick: the operations a tracked frame needs
(a copy of the port's frame_cost as of this benchmark, counted from a
configuration's dims, not from the program), the operations and bytes of
each roofline role, and the table of peaks.

A role's bound is the sum, over its products, of max(operations / peak
FLOP/s, bytes / peak bytes/s): each input read once and each output written
once, at the configuration's stated dtypes (weights and products in its
compute dtype, bf16; the residual stream in bf16 below the fusion layers
and in fp32 in them, as the model defines it)."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
BF16 = 2


def _tokens(d: dict):
    nz = (d["template_size"] // d["patch"]) ** 2
    nx = (d["search_size"] // d["patch"]) ** 2
    return nz, nx, 1 + nz + nx


def block_rows(d: dict) -> list:
    """[(N, x bytes an element)] of each ViT block: N = 1 + Nz + Nx below the
    fusion layers (bf16 stream), + the text tokens in them (fp32 stream)."""
    _, _, n_vis = _tokens(d)
    fusion = set(d["fusion_layers"])
    return [(n_vis + d["max_query_len"], 4) if i in fusion else (n_vis, BF16)
            for i in range(d["depth"])]


def frame_flops(d: dict) -> int:
    """Operations of one tracked frame: the blocks (qkv, attention,
    projection, MLP), the patch embedding and the four conv towers."""
    c = d["embed_dim"]
    nz, nx, _ = _tokens(d)
    flops = sum(24 * n * c * c + 4 * n * n * c for n, _ in block_rows(d))
    flops += 2 * (nz + nx) * c * 3 * d["patch"] ** 2
    cells = nx
    ch = d["head_dim"]
    chans = [c, ch, ch // 2, ch // 4, ch // 8]
    for out in (1, 2, 2, 2):
        flops += sum(2 * cells * chans[s] * 9 * chans[s + 1] for s in range(4))
        flops += 2 * cells * chans[4] * out
    return flops


def _bound_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAKS["bf16_flops_per_s"], nbytes / PEAKS["hbm_bytes_per_s"])


def linear_bound_s(d: dict, streams: int) -> float:
    """Least seconds of a step's weight products in the blocks at S streams:
    qkv (C -> 3C), projection (C -> C), fc1 (C -> 4C), fc2 (4C -> C)."""
    c, s = d["embed_dim"], streams
    hid = int(c * d["mlp_ratio"])
    total = 0.0
    for n, xb in block_rows(d):
        m = s * n
        for k, f, in_b, out_b in ((c, 3 * c, xb, BF16), (c, c, BF16, BF16),
                                  (c, hid, xb, BF16), (hid, c, BF16, BF16)):
            ops = 2 * m * k * f
            nbytes = m * k * in_b + k * f * BF16 + f * 4 + m * f * out_b
            total += _bound_s(ops, nbytes)
    return total


def attention_bound_s(d: dict, streams: int) -> float:
    """Least seconds of a step's attention in the blocks at S streams:
    4 B H N^2 D operations; the bf16 qkv read, the bf16 output written and
    the fp32 key bias read."""
    c, s = d["embed_dim"], streams
    total = 0.0
    for n, _ in block_rows(d):
        ops = 4 * s * n * n * c
        nbytes = s * n * 3 * c * BF16 + s * n * c * BF16 + s * n * 4
        total += _bound_s(ops, nbytes)
    return total


ROLE_BOUNDS = {"linear": linear_bound_s, "attention": attention_bound_s}
