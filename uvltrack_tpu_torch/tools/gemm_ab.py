"""CUDA-graph device times of the GEMM launches on the TMA + wgmma core
(`ln_qkv` with bf16 and int8 weights, `proj_residual` in its four
instantiations, `ln_fc1_gelu`, `fc2_bias`) and their library yardsticks at the
tracking step's two shapes (N=321 with a bf16 stream, N=361 with an fp32
one), and of the attention bodies beside SDPA (`qkv_attention[bf16]` at
N=321 open and N=361 flag-0, `qkv_attention[fp32]` at N=361 flag-0,
`attention[bf16]` at BERT's N=40 and N=128), for A/B runs of two checkouts
on one card. Also the eager time per call, host included, of the attention
bodies, of the compositions #1, #4, #5 and #6 (two or three launches each)
and, as controls, of `ln_qkv` and `proj_residual` alone.

    python uvltrack_tpu_torch/tools/gemm_ab.py [--root DIR] [--label NAME]
        [--eager-only] [--dump FILE.npz] [--cmp FILE.npz]
    python uvltrack_tpu_torch/tools/gemm_ab.py --f32w [--root DIR] [--label NAME]
        [--dump FILE.npz] [--cmp FILE.npz]
    python uvltrack_tpu_torch/tools/gemm_ab.py --tp [--root DIR] [--label NAME]
        [--dump FILE.npz] [--cmp FILE.npz]
    python uvltrack_tpu_torch/tools/gemm_ab.py --qkv [--root DIR] [--label NAME]
        [--check-only] [--dump FILE.npz] [--cmp FILE.npz]
    python uvltrack_tpu_torch/tools/gemm_ab.py --mlp|--proj [--root DIR] [--label NAME]
        [--check-only] [--dump FILE.npz] [--cmp FILE.npz]
    python uvltrack_tpu_torch/tools/gemm_ab.py --attn [--root DIR] [--label NAME]
        [--check-only] [--dump FILE.npz] [--cmp FILE.npz]
    python uvltrack_tpu_torch/tools/gemm_ab.py --dot [--root DIR] [--label NAME]
        [--check-only] [--dump FILE.npz] [--cmp FILE.npz]

--root: the checkout whose uvltrack_tpu_torch is timed (default: the one
holding this script), built into DIR/build/kernels. The timers are
chip_smoke.py's graph_time_ms ("times", device ms a call) and, under
"eager", two per function, each taken EAGER_REPS times and given as [min,
median, max]: "ms", chip_smoke.py's cuda_time_ms (200 back-to-back eager
calls between two CUDA events: the host's time where it exceeds the
device's), and "host_ms", the host's wall clock over 200 calls that nothing
synchronizes (the launch queue holds them all, so the device's time does
not show). --eager-only skips the device times. --f32w times only kernel
#1's prefix at fp32 compute, `ln_qkv[fp32x-fp32w]`, beside F.layer_norm +
F.linear in fp32 at B in {1, 8}, N in {321, 361}, C in {768, 1024} (the same
seeded inputs in every checkout). --tp times a tensor-parallel rank's
launches at B=16 (chip_smoke.py's TP_SHAPES: B at tp 2 and 4, L at tp 2):
the shares of #4's projection (`proj_partial`) and of #7 (`ln_mlp_partial`,
and each of its launches alone with an fp32 out) beside their library calls
(F.linear's bf16 out and, where this torch has it, torch.mm with an fp32
out_dtype), and `ln_qkv` / `qkv_attention` at the rank's widths, all through
the wrappers' Python API, so a parent checkout runs the same calls. --qkv
times `ln_qkv` (bf16 W) and `ln_qkv_q8` (int8 W) at M = B.N rows for B in
QKV_B, N=321 bf16 x and N=361 fp32 x, C=768 (the crossover of the 64-row and
large-M bodies, LARGE_M_ROWS): the wrapper's own choice ("auto"; a parent
checkout's only body), each body forced where the checkout has both ("lm",
"ln64"), and F.layer_norm + F.linear (int8: the dequantized W in x's
dtype); it also holds "lm" against the plain version (chip_smoke.py's
rules), bitwise on a second call and against "ln64" (--check-only: the
checks alone, no times). --mlp does the same for kernel #7 with bf16
weights (`ln_fc1_gelu`, `fc2_bias` and the pair) and --proj for the four
bf16- and int8-weight `proj_residual` instantiations, at MLP_SHAPES (B at
lockstep batches 1-4 and 8, L at 8, B-TRAIN's 16 rows; N=321 with a bf16 x,
N=361 with an fp32 x: the crossover of the two bodies and the cells' shapes):
"auto", "lm" and "ln64" where the checkout has both bodies, and the library
calls (LN + linear + GELU + linear, or its part; linear +
add, the dequantized W in x's dtype); "lm" against the plain version
(`fc2_bias` against fc2_bias_plain on the hidden tensor "lm" wrote), bitwise
on a second call and against "ln64". --attn times `qkv_attention` at
ATTN_SHAPES (the lockstep and training shapes: B S4/S8, L S8, B-TRAIN, the
tp ranks' heads; N=321 open and N=361 with the text masked; fp32 at B S4
and B S8, N=361) and over ATTN_SWEEP (B=1-4 at H=12 and 16, where the split
and batch bodies cross: ATTN_BATCH_PAIRS): "auto", "batch" and "split" (each
body forced where the checkout has both) and SDPA ("library"); "batch"
against the plain version, bitwise on a second call and against "split".
--dot times the default path's weight products (the projection, fc1, fc2)
at DOT_SHAPES (the four cells' M = 321, 361, 2,568, 2,888 for B and L):
"default", the checkout's own product (ops/ln_qkv_attn_proj.py::dense_f32,
or ops/quant.py::dot_f32 in a checkout without it), each schedule of
`uvl_dense` forced where the checkout has it ("lm", the large-M body;
"split1" .. "split3", the 64-row body with K in that many parts),
"dot_f32" (the upcast cuBLAS product) and torch.mm with an fp32 out_dtype
("library", the yardstick); each core output against dot_f32 (|diff| at
most DOT_RTOL of |a|.|w| summed over K) and bitwise on a second call.
In every mode --dump saves the kernels' outputs (the same seeded inputs in
every checkout) and --cmp reports, output by output, whether they are
bitwise those of another checkout's dump. Prints one JSON line; times in ms.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
EAGER_REPS = 7


def host_ms(fn, iters: int = 200) -> float:
    """The host's wall-clock ms a call over `iters` unsynchronized calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def eager_ms(fn) -> dict:
    """{"ms", "host_ms"}: [min, median, max] of EAGER_REPS timings of fn."""
    from chip_smoke import cuda_time_ms

    def spread(timer):
        ts = sorted(timer(fn) for _ in range(EAGER_REPS))
        return [ts[0], ts[len(ts) // 2], ts[-1]]

    return {"ms": spread(cuda_time_ms), "host_ms": spread(host_ms)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eager-only", action="store_true")
    ap.add_argument("--f32w", action="store_true")
    ap.add_argument("--tp", action="store_true")
    ap.add_argument("--qkv", action="store_true")
    ap.add_argument("--mlp", action="store_true")
    ap.add_argument("--proj", action="store_true")
    ap.add_argument("--attn", action="store_true")
    ap.add_argument("--dot", action="store_true")
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--dump", default="")
    ap.add_argument("--cmp", default="")
    args = ap.parse_args()
    sys.path[:0] = [args.root, str(REPO)]
    if args.f32w:
        return f32w_ab(args)
    if args.tp:
        return tp_ab(args)
    if args.qkv:
        return qkv_ab(args)
    if args.mlp or args.proj:
        return mlp_proj_ab(args)
    if args.attn:
        return attn_ab(args)
    if args.dot:
        return dot_ab(args)

    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("gemm_ab: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import graph_time_ms, nvidia_smi
    from uvltrack_tpu_torch.ops import ln_mlp as lm
    from uvltrack_tpu_torch.ops import ln_qkv_attention as lqa
    from uvltrack_tpu_torch.ops import ln_qkv_attn_proj as lqp
    from uvltrack_tpu_torch.ops import quant

    dev, c, f = torch.device("cuda"), 768, 3072
    rng = np.random.default_rng(args.seed)

    def arr(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)

    out = {"label": args.label, "root": args.root, "device": nvidia_smi(), "times": {},
           "eager": {}}
    dumps = {}
    heads = c // 64
    for n, xdt in ((321, torch.bfloat16), (361, torch.float32)):
        x = arr(rng.normal(size=(1, n, c)), xdt)
        g, be = arr(1 + 0.1 * rng.normal(size=c)), arr(0.1 * rng.normal(size=c))
        wq = arr(rng.normal(size=(3 * c, c)) / np.sqrt(c), torch.bfloat16)
        w1 = arr(rng.normal(size=(f, c)) / np.sqrt(c), torch.bfloat16)
        w2 = arr(rng.normal(size=(c, f)) / np.sqrt(f), torch.bfloat16)
        bq, b1, b2 = arr(0.02 * rng.normal(size=3 * c)), arr(0.02 * rng.normal(size=f)), \
            arr(0.02 * rng.normal(size=c))
        wp = arr(rng.normal(size=(c, c)) / np.sqrt(c), torch.bfloat16)
        bp = arr(0.02 * rng.normal(size=c))
        attn = arr(rng.normal(size=(1, n, c)), xdt)  # the attention output, x's dtype
        hidden = torch.empty((n, f), dtype=torch.bfloat16, device=dev)
        o = torch.empty((1, n, c), dtype=torch.bfloat16, device=dev)
        b16 = torch.bfloat16
        wqq, wpq = quant.quantize_weight(wq), quant.quantize_weight(wp)
        wqd, wpd = wqq.materialize(xdt), wpq.materialize(xdt)  # dequantized, x's dtype
        a16 = attn.to(b16)
        xt = "bf16" if xdt == b16 else "fp32"

        def ln(dt=b16):
            return F.layer_norm(x.float(), (c,), g, be, 1e-6).to(dt)

        def stage(name):
            return lambda: lm.launch_ln_mlp(x, g, be, w1, b1, w2, b2, hidden, o, stages=name)

        fns = {
            "ln_qkv": lambda: lqa.ln_qkv(x, g, be, wq, bq),
            "ln_qkv library": lambda: F.linear(ln(), wq, bq.to(b16)),
            "ln_fc1_gelu": stage("ln_fc1_gelu"),
            "ln_fc1_gelu library": lambda: F.gelu(F.linear(ln(), w1, b1.to(b16))),
            "fc2_bias": stage("fc2_bias"),
            "fc2_bias library": lambda: F.linear(hidden.view(1, n, f), w2, b2.to(b16)),
            "ln_mlp pair": stage("pair"),
            f"ln_qkv[{xt}x-int8w]": lambda: lqa.ln_qkv_q8(x, g, be, wqq.q, wqq.scale, bq),
            f"ln_qkv[{xt}x-int8w] library": lambda: F.linear(ln(xdt), wqd, bq.to(xdt)),
            f"proj_residual[{xt}x-bf16a-bf16w]": lambda: lqp.proj_residual(x, a16, wp, bp),
            f"proj_residual[{xt}x-bf16a-bf16w] library":
                lambda: torch.add(x, F.linear(a16, wp, bp.to(b16))),
            f"proj_residual[{xt}x-{xt}a-int8w]":
                lambda: lqp.proj_residual(x, attn, wpq.q, bp, wpq.scale),
            f"proj_residual[{xt}x-{xt}a-int8w] library":
                lambda: torch.add(x, F.linear(attn, wpd, bp.to(xdt))),
        }
        for k, fn in fns.items():  # the kernels' outputs (ln_mlp's stages: their buffers)
            if not k.endswith("library"):
                res = fn()
                res = {"ln_fc1_gelu": hidden, "fc2_bias": o, "ln_mlp pair": o}.get(k, res)
                dumps[f"N{n} {k}"] = res.float().cpu().numpy()
        if not args.eager_only:
            out["times"][f"N{n}"] = {k: graph_time_ms(fn)[0] for k, fn in fns.items()}
        # the main path's masks: nothing at N=321, the 40 text keys at N=361
        kb = torch.zeros((1, n), device=dev)
        kb[:, 321:] = -1e10
        qkv = lqa.ln_qkv(x, g, be, wq, bq)
        eager = {
            "ln_qkv": fns["ln_qkv"],
            f"proj_residual[{xt}x-bf16a-bf16w]": fns[f"proj_residual[{xt}x-bf16a-bf16w]"],
            "qkv_attention[bf16]": lambda: lqa.qkv_attention(qkv, kb, heads),
            "#1 ln_qkv_attention": lambda: lqa.ln_qkv_attention(x, g, be, wq, bq, kb, heads),
            "#4 ln_qkv_attn_proj":
                lambda: lqp.ln_qkv_attn_proj(x, g, be, wq, bq, wp, bp, kb, heads),
            f"#5 ln_qkv_attention_q8[{xt}x]":
                lambda: lqa.ln_qkv_attention_q8(x, g, be, wqq.q, wqq.scale, bq, kb, heads),
            f"#6 ln_qkv_attn_proj_q8[{xt}x]":
                lambda: lqp.ln_qkv_attn_proj_q8(x, g, be, wqq.q, wqq.scale, bq, wpq.q, wpq.scale,
                                                bp, kb, heads),
        }
        if xdt == torch.float32:
            qkv32 = qkv.float()
            eager["qkv_attention[fp32]"] = lambda: lqa.qkv_attention(qkv32, kb, heads)
        for k in ("qkv_attention[bf16]", "qkv_attention[fp32]"):
            if k in eager:
                dumps[f"N{n} {k}"] = eager[k]().float().cpu().numpy()
        out["eager"][f"N{n}"] = {k: eager_ms(fn) for k, fn in eager.items()}
    if not args.eager_only:
        out["times"]["attention"] = attention_times(args.seed)
    out["eager"]["attention"] = attention_eager(args.seed)
    dump_and_compare(args, dumps, out)
    print(json.dumps(out), flush=True)
    return 0


def dump_and_compare(args, dumps: dict, out: dict) -> None:
    """--dump: save {name: output}; --cmp: out["bitwise_vs_cmp"][name], the
    output bitwise that of the other checkout's dump (None where it has no
    such output)."""
    import numpy as np

    if args.dump:
        np.savez(args.dump, **dumps)
    if args.cmp:
        other = np.load(args.cmp)
        out["bitwise_vs_cmp"] = {k: (bool(np.array_equal(other[k], v)) if k in other.files
                                     else None) for k, v in dumps.items()}


def tp_ab(args) -> int:
    """A tensor-parallel rank's launches at B=16 and TP_SHAPES (PERF.md rows
    1t, 2t, 4t, 7t): device ms (a CUDA graph of 20 calls), library calls
    beside them, the outputs dumped or compared."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("gemm_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import TP_SHAPES, TRAIN_B, graph_time_ms, nvidia_smi
    from uvltrack_tpu_torch.ops import ln_mlp as lm
    from uvltrack_tpu_torch.ops import ln_qkv_attention as lqa
    from uvltrack_tpu_torch.ops import ln_qkv_attn_proj as lqp

    dev, b16, b = torch.device("cuda"), torch.bfloat16, TRAIN_B
    out = {"label": args.label, "root": args.root, "device": nvidia_smi(), "rows": b,
           "times": {}}
    try:
        probe = torch.ones((64, 64), dtype=b16, device=dev)
        torch.mm(probe, probe.t(), out_dtype=torch.float32)
        mm_f32 = True
    except (TypeError, RuntimeError) as e:
        mm_f32 = False
        out["mm_out_dtype"] = f"refused: {str(e)[:200]}"

    def lin32(a, w):
        return torch.mm(a.reshape(-1, a.shape[-1]), w.t(), out_dtype=torch.float32)

    dumps = {}
    for label, c, heads, tp in TP_SHAPES:
        hh, k, f, q = heads // tp, c // tp, 4 * c // tp, 3 * c // tp
        for n, xdt in ((361, torch.float32), (321, b16)):
            rng = np.random.default_rng(args.seed + c + tp + n)

            def arr(a, dt=torch.float32):
                return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)

            x = arr(rng.normal(size=(b, n, c)), xdt)
            g, be = arr(1 + 0.1 * rng.normal(size=c)), arr(0.1 * rng.normal(size=c))
            wq, bq = arr(rng.normal(size=(q, c)) / np.sqrt(c), b16), arr(0.02 * rng.normal(size=q))
            attn = arr(0.3 * rng.normal(size=(b, n, k)), b16)
            wp = arr(rng.normal(size=(c, k)) / np.sqrt(k), b16)
            w1 = arr(rng.normal(size=(f, c)) / np.sqrt(c), b16)
            b1 = arr(0.02 * rng.normal(size=f))
            w2 = arr(rng.normal(size=(c, f)) / np.sqrt(4 * c), b16)
            zero = torch.zeros((c,), device=dev)
            hidden = torch.empty((b * n, f), dtype=b16, device=dev)
            o = torch.empty((b, n, c), dtype=torch.float32, device=dev)
            kb = torch.zeros((b, n), device=dev)
            if n == 361:
                kb[:, 321:] = -1e10
            qkv = lqa.ln_qkv(x, g, be, wq, bq)

            def ln():
                return F.layer_norm(x.float(), (c,), g, be, 1e-6).to(b16)

            def stage(name):
                return lambda: lm.launch_ln_mlp(x, g, be, w1, b1, w2, zero, hidden, o,
                                                stages=name)

            fns = {
                "proj_partial": lambda: lqp.proj_partial(attn, wp),
                "ln_mlp_partial": lambda: lm.ln_mlp_partial(x, g, be, w1, b1, w2),
                "ln_mlp_partial ln_fc1_gelu": stage("ln_fc1_gelu"),
                "ln_mlp_partial fc2": stage("fc2_bias"),
                "ln_qkv": lambda: lqa.ln_qkv(x, g, be, wq, bq),
                "qkv_attention": lambda: lqa.qkv_attention(qkv, kb, hh),
            }
            key = f"{label}_N{n}"
            for name, fn in fns.items():
                res = {"ln_mlp_partial ln_fc1_gelu": hidden,
                       "ln_mlp_partial fc2": o}.get(name, None)
                r = fn()
                dumps[f"{key} {name}"] = (r if res is None else res).float().cpu().numpy()
            lib = {
                "proj_partial library F.linear": lambda: F.linear(attn, wp),
                "ln_mlp_partial library 4 calls F.linear":
                    lambda: F.linear(F.gelu(F.linear(ln(), w1, b1.to(b16))), w2),
                "ln_fc1_gelu library 3 calls": lambda: F.gelu(F.linear(ln(), w1, b1.to(b16))),
                "fc2 library F.linear": lambda: F.linear(hidden, w2),
                "ln_qkv library 2 calls": lambda: F.linear(ln(), wq, bq.to(b16)),
            }
            if mm_f32:
                lib.update({
                    "proj_partial library mm fp32": lambda: lin32(attn, wp),
                    "ln_mlp_partial library 4 calls mm fp32":
                        lambda: lin32(F.gelu(F.linear(ln(), w1, b1.to(b16))), w2),
                    "fc2 library mm fp32": lambda: lin32(hidden, w2)})
            out["times"][key] = {name: graph_time_ms(fn)[0]
                                 for name, fn in {**fns, **lib}.items()}
    dump_and_compare(args, dumps, out)
    print(json.dumps(out), flush=True)
    return 0


QKV_B = (1, 2, 4, 8, 16)  # M = 321 .. 5,136 (bf16 x), 361 .. 5,776 (fp32 x)


def qkv_ab(args) -> int:
    """ln_qkv's bodies at M = B.N (PERF.md rows 1m and 5m): device ms (a
    CUDA graph of 20 calls) of the wrapper's choice, of each body forced
    where this checkout has both, and of the library calls; the large-M
    outputs against the plain versions, a second call and the 64-row
    body's."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("gemm_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import (F32_ATOL, F32_RTOL, KERNEL_ATOL, KERNEL_RTOL, graph_time_ms,
                            nvidia_smi)
    from uvltrack_tpu_torch.ops import ln_qkv_attention as lqa
    from uvltrack_tpu_torch.ops import quant

    two_bodies = hasattr(lqa, "LARGE_M_ROWS")

    def body(fn, rows_from):
        """fn with ln_qkv's large-M threshold at rows_from (0: the large-M
        body at any rows; 1 << 62: the 64-row body)"""
        def call():
            rows, lqa.LARGE_M_ROWS = lqa.LARGE_M_ROWS, rows_from
            try:
                return fn()
            finally:
                lqa.LARGE_M_ROWS = rows
        return call

    dev, c, b16 = torch.device("cuda"), 768, torch.bfloat16
    out = {"label": args.label, "root": args.root, "device": nvidia_smi(), "times": {},
           "checks": {}, "two_bodies": two_bodies}
    dumps = {}
    for b in QKV_B:
        for n, xdt in ((321, b16), (361, torch.float32)):
            rng = np.random.default_rng(args.seed + b + n)

            def arr(a, dt=torch.float32):
                return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)

            x = arr(rng.normal(size=(b, n, c)), xdt)
            g, be = arr(1 + 0.1 * rng.normal(size=c)), arr(0.1 * rng.normal(size=c))
            w = arr(rng.normal(size=(3 * c, c)) / np.sqrt(c), b16)
            wb = arr(0.02 * rng.normal(size=3 * c))
            wq = quant.quantize_weight(w)
            wqd = wq.materialize(xdt)
            xt = "bf16" if xdt == b16 else "fp32"
            key = f"M{b * n}_{xt}x"

            def ln(dt):
                return F.layer_norm(x.float(), (c,), g, be, 1e-6).to(dt)

            kinds = {
                "bf16w": (lambda: lqa.ln_qkv(x, g, be, w, wb),
                          lambda: lqa.ln_qkv_plain(x, g, be, w, wb),
                          lambda: F.linear(ln(b16), w, wb.to(b16)), "ln_qkv"),
                "int8w": (lambda: lqa.ln_qkv_q8(x, g, be, wq.q, wq.scale, wb),
                          lambda: lqa.ln_qkv_q8_plain(x, g, be, wq.q, wq.scale, wb),
                          lambda: F.linear(ln(xdt), wqd, wb.to(xdt)),
                          None if xdt == torch.float32 else "ln_qkv"),
            }
            times = {}
            for wt, (kern, plain, lib, tol_key) in kinds.items():
                name = f"ln_qkv[{xt}x-{wt}]"
                dumps[f"{key} {name}"] = kern().float().cpu().numpy()
                fns = {"auto": kern, "library": lib}
                if two_bodies:
                    fns.update({"lm": body(kern, 0), "ln64": body(kern, 1 << 62)})
                    got, again, small = fns["lm"](), fns["lm"](), fns["ln64"]()
                    want = plain().float()
                    torch.cuda.synchronize()
                    diff = (got.float() - want).abs()
                    atol = F32_ATOL if tol_key is None else KERNEL_ATOL[tol_key]
                    rtol = F32_RTOL if tol_key is None else KERNEL_RTOL
                    out["checks"][f"{key} {name}"] = {
                        "max_abs_err": float(diff.max()),
                        "ok": bool((diff <= atol + rtol * want.abs()).all()),
                        "bitwise_second_call": bool(torch.equal(got, again)),
                        "bitwise_vs_ln64": bool(torch.equal(got, small)),
                        "max_abs_vs_ln64": float((got.float() - small.float()).abs().max())}
                if not args.check_only:
                    times.update({f"{name} {k}": graph_time_ms(fn)[0] for k, fn in fns.items()})
            out["times"][key] = times
    dump_and_compare(args, dumps, out)
    print(json.dumps(out), flush=True)
    return 0


# (label, B, C): B at lockstep batches S1-S4 (M = 321 .. 1,444: where the
# bodies cross) and S8, L at S8, B-TRAIN's rows
MLP_SHAPES = (("B_S1", 1, 768), ("B_S2", 2, 768), ("B_S3", 3, 768), ("B_S4", 4, 768),
              ("B_S8", 8, 768), ("L_S8", 8, 1024), ("B16", 16, 768))


def mlp_proj_ab(args) -> int:
    """Kernel #7 (--mlp) or `proj_residual` (--proj) at B.N rows (PERF.md
    rows 7m, 4m and 6m): device ms (a CUDA graph of 20 calls) of the
    wrapper's choice, of each body forced where this checkout has both, and
    of the library calls; the
    large-M outputs against the plain versions, a second call and (fc1) the
    64-row body's."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("gemm_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import (F32_ATOL, F32_RTOL, KERNEL_ATOL, KERNEL_RTOL, Q8_KERNEL_ATOL,
                            graph_time_ms, nvidia_smi)
    from uvltrack_tpu_torch.ops import ln_mlp as lm
    from uvltrack_tpu_torch.ops import ln_qkv_attention as lqa
    from uvltrack_tpu_torch.ops import ln_qkv_attn_proj as lqp
    from uvltrack_tpu_torch.ops import quant

    # a checkout before the large-M entries: the 64-row body alone
    two_bodies = hasattr(lqp, "proj_residual_large_m_plain")

    def body(fn, rows_from):
        """fn with both large-M thresholds (ln_mlp's, proj_residual's) at
        rows_from (0: the large-M body; 1 << 62: the 64-row body)"""
        def call():
            rows = lqa.LARGE_M_ROWS, lqp.LARGE_M_ROWS
            lqa.LARGE_M_ROWS = lqp.LARGE_M_ROWS = rows_from
            try:
                return fn()
            finally:
                lqa.LARGE_M_ROWS, lqp.LARGE_M_ROWS = rows
        return call

    def variants(kern, lib):
        fns = {"auto": kern, "library": lib}
        if two_bodies:
            fns.update({"lm": body(kern, 0), "ln64": body(kern, 1 << 62)})
        return fns

    def check(name, got, again, want, atol, rtol, small=None):
        d = (got.float() - want.float()).abs()
        r = {"max_abs_err": float(d.max()),
             "ok": bool((d <= atol + rtol * want.float().abs()).all()),
             "bitwise_second_call": bool(torch.equal(got, again))}
        if small is not None:
            r["bitwise_vs_ln64"] = bool(torch.equal(got, small))
            r["max_abs_vs_ln64"] = float((got.float() - small.float()).abs().max())
        out["checks"][name] = r

    dev, b16 = torch.device("cuda"), torch.bfloat16
    out = {"label": args.label, "root": args.root, "device": nvidia_smi(), "times": {},
           "checks": {}, "two_bodies": two_bodies, "what": "mlp" if args.mlp else "proj"}
    dumps = {}
    for label, b, c in MLP_SHAPES:
        f = 4 * c
        for n, xdt in ((321, b16), (361, torch.float32)):
            rng = np.random.default_rng(args.seed + b + n + c)

            def arr(a, dt=torch.float32):
                return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)

            xt = "bf16" if xdt == b16 else "fp32"
            key = f"{label}_M{b * n}_{xt}x"
            x = arr(rng.normal(size=(b, n, c)), xdt)
            times = {}
            if args.mlp:
                g, be = arr(1 + 0.1 * rng.normal(size=c)), arr(0.1 * rng.normal(size=c))
                w1 = arr(rng.normal(size=(f, c)) / np.sqrt(c), b16)
                w2 = arr(rng.normal(size=(c, f)) / np.sqrt(f), b16)
                b1, b2 = arr(0.02 * rng.normal(size=f)), arr(0.02 * rng.normal(size=c))
                hidden = torch.empty((b * n, f), dtype=b16, device=dev)
                o = torch.empty((b, n, c), dtype=b16, device=dev)
                h3 = hidden.view(b, n, f)

                def fc1_lib():
                    y = F.layer_norm(x.float(), (c,), g, be, 1e-6).to(b16)
                    return F.gelu(F.linear(y, w1, b1.to(b16)))

                def stage(name):
                    return lambda: lm.launch_ln_mlp(x, g, be, w1, b1, w2, b2, hidden, o,
                                                    stages=name)

                name = f"ln_mlp[{xt}x-bf16w]"
                launches = {
                    "ln_fc1_gelu": (stage("ln_fc1_gelu"), fc1_lib),
                    "fc2_bias": (stage("fc2_bias"), lambda: F.linear(h3, w2, b2.to(b16))),
                    "pair": (stage("pair"), lambda: F.linear(fc1_lib(), w2, b2.to(b16)))}
                stage("pair")()  # the hidden tensor fc2_bias reads
                for launch, (kern, lib) in launches.items():
                    fns = variants(kern, lib)
                    if two_bodies and launch == "ln_fc1_gelu":
                        fns["lm"]()
                        got = hidden.clone()
                        fns["lm"]()
                        again = hidden.clone()
                        fns["ln64"]()
                        check(f"{key} {name} {launch}", got, again,
                              lm.ln_fc1_gelu_plain(x, g, be, w1, b1).to(b16).view(b * n, f),
                              KERNEL_ATOL["ln_fc1_gelu"], KERNEL_RTOL, hidden.clone())
                    elif two_bodies:
                        fns["lm"]()
                        got = o.clone()
                        fns["lm"]()
                        again = o.clone()
                        fns["ln64"]()
                        plain = (lm.fc2_bias_plain(h3, w2, b2) if launch == "fc2_bias" else
                                 lm.ln_mlp_plain(x, g, be, w1, b1, w2, b2))
                        check(f"{key} {name} {launch}", got, again, plain,
                              KERNEL_ATOL[launch if launch == "fc2_bias" else "ln_mlp"],
                              KERNEL_RTOL, o.clone())
                    kern()
                    dumps[f"{key} {name} {launch}"] = (
                        hidden if launch == "ln_fc1_gelu" else o).float().cpu().numpy()
                    if not args.check_only:
                        times.update({f"{name} {launch} {k}": graph_time_ms(fn)[0]
                                      for k, fn in fns.items()})
            else:
                wp = arr(rng.normal(size=(c, c)) / np.sqrt(c), b16)
                bp = arr(0.02 * rng.normal(size=c))
                wpq = quant.quantize_weight(wp)
                wpd = wpq.materialize(xdt)
                attn = arr(0.3 * rng.normal(size=(b, n, c)), xdt)  # #6's A: x's dtype
                a16 = attn.to(b16)
                insts = {
                    f"proj_residual[{xt}x-bf16a-bf16w]": (
                        lambda: lqp.proj_residual(x, a16, wp, bp),
                        lambda: lqp.proj_residual_plain(x, a16, wp, bp),
                        lambda: torch.add(x, F.linear(a16, wp, bp.to(b16))), "proj_residual"),
                    f"proj_residual[{xt}x-{xt}a-int8w]": (
                        lambda: lqp.proj_residual(x, attn, wpq.q, bp, wpq.scale),
                        lambda: lqp.proj_residual_plain(x, attn, wpq, bp),
                        lambda: torch.add(x, F.linear(attn, wpd, bp.to(xdt))),
                        None if xdt == torch.float32 else "proj_residual")}
                for name, (kern, plain, lib, tol_key) in insts.items():
                    fns = variants(kern, lib)
                    if two_bodies:
                        got, again, small = fns["lm"](), fns["lm"](), fns["ln64"]()
                        atol = F32_ATOL if tol_key is None else Q8_KERNEL_ATOL[tol_key]
                        rtol = F32_RTOL if tol_key is None else KERNEL_RTOL
                        check(f"{key} {name}", got, again, plain(), atol, rtol, small)
                    dumps[f"{key} {name}"] = kern().float().cpu().numpy()
                    if not args.check_only:
                        times.update({f"{name} {k}": graph_time_ms(fn)[0]
                                      for k, fn in fns.items()})
            out["times"][key] = times
    dump_and_compare(args, dumps, out)
    print(json.dumps(out), flush=True)
    return 0


# (label, M, C): the four cells' rows at B=1 (N = 321, 361) and B=8
DOT_SHAPES = tuple((f"{model}_M{m}", m, c) for model, c in (("B", 768), ("L", 1024))
                   for m in (321, 361, 2568, 2888))
DOT_RTOL = 1e-5  # of sum_k |a||w|: fp32 sums of exact products in two orders


def dot_ab(args) -> int:
    """The default path's products at DOT_SHAPES (PERF.md row D): device ms
    (a CUDA graph of 20 calls) of the checkout's product, of each core
    schedule, of dot_f32 and of torch.mm with an fp32 out; the checks."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("gemm_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import graph_time_ms, nvidia_smi
    from uvltrack_tpu_torch.ops import ln_qkv_attn_proj as lqp
    from uvltrack_tpu_torch.ops import quant

    dev, b16 = torch.device("cuda"), torch.bfloat16
    core = getattr(lqp, "launch_dense", None)
    default = getattr(lqp, "dense_f32", quant.dot_f32)
    out = {"label": args.label, "root": args.root, "device": nvidia_smi(), "times": {},
           "checks": {}}
    dumps, failed = {}, []
    for label, m, c in DOT_SHAPES:
        for prod, k, n in (("proj", c, c), ("fc1", c, 4 * c), ("fc2", 4 * c, c)):
            rng = np.random.default_rng(args.seed + m + k + n)
            a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dev, b16)
            w = torch.from_numpy((rng.normal(size=(n, k)) / np.sqrt(k)).astype(np.float32)
                                 ).to(dev, b16)
            fns = {"default": lambda: default(a, w)}
            if core is not None:
                fns["lm"] = lambda: core(a, w, 0)
                for parts in range(1, 4):
                    fns[f"split{parts}"] = lambda parts=parts: core(a, w, parts)
            lib = {"dot_f32": lambda: quant.dot_f32(a, w),
                   "library": lambda: torch.mm(a, w.t(), out_dtype=torch.float32)}
            key = f"{label}_{prod}"
            ref = quant.dot_f32(a, w)
            bound = DOT_RTOL * (a.float().abs() @ w.float().abs().t())
            checks = {}
            for name, fn in fns.items():
                r, again = fn(), fn()
                gap = float(((r - ref).abs() / bound).max())
                checks[name] = {"gap_over_bound": gap, "bitwise_again": bool(torch.equal(r, again))}
                if gap > 1 or not checks[name]["bitwise_again"]:
                    failed.append(f"{key} {name}")
                dumps[f"{key} {name}"] = r.cpu().numpy()
            out["checks"][key] = checks
            if not args.check_only:
                out["times"][key] = {name: graph_time_ms(fn)[0]
                                     for name, fn in {**fns, **lib}.items()}
    out["failed"] = failed
    dump_and_compare(args, dumps, out)
    print(json.dumps(out), flush=True)
    return 1 if failed else 0


# (label, B, H): the shapes whose (b, h) pairs take the batch body
# (chip_smoke.py's AB_SHAPES), then the sweep of B=1-4 at B's and L's heads
ATTN_SHAPES = (("B_S4", 4, 12), ("B_S8", 8, 12), ("L_S8", 8, 16), ("B_TRAIN", 16, 12),
               ("B_tp2", 16, 6), ("B_tp4", 16, 3))
ATTN_SWEEP = tuple((f"H{h}_B{b}", b, h) for h in (12, 16) for b in (1, 2, 3, 4))


def attn_ab(args) -> int:
    """qkv_attention's bodies (PERF.md rows 2m and 5bm): device ms (a CUDA
    graph of 20 calls) of the wrapper's choice, of each body forced where
    this checkout has both, and of SDPA on the same inputs; the batch body
    against the plain version, a second call and the split body."""
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("gemm_ab: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import F32_ATOL, F32_RTOL, KERNEL_ATOL, KERNEL_RTOL, graph_time_ms, nvidia_smi
    from uvltrack_tpu_torch.ops import ln_qkv_attention as lqa

    two_bodies = hasattr(lqa, "ATTN_BATCH_PAIRS")

    def body(fn, pairs):
        """fn with the batch threshold at `pairs` (0: the batch body; 1 << 62:
        the split body)"""
        def call():
            was, lqa.ATTN_BATCH_PAIRS = lqa.ATTN_BATCH_PAIRS, pairs
            try:
                return fn()
            finally:
                lqa.ATTN_BATCH_PAIRS = was
        return call

    dev = torch.device("cuda")
    out = {"label": args.label, "root": args.root, "device": nvidia_smi(), "times": {},
           "checks": {}, "two_bodies": two_bodies, "split": {},
           "masks": "N=321 open, N=361 the last 40 (text) keys masked"}
    dumps = {}
    cases = [(label, b, h, n, dt) for label, b, h in ATTN_SHAPES + ATTN_SWEEP
             for n in (321, 361) for dt in (torch.bfloat16,)]
    cases += [(label, b, h, 361, torch.float32) for label, b, h in
              (("B_S4", 4, 12), ("B_S8", 8, 12)) + ATTN_SWEEP[:4]]
    for label, b, heads, n, dt in cases:
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed + 97 * b + 31 * heads + n)
        qkv = torch.randn((b, n, 3 * heads * 64), generator=gen, device=dev).to(dt)
        kb = torch.zeros((b, n), device=dev)
        if n == 361:
            kb[:, 321:] = -1e10
        mask = kb.to(dt)[:, None, None, :]
        tag = "bf16" if dt == torch.bfloat16 else "fp32"
        key = f"{label}_N{n}_{tag}"

        def kern(qkv=qkv, kb=kb, heads=heads):
            return lqa.qkv_attention(qkv, kb, heads)

        def sdpa(qkv=qkv, mask=mask, b=b, n=n, heads=heads):
            q, k, v = qkv.view(b, n, 3, heads, 64).permute(2, 0, 3, 1, 4).unbind(0)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

        fns = {"auto": kern, "library": sdpa}
        if two_bodies:
            fns.update({"batch": body(kern, 0), "split": body(kern, 1 << 62)})
            got, again, split = fns["batch"](), fns["batch"](), fns["split"]()
            want = lqa.qkv_attention_plain(qkv, kb, heads).float()
            torch.cuda.synchronize()
            diff = (got.float() - want).abs()
            atol, rtol = ((F32_ATOL, F32_RTOL) if tag == "fp32" else
                          (KERNEL_ATOL["qkv_attention"], KERNEL_RTOL))
            out["checks"][key] = {
                "max_abs_err": float(diff.max()),
                "ok": bool((diff <= atol + rtol * want.abs()).all()),
                "bitwise_second_call": bool(torch.equal(got, again)),
                "bitwise_vs_split": bool(torch.equal(got, split)),
                "max_abs_vs_split": float((got.float() - split.float()).abs().max())}
            out["split"][key] = lqa.attn_split(b, n, heads, tag == "fp32")
        dumps[key] = kern().float().cpu().numpy()
        if not args.check_only:
            out["times"][key] = {k: graph_time_ms(fn)[0] for k, fn in fns.items()}
    dump_and_compare(args, dumps, out)
    print(json.dumps(out), flush=True)
    return 0


def f32w_ab(args) -> int:
    """ln_qkv[fp32x-fp32w] and its fp32 library call, device ms (a CUDA graph
    of 20 calls), at the eight shapes of PERF.md's row 1b."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("gemm_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import graph_time_ms, nvidia_smi
    from uvltrack_tpu_torch.ops import ln_qkv_attention as lqa

    dev = torch.device("cuda")
    out = {"label": args.label, "root": args.root, "device": nvidia_smi(), "times": {}}
    dumps = {}
    for b in (1, 8):
        for n in (321, 361):
            for c in (768, 1024):
                rng = np.random.default_rng(args.seed + b + n + c)

                def arr(a):
                    return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

                x, g, be = (arr(rng.normal(size=(b, n, c))), arr(1 + 0.1 * rng.normal(size=c)),
                            arr(0.1 * rng.normal(size=c)))
                w = arr(rng.normal(size=(3 * c, c)) / np.sqrt(c))
                wb = arr(0.02 * rng.normal(size=3 * c))
                key = f"B{b}_N{n}_C{c}"
                dumps[key] = lqa.ln_qkv(x, g, be, w, wb).cpu().numpy()
                out["times"][key] = {
                    "ln_qkv[fp32x-fp32w]": graph_time_ms(lambda: lqa.ln_qkv(x, g, be, w, wb))[0],
                    "library": graph_time_ms(
                        lambda: F.linear(F.layer_norm(x, (c,), g, be, 1e-6), w, wb))[0]}
    dump_and_compare(args, dumps, out)
    print(json.dumps(out), flush=True)
    return 0


def attention_times(seed: int) -> dict:
    """{name: device ms} of the attention bodies and SDPA on the same inputs."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from chip_smoke import graph_time_ms
    from uvltrack_tpu_torch.ops import fused_attention as fa
    from uvltrack_tpu_torch.ops import ln_qkv_attention as lqa

    dev, heads, c = torch.device("cuda"), 12, 768
    rng = np.random.default_rng(seed + 3)

    def timed(name, kern, lib):
        return {name: graph_time_ms(kern)[0], f"{name} library": graph_time_ms(lib)[0]}

    times = {}
    for n, masked, dt in ((321, 0, torch.bfloat16), (361, 40, torch.bfloat16),
                          (361, 40, torch.float32)):
        qkv = torch.from_numpy(rng.normal(size=(1, n, 3 * c)).astype(np.float32)).to(dev, dt)
        kb = torch.zeros((1, n), device=dev)
        kb[:, n - masked:] = -1e10
        mask = kb.to(dt)[:, None, None, :]

        def sdpa(qkv=qkv, mask=mask, n=n):
            q, k, v = qkv.view(1, n, 3, heads, 64).permute(2, 0, 3, 1, 4).unbind(0)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

        tag = "bf16" if dt == torch.bfloat16 else "fp32"
        times.update(timed(f"qkv_attention[{tag}] N={n} {'flag0' if masked else 'open'}",
                           lambda qkv=qkv, kb=kb: lqa.qkv_attention(qkv, kb, heads), sdpa))
    for n in (40, 128):
        q, k, v = (torch.from_numpy(rng.normal(size=(1, n, c)).astype(np.float32))
                   .to(dev, torch.bfloat16).view(1, n, heads, 64).transpose(1, 2)
                   for _ in range(3))
        kb = torch.zeros((1, n), device=dev)
        kb[:, int(rng.integers(5, n)):] = -10000.0
        mask = kb.to(torch.bfloat16)[:, None, None, :]
        times.update(timed(f"attention[bf16] N={n}",
                           lambda q=q, k=k, v=v, kb=kb: fa.fused_attention(q, k, v, kb),
                           lambda q=q, k=k, v=v, mask=mask:
                           F.scaled_dot_product_attention(q, k, v, attn_mask=mask)))
    return times


def attention_eager(seed: int) -> dict:
    """{name: eager_ms} of kernel #3 at BERT's N=40 and N=128, in its
    strided layout."""
    import numpy as np
    import torch

    from uvltrack_tpu_torch.ops import fused_attention as fa

    dev, heads, c = torch.device("cuda"), 12, 768
    rng = np.random.default_rng(seed + 4)
    out = {}
    for n in (40, 128):
        q, k, v = (torch.from_numpy(rng.normal(size=(1, n, c)).astype(np.float32))
                   .to(dev, torch.bfloat16).view(1, n, heads, 64).transpose(1, 2)
                   for _ in range(3))
        kb = torch.zeros((1, n), device=dev)
        kb[:, int(rng.integers(5, n)):] = -10000.0
        out[f"attention[bf16] N={n}"] = eager_ms(lambda: fa.fused_attention(q, k, v, kb))
    return out


if __name__ == "__main__":
    sys.exit(main())
