"""CUDA-graph device times of the GEMM launches on the TMA + wgmma core
(`ln_qkv` with bf16 and int8 weights, `proj_residual` in its four
instantiations, `ln_fc1_gelu`, `fc2_bias`) and their library yardsticks at the
tracking step's two shapes (N=321 with a bf16 stream, N=361 with an fp32
one), for A/B runs of two checkouts on one card.

    python uvltrack_tpu_torch/tools/gemm_ab.py [--root DIR] [--label NAME]

--root: the checkout whose uvltrack_tpu_torch is timed (default: the one
holding this script), built into DIR/build/kernels. The timer is
chip_smoke.py's graph_time_ms. Prints one JSON line; times in ms.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path[:0] = [args.root, str(REPO)]

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

    out = {"label": args.label, "root": args.root, "device": nvidia_smi(), "times": {}}
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
        out["times"][f"N{n}"] = {k: graph_time_ms(fn)[0] for k, fn in fns.items()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
