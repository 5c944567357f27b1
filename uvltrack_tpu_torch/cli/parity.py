"""Checkpoint-parity dump tool of the port (port of
uvltrack_tpu/cli/parity.py).

Loads a checkpoint through the converter, runs the forward at fp32 compute
on a deterministic input, and writes every stage's outputs to an .npz with
the JAX tool's keys: so a released UVLTrack .pth.tar can be checked stage
by stage (backbone features, prompts, cont scores, cls map, bbox map)
against the reference or the JAX package, and two dumps of this tool (on
the kernels and on the plain backend, or with --quant int8) against each
other.

    python -m uvltrack_tpu_torch.cli.parity --checkpoint UVLTrack_ep0300.pth.tar \\
        --config baseline_base --out parity_dump.npz [--image frame.jpg \\
        --bbox X Y W H] [--language "..."] [--quant int8] [--device cpu]

Without --image the template and search inputs are drawn from --seed
(numpy, the JAX tool's draws); with it, they are the frame's crops around
--bbox through the port's track/pipeline.py. The model runs on the card
unless --device cpu is given: without a card and without that flag the CLI
stops with an error before building anything.
"""

from __future__ import annotations

import argparse

import numpy as np

OUT_KEYS = ("search", "template", "vis_token", "txt_token", "logits", "cls_score_test",
            "cont_score", "bbox_map", "pred_boxes")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--tracker_name", default="uvltrack")
    p.add_argument("--config", default="baseline_base")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--out", default="parity_dump.npz")
    p.add_argument("--image", default=None, help="optional real frame")
    p.add_argument("--bbox", type=float, nargs=4, default=None)
    p.add_argument("--language", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quant", default=None, choices=("int8",),
                   help="dump the weight-only-int8 path instead of fp "
                        "(cfg.TPU.WEIGHT_QUANT): diff two dumps to measure "
                        "quantization drift stage by stage at real weights")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions)")
    args = p.parse_args(argv)

    import torch

    from ..config import load_cfg
    from ..eval.environment import env_settings, experiment_cfg_path
    from ..models.uvltrack import resolve_device
    from .test import build_tracker

    device = resolve_device(args.device)  # no card, no --device cpu: stop here
    cfg = load_cfg(experiment_cfg_path(env_settings(), args.tracker_name, args.config))
    cfg.TPU.COMPUTE_DTYPE = "float32"  # parity dumps in full precision
    if args.quant:
        cfg.TPU.WEIGHT_QUANT = args.quant
    tracker = build_tracker(cfg, args.checkpoint, device=device)
    model = tracker.model  # prepared: int8 with --quant

    tz, sx = cfg.DATA.TEMPLATE.SIZE, cfg.DATA.SEARCH.SIZE
    nt = cfg.MODEL.BACKBONE.LANGUAGE.BERT.MAX_QUERY_LEN
    rng = np.random.default_rng(args.seed)

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    if args.image:
        import cv2

        from ..track.pipeline import sample_target_device

        frame = dev(cv2.cvtColor(cv2.imread(args.image), cv2.COLOR_BGR2RGB))
        box = dev(np.asarray(args.bbox, np.float32))
        template, _ = sample_target_device(frame, box, cfg.TEST.TEMPLATE_FACTOR, tz)
        search, _ = sample_target_device(frame, box, cfg.TEST.SEARCH_FACTOR, sx)
    else:
        template = dev(rng.normal(size=(1, tz, tz, 3)))
        search = dev(rng.normal(size=(1, sx, sx, 3)))

    if args.language and tracker.tokenizer:
        ids, mask = tracker.tokenizer.encode_query(args.language, nt)
        text_ids = dev(np.asarray(ids, np.int32)[None], torch.int32)
        text_mask = dev(np.asarray(mask, np.int32)[None], torch.int32)
        flag = dev(np.full((1,), 2), torch.int32)
    else:
        text_ids = dev(np.zeros((1, nt)), torch.int32)
        text_mask = dev(np.zeros((1, nt)), torch.int32)
        flag = dev(np.zeros((1,)), torch.int32)

    # one template and one context cell marked, where the map has them (the
    # JAX tool's .at[:, i].set(True) drops an index past the map's cells)
    tmask = torch.zeros((1, (tz // 16) ** 2), dtype=torch.bool, device=device)
    cmask = torch.zeros((1, (sx // 16) ** 2), dtype=torch.bool, device=device)
    for m, i in ((tmask, 5), (cmask, 120)):
        if i < m.shape[1]:
            m[:, i] = True

    with torch.no_grad():
        prompt = model.forward_prompt_init(template, search, text_ids, text_mask, tmask, cmask,
                                           flag)
        out = model.forward_test(template, search, text_ids, text_mask, prompt, flag)

    dump = {"template": template, "search": search, "text_ids": text_ids,
            "text_mask": text_mask, "flag": flag, "prompt": prompt}
    for k in OUT_KEYS:
        if k in out:
            dump[f"out_{k}"] = out[k]
    np.savez(args.out, **{k: v.detach().cpu().numpy() for k, v in dump.items()})
    print(f"wrote {args.out}: " + ", ".join(sorted(dump)))


if __name__ == "__main__":
    main()
