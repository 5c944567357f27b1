"""Video demo CLI of the port (port of uvltrack_tpu/cli/demo.py; parity:
demo.py): track a target through a video file and write an annotated mp4.
The mode follows the flags: --init_bbox alone BBOX, --language alone NL
(initialized by the grounding forward), both NLBBOX.

    python -m uvltrack_tpu_torch.cli.demo --video clip.mp4 --output out.mp4 \\
        --init_bbox X Y W H [--language "..."] [--test_checkpoint CKPT] \\
        [--device cpu]

Frames are decoded and written with cv2 (VideoCapture, VideoWriter mp4v);
every decoded frame is tracked and written once, the first with its init
box. main() returns the boxes (xywh, one a frame). The model runs on the
card unless --device cpu is given: without a card and without that flag
the CLI stops with an error before building anything.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--tracker_name", default="uvltrack")
    p.add_argument("--tracker_param", default="baseline_base")
    p.add_argument("--video", required=True)
    p.add_argument("--output", default="demo_out.mp4")
    p.add_argument("--init_bbox", type=float, nargs=4, default=None,
                   help="x y w h on the first frame")
    p.add_argument("--language", default=None)
    p.add_argument("--test_checkpoint", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions)")
    args = p.parse_args(argv)

    import cv2

    from ..config import load_cfg
    from ..eval.environment import env_settings, experiment_cfg_path
    from ..models.uvltrack import resolve_device
    from .test import build_tracker

    device = resolve_device(args.device)  # no card, no --device cpu: stop here
    cfg = load_cfg(experiment_cfg_path(env_settings(), args.tracker_name, args.tracker_param))
    if args.init_bbox and args.language:
        cfg.TEST.MODE = "NLBBOX"
    elif args.language:
        cfg.TEST.MODE = "NL"
    else:
        cfg.TEST.MODE = "BBOX"
        if not args.init_bbox:
            raise SystemExit("need --init_bbox and/or --language")

    tracker = build_tracker(cfg, args.test_checkpoint, device=device)

    cap = cv2.VideoCapture(args.video)
    ok, frame_bgr = cap.read()
    if not ok:
        raise SystemExit(f"cannot read {args.video}")
    h, w = frame_bgr.shape[:2]
    fps = cap.get(cv2.CAP_PROP_FPS) or 30
    writer = cv2.VideoWriter(args.output, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))

    info = {}
    if args.init_bbox:
        info["init_bbox"] = list(args.init_bbox)
    if args.language:
        info["language"] = args.language
    out = tracker.initialize(cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2RGB), info)
    box = out.get("target_bbox", args.init_bbox)

    def draw(img, b, color=(0, 255, 0)):
        x, y, bw, bh = (int(v) for v in b)
        cv2.rectangle(img, (x, y), (x + bw, y + bh), color, 2)
        return img

    writer.write(draw(frame_bgr, box))
    boxes = [list(box)]
    while True:
        ok, frame_bgr = cap.read()
        if not ok:
            break
        out = tracker.track(cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2RGB))
        writer.write(draw(frame_bgr, out["target_bbox"]))
        boxes.append(out["target_bbox"])
    writer.release()
    cap.release()
    print(f"tracked {len(boxes)} frames -> {args.output}")
    return boxes


if __name__ == "__main__":
    main()
