"""Dataset trees in the disk layouts of the training datasets, made from a seed.

The real datasets (LaSOT, GOT-10k, COCO, TrackingNet, TNL2K, OTB99,
RefCOCOg) are not in the repository; these trees stand in for them with the
same files and formats, so the whole data path (adapters, sampler,
processing, loader, cli/train) runs on them:

- LaSOT (train and test splits, listed by training_set.txt / testing_set.txt
  in the root) and LaSOT-ext: <class>/<class>-<k>/{img/%08d.jpg,
  groundtruth.txt, full_occlusion.txt, out_of_view.txt, nlp.txt};
- GOT-10k: train/{list.txt, GOT-10k_Train_%06d/{%08d.jpg, groundtruth.txt,
  absence.label, cover.label}} and its vottrain split table in the root;
- TrackingNet: TRAIN_0/{anno/<seq>.txt, frames/<seq>/<i>.jpg};
- TNL2K (train/ and test/): <seq>/{imgs/%05d.jpg, groundtruth.txt,
  language.txt};
- OTB99: OTB_videos/<seq>/{img/%04d.jpg, groundtruth_rect.txt} and
  OTB_query_{train,test}/<seq>.txt;
- COCO 2017 instances (annotations/instances_train2017.json, train2017/)
  and RefCOCOg (refcocog/{refs(google).p, instances.json}, train2014/) in
  one root;
- GOT-10k packed as LMDB (the got10k_lmdb keys), written by
  utils/lmdb_native.write_lmdb.

Video frames are JPEGs of `frame_hw` (a blocky texture, a textured target
moving across it), still images of `image_hw`. A few clips are encoded and
hard-linked into every video layout. Sentences come from WORDS, with
direction words among them, so a vocabulary of WORDS tokenizes all of them.

    python -m uvltrack_tpu_torch.tools.data_fixtures --root DIR [--seed 0]
        [--frame 720x1280] [--image 480x640] [--seqs 3] [--frames 24]

writes the trees under DIR and prints the UVLTRACK_<NAME>_PATH variables
that point data/builders.py at them.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

WORDS = ("the", "a", "red", "blue", "small", "big", "car", "dog", "person", "bird", "boat",
         "on", "in", "of", "left", "right", "top", "middle", "moving", "running", "near",
         "water", "road", "grass")
CLASSES = ("airplane", "bird", "car", "dog")


def _sentence(rng: np.random.Generator) -> str:
    n = int(rng.integers(3, 8))
    return " ".join(rng.choice(WORDS, n)).capitalize()


def _clip(rng: np.random.Generator, hw: Tuple[int, int], n: int, quality: int):
    """(JPEG bytes of n frames, (n, 4) xywh boxes): a blocky background and a
    textured target on a smooth path."""
    import cv2

    h, w = hw
    block = max(2, min(h, w) // 40)
    coarse = rng.integers(0, 256, size=(h // block + 1, w // block + 1, 3)).astype(np.uint8)
    bg = np.repeat(np.repeat(coarse, block, 0), block, 1)[:h, :w]
    bg = bg // 2 + rng.integers(0, 32, size=(h, w, 3), dtype=np.uint8)
    tw = int(rng.integers(max(4, w // 12), max(5, w // 5)))
    th = int(rng.integers(max(4, h // 12), max(5, h // 5)))
    tex = rng.integers(0, 256, size=(max(1, th // 4), max(1, tw // 4), 3)).astype(np.uint8)
    target = cv2.resize(tex, (tw, th), interpolation=cv2.INTER_NEAREST)
    x0, y0 = rng.uniform(0, w - tw), rng.uniform(0, h - th)
    vx, vy = rng.uniform(-0.01, 0.01) * w, rng.uniform(-0.01, 0.01) * h
    frames, boxes = [], []
    for t in range(n):
        x = int(np.clip(x0 + vx * t, 0, w - tw))
        y = int(np.clip(y0 + vy * t, 0, h - th))
        f = bg.copy()
        f[y:y + th, x:x + tw] = target
        ok, buf = cv2.imencode(".jpg", f[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality])
        assert ok
        frames.append(buf.tobytes())
        boxes.append([x, y, tw, th])
    return frames, np.asarray(boxes, np.int64)


def _link(src: Path, dst: Path) -> None:
    dst.parent.mkdir(parents=True, exist_ok=True)
    try:
        os.link(src, dst)
    except OSError:
        dst.write_bytes(src.read_bytes())


def _rows(boxes: np.ndarray) -> str:
    return "".join(f"{x},{y},{w},{h}\n" for x, y, w, h in boxes)


def write_trees(root, seed: int = 0, frame_hw=(720, 1280), image_hw=(480, 640),
                n_seq: int = 3, n_frames: int = 24, quality: int = 90) -> Dict[str, str]:
    """Write every tree under `root`; returns {UVLTRACK_<NAME>_PATH: path}.
    Each video dataset gets n_seq sequences of n_frames frames, one frame of
    each occluded or absent where the layout can say so."""
    import cv2

    from ..utils.lmdb_native import write_lmdb

    root = Path(root)
    rng = np.random.default_rng(seed)
    pool = root / "_clips"
    clips = []
    for c in range(2 * n_seq):
        frames, boxes = _clip(rng, frame_hw, n_frames, quality)
        paths = []
        for i, data in enumerate(frames):
            p = pool / f"{c}" / f"{i}.jpg"
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_bytes(data)
            paths.append(p)
        clips.append((paths, boxes))

    def clip(k):
        return clips[k % len(clips)]

    def hidden():  # an occluded / absent frame, never the first
        return int(rng.integers(1, n_frames))

    env = {}
    # LaSOT (train, test) and LaSOT-ext
    for name, splits in (("lasot", ("train", "test")), ("lasotext", ("train",))):
        base = root / name
        for s, split in enumerate(splits):
            seqs = []
            for k in range(n_seq):
                cls = CLASSES[k % len(CLASSES)]
                seq = f"{cls}-{s * n_seq + k + 1}"
                d = base / cls / seq
                paths, boxes = clip(s * n_seq + k)
                for i, p in enumerate(paths):
                    _link(p, d / "img" / f"{i + 1:08d}.jpg")
                (d / "groundtruth.txt").write_text(_rows(boxes))
                occ = np.zeros(n_frames, np.int64)
                occ[hidden()] = 1
                (d / "full_occlusion.txt").write_text(",".join(map(str, occ)))
                (d / "out_of_view.txt").write_text(",".join(["0"] * n_frames))
                (d / "nlp.txt").write_text(_sentence(rng) + "\n")
                seqs.append(seq)
            if name == "lasot":
                (base / f"{split}ing_set.txt").write_text("\n".join(seqs) + "\n")
        env[f"UVLTRACK_{name.upper()}_PATH"] = str(base)

    # GOT-10k, on disk and as LMDB
    base = root / "got10k"
    seqs = [f"GOT-10k_Train_{k + 1:06d}" for k in range(n_seq)]
    items = [("train/list.txt", "\n".join(seqs) + "\n")]
    for k, seq in enumerate(seqs):
        d = base / "train" / seq
        paths, boxes = clip(k + 1)
        absence = np.zeros(n_frames, np.int64)
        absence[hidden()] = 1
        cover = rng.integers(1, 9, n_frames)
        files = {"groundtruth.txt": _rows(boxes),
                 "absence.label": "".join(f"{a}\n" for a in absence),
                 "cover.label": "".join(f"{c}\n" for c in cover)}
        for fn, text in files.items():
            (d / fn).parent.mkdir(parents=True, exist_ok=True)
            (d / fn).write_text(text)
            items.append((f"train/{seq}/{fn}", text))
        for i, p in enumerate(paths):
            _link(p, d / f"{i + 1:08d}.jpg")
            items.append((f"train/{seq}/{i + 1:08d}.jpg", p.read_bytes()))
    (base / "train" / "list.txt").write_text(items[0][1])
    split_table = "".join(f"{k}\n" for k in range(n_seq))
    (base / "got10k_vot_train_split.txt").write_text(split_table)
    env["UVLTRACK_GOT10K_PATH"] = str(base)
    lmdb_dir = root / "got10k_lmdb"
    write_lmdb(str(lmdb_dir), items)
    (lmdb_dir / "got10k_vot_train_split.txt").write_text(split_table)
    env["UVLTRACK_GOT10K_LMDB_PATH"] = str(lmdb_dir)

    # TrackingNet
    base = root / "trackingnet"
    for k in range(n_seq):
        seq = f"seq_{k:03d}"
        paths, boxes = clip(k + 2)
        (base / "TRAIN_0" / "anno").mkdir(parents=True, exist_ok=True)
        (base / "TRAIN_0" / "anno" / f"{seq}.txt").write_text(_rows(boxes))
        for i, p in enumerate(paths):
            _link(p, base / "TRAIN_0" / "frames" / seq / f"{i}.jpg")
    env["UVLTRACK_TRACKINGNET_PATH"] = str(base)

    # TNL2K: train/ and test/ (TNL2K_test swaps the leaf)
    for s, split in enumerate(("train", "test")):
        for k in range(n_seq):
            d = root / "tnl2k" / split / f"video_{s * n_seq + k:03d}"
            paths, boxes = clip(s * n_seq + k + 3)
            for i, p in enumerate(paths):
                _link(p, d / "imgs" / f"{i:05d}.jpg")
            (d / "groundtruth.txt").write_text(_rows(boxes))
            (d / "language.txt").write_text(_sentence(rng) + "\n")
    env["UVLTRACK_TNL2K_PATH"] = str(root / "tnl2k" / "train")

    # OTB99: one OTB_videos tree, a query file per split
    base = root / "otb99"
    for s, split in enumerate(("train", "test")):
        for k in range(n_seq):
            seq = f"Seq{s * n_seq + k:02d}"
            d = base / "OTB_videos" / seq
            paths, boxes = clip(s * n_seq + k + 4)
            for i, p in enumerate(paths):
                _link(p, d / "img" / f"{i + 1:04d}.jpg")
            (d / "groundtruth_rect.txt").write_text(_rows(boxes))
            q = base / f"OTB_query_{split}" / f"{seq}.txt"
            q.parent.mkdir(parents=True, exist_ok=True)
            q.write_text(_sentence(rng) + "\n")
    env["UVLTRACK_OTB99_PATH"] = str(base)

    # COCO 2017 instances and RefCOCOg under one root
    base = root / "coco"
    ih, iw = image_hw
    images, anns, refs = [], [], []
    for k in range(2 * n_seq):
        fname = f"{k + 1:012d}.jpg"
        img = rng.integers(0, 256, size=(ih // 8 + 1, iw // 8 + 1, 3)).astype(np.uint8)
        img = np.repeat(np.repeat(img, 8, 0), 8, 1)[:ih, :iw]
        for sub in ("train2017", "train2014"):
            (base / sub).mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(base / sub / fname), img, [cv2.IMWRITE_JPEG_QUALITY, quality])
        images.append({"id": k + 1, "file_name": fname, "height": ih, "width": iw})
        for j, crowd in enumerate((0, 0, 1)):
            w = int(rng.integers(iw // 10, iw // 3))
            h = int(rng.integers(ih // 10, ih // 3))
            x, y = int(rng.integers(0, iw - w)), int(rng.integers(0, ih - h))
            ann_id = 10 * (k + 1) + j
            anns.append({"id": ann_id, "image_id": k + 1, "bbox": [x, y, w, h],
                         "category_id": 1 + (k + j) % len(CLASSES), "iscrowd": crowd})
            if not crowd:
                refs.append({"ann_id": ann_id, "image_id": k + 1,
                             "split": "val" if k % 3 == 2 else "train",
                             "sentences": [{"sent": _sentence(rng)}, {"sent": _sentence(rng)}]})
    inst = {"images": images, "annotations": anns,
            "categories": [{"id": i + 1, "name": c} for i, c in enumerate(CLASSES)]}
    (base / "annotations").mkdir(parents=True, exist_ok=True)
    (base / "annotations" / "instances_train2017.json").write_text(json.dumps(inst))
    (base / "refcocog").mkdir(parents=True, exist_ok=True)
    (base / "refcocog" / "instances.json").write_text(json.dumps(inst))
    with open(base / "refcocog" / "refs(google).p", "wb") as f:
        pickle.dump(refs, f)
    env["UVLTRACK_COCO_PATH"] = str(base)
    return env


def vocab_words() -> List[str]:
    """Every word the trees' sentences and COCO's class names use."""
    return sorted(set(WORDS) | set(CLASSES))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--frame", default="720x1280", help="video frame HxW")
    p.add_argument("--image", default="480x640", help="still image HxW")
    p.add_argument("--seqs", type=int, default=3)
    p.add_argument("--frames", type=int, default=24)
    a = p.parse_args(argv)
    env = write_trees(a.root, a.seed, tuple(map(int, a.frame.split("x"))),
                      tuple(map(int, a.image.split("x"))), a.seqs, a.frames)
    for k, v in env.items():
        print(f"export {k}={v}")


if __name__ == "__main__":
    main()
