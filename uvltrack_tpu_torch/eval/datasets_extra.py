"""Additional benchmark adapters: OTB100, NFS, UAV123, TC128, ITB, AVisT (a
copy of uvltrack_tpu/eval/datasets_extra.py, registering into the port's
DATASET_BUILDERS).

Parity targets: lib/test/evaluation/{otbdataset,nfsdataset,uavdataset,
tc128dataset,itbdataset,avistdataset}.py. Most are glob-driven readers of
the standard public layouts; UAV123 is table-driven from
data_specs/uav123_sequences.json (split sequences need start/end offsets).
"""

from __future__ import annotations

import glob
import os

import numpy as np

from .data import Sequence, SequenceList
from .datasets import DATASET_BUILDERS, load_text
from .environment import env_settings


def _frames_sorted(pattern: str):
    return sorted(glob.glob(pattern))


def otb_dataset() -> SequenceList:
    """OTB100: <root>/<seq>/{groundtruth_rect.txt, img/*.jpg}"""
    base = env_settings().otb_path
    seqs = []
    for d in sorted(glob.glob(os.path.join(base, "*" + os.sep))):
        name = os.path.basename(d.rstrip(os.sep))
        anno_path = os.path.join(d, "groundtruth_rect.txt")
        if not os.path.exists(anno_path):
            continue
        anno = load_text(anno_path).reshape(-1, 4)
        frames = _frames_sorted(os.path.join(d, "img", "*.jpg"))
        frames = frames[: len(anno)]
        seqs.append(Sequence(name, frames, "otb", anno))
    return SequenceList(seqs)


def nfs_dataset() -> SequenceList:
    """NFS(30fps): <root>/<seq>/30/<seq>.txt + 30/<seq>/*.jpg; annotation
    rows hold x1 y1 x2 y2 in columns 1-4 (converted to xywh)."""
    base = env_settings().nfs_path
    seqs = []
    for d in sorted(glob.glob(os.path.join(base, "*" + os.sep))):
        name = os.path.basename(d.rstrip(os.sep))
        anno_path = os.path.join(d, "30", f"{name}.txt")
        if not os.path.exists(anno_path):
            continue
        raw = np.loadtxt(anno_path, dtype=str, ndmin=2)
        xyxy = raw[:, 1:5].astype(np.float64)
        anno = np.stack([xyxy[:, 0], xyxy[:, 1], xyxy[:, 2] - xyxy[:, 0],
                         xyxy[:, 3] - xyxy[:, 1]], -1)
        frames = _frames_sorted(os.path.join(d, "30", name, "*.jpg"))
        n = min(len(frames), len(anno))
        seqs.append(Sequence(name, frames[:n], "nfs", anno[:n]))
    return SequenceList(seqs)


def uav_dataset() -> SequenceList:
    """UAV123, table-driven like the reference (uavdataset.py:47-295): the
    123-entry sequence-info table (data_specs/uav123_sequences.json, values
    extracted from the reference) carries per-sequence start/end frame
    numbers so the split sequences (bird1_1/2/3 etc.) index into their base
    clip at the right offsets. NaN annotation rows (object absent) are kept —
    the metric treats them as invalid."""
    import json

    base = env_settings().uav_path
    spec = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        os.pardir, "data_specs", "uav123_sequences.json")
    with open(os.path.normpath(spec)) as f:
        table = json.load(f)
    seqs = []
    for info in table:
        anno_path = os.path.join(base, info["anno_path"])
        if not os.path.exists(anno_path):
            continue
        anno = np.genfromtxt(anno_path, delimiter=",").reshape(-1, 4)
        init_omit = int(info.get("initOmit", 0))
        start, end, nz, ext = (info["startFrame"], info["endFrame"],
                               info["nz"], info["ext"])
        frames = [os.path.join(base, info["path"], f"{i:0{nz}d}.{ext}")
                  for i in range(start + init_omit, end + 1)]
        anno = anno[init_omit:]
        n = min(len(frames), len(anno))
        if n == 0:
            continue
        # the reference attaches the class name as BOTH object_class and
        # language (uavdataset.py:41-42)
        seqs.append(Sequence(info["name"], frames[:n], "uav", anno[:n],
                             object_class=info.get("object_class"),
                             language=info.get("object_class")))
    return SequenceList(seqs)


def tc128_dataset(ce_only: bool = False) -> SequenceList:
    """TC128: <root>/<seq>/{<seq>_gt.txt, img/*.jpg}"""
    base = env_settings().tc128_path
    seqs = []
    for d in sorted(glob.glob(os.path.join(base, "*" + os.sep))):
        name = os.path.basename(d.rstrip(os.sep))
        if ce_only and not name.endswith("_ce"):
            continue
        gt = os.path.join(d, f"{name}_gt.txt")
        if not os.path.exists(gt):
            continue
        anno = load_text(gt).reshape(-1, 4)
        frames = _frames_sorted(os.path.join(d, "img", "*.jpg"))
        n = min(len(frames), len(anno))
        seqs.append(Sequence(name, frames[:n], "tc128", anno[:n]))
    return SequenceList(seqs)


def itb_dataset() -> SequenceList:
    """ITB: <root>/<scenario>/<seq>/{groundtruth.txt, *.jpg}"""
    base = env_settings().itb_path
    seqs = []
    for d in sorted(glob.glob(os.path.join(base, "*", "*" + os.sep))):
        name = os.path.basename(d.rstrip(os.sep))
        gt = os.path.join(d, "groundtruth.txt")
        if not os.path.exists(gt):
            continue
        anno = load_text(gt).reshape(-1, 4)
        frames = _frames_sorted(os.path.join(d, "*.jpg"))
        n = min(len(frames), len(anno))
        seqs.append(Sequence(name, frames[:n], "itb", anno[:n]))
    return SequenceList(seqs)


def avist_dataset() -> SequenceList:
    """AVisT: <root>/sequences/<seq>/*.jpg + anno/<seq>.txt (+ attributes)."""
    base = env_settings().avist_path
    anno_dir = os.path.join(base, "anno")
    seqs = []
    for anno_path in sorted(glob.glob(os.path.join(anno_dir, "*.txt"))):
        name = os.path.splitext(os.path.basename(anno_path))[0]
        anno = load_text(anno_path).reshape(-1, 4)
        frames = _frames_sorted(os.path.join(base, "sequences", name, "*.jpg"))
        n = min(len(frames), len(anno))
        if n == 0:
            continue
        seqs.append(Sequence(name, frames[:n], "avist", anno[:n]))
    return SequenceList(seqs)


DATASET_BUILDERS.update({
    "otb": otb_dataset,
    "nfs": nfs_dataset,
    "uav": uav_dataset,
    "tc128": tc128_dataset,
    "tc128ce": lambda: tc128_dataset(ce_only=True),
    "itb": itb_dataset,
    "avist": avist_dataset,
})
