"""Benchmark dataset adapters -> SequenceList (a copy of
uvltrack_tpu/eval/datasets.py: framework-free, so the port keeps its own;
LMDB reads go through the port's utils/lmdb_utils.py).

Covers the evaluation benchmarks UVLTrack reports on
(lib/test/evaluation/datasets.py:9-26). Adapters are glob-driven readers of
the standard public dataset layouts:
  otb99:       OTB_videos/<seq>/{groundtruth_rect.txt,img/*}, OTB_query_test/<seq>.txt
  tnl2k:       <seq>/{groundtruth.txt,imgs/*,language.txt}
  lasot(+ext): <class>/<class-N>/{groundtruth.txt,full_occlusion.txt,
               out_of_view.txt,nlp.txt,img/%08d.jpg}
  got10k:      <split dir>/<seq>/groundtruth.txt + list.txt
  trackingnet: <SET>/anno/<seq>.txt + <SET>/frames/<seq>/<i>.jpg
"""

from __future__ import annotations

import glob
import os
from typing import Callable, Dict

import numpy as np

from .data import Sequence, SequenceList
from .environment import env_settings


def load_text(path: str, delimiters=(",", "\t", " "), dtype=np.float64) -> np.ndarray:
    for d in delimiters:
        try:
            arr = np.loadtxt(path, delimiter=d, dtype=dtype)
            if arr.ndim >= 1:
                return arr
        except Exception:
            continue
    raise IOError(f"cannot parse annotation file {path}")


def _read_first_line(path: str) -> str:
    with open(path) as f:
        return f.readlines()[0].rstrip()


# ----------------------------------------------------------------- adapters

def otb99_dataset(split: str = "test") -> SequenceList:
    base = env_settings().otb99_path
    query_dir = os.path.join(base, f"OTB_query_{split}")
    names = sorted(os.path.splitext(os.path.basename(p))[0]
                   for p in glob.glob(os.path.join(query_dir, "*")))
    seqs = []
    for name in names:
        anno = load_text(os.path.join(base, "OTB_videos", name, "groundtruth_rect.txt"))
        frames = sorted(glob.glob(os.path.join(base, "OTB_videos", name, "img", "*")))
        language = _read_first_line(os.path.join(query_dir, f"{name}.txt"))
        seqs.append(Sequence(name, frames, "otb99", anno.reshape(-1, 4), language=language))
    return SequenceList(seqs)


def tnl2k_dataset() -> SequenceList:
    base = env_settings().tnl2k_path
    names = sorted(os.path.basename(os.path.dirname(p))
                   for p in glob.glob(os.path.join(base, "*/")))
    seqs = []
    for name in names:
        anno = load_text(os.path.join(base, name, "groundtruth.txt"))
        frames = sorted(glob.glob(os.path.join(base, name, "imgs", "*")))
        language = _read_first_line(os.path.join(base, name, "language.txt"))
        seqs.append(Sequence(name, frames, "tnl2k", anno.reshape(-1, 4), language=language))
    return SequenceList(seqs)


def _lasot_like(base: str, dataset_tag: str) -> SequenceList:
    seq_dirs = sorted(glob.glob(os.path.join(base, "*", "*-*" + os.sep)))
    seqs = []
    for d in seq_dirs:
        d = d.rstrip(os.sep)
        name = os.path.basename(d)
        cls = os.path.basename(os.path.dirname(d))
        anno = load_text(os.path.join(d, "groundtruth.txt")).reshape(-1, 4)
        occ = load_text(os.path.join(d, "full_occlusion.txt")).reshape(-1)
        oov = load_text(os.path.join(d, "out_of_view.txt")).reshape(-1)
        visible = np.logical_and(occ == 0, oov == 0)
        frames = [os.path.join(d, "img", f"{i:08d}.jpg") for i in range(1, anno.shape[0] + 1)]
        language = None
        nlp = os.path.join(d, "nlp.txt")
        if os.path.exists(nlp):
            language = _read_first_line(nlp)
        seqs.append(Sequence(name, frames, dataset_tag, anno, object_class=cls,
                             target_visible=visible, language=language))
    return SequenceList(seqs)


def lasot_dataset() -> SequenceList:
    return _lasot_like(env_settings().lasot_path, "lasot")


def lasotext_dataset() -> SequenceList:
    return _lasot_like(env_settings().lasotext_path, "lasotext")


def got10k_dataset(split: str = "test") -> SequenceList:
    base = env_settings().got10k_path
    root = base
    if split in ("test", "val"):
        base = os.path.join(base, split)
    elif split == "ltrval":  # train subset held out via got10k_val_split.txt
        base = os.path.join(base, "train")
    with open(os.path.join(base, "list.txt")) as f:
        names = f.read().splitlines()
    if split == "ltrval":
        split_file = os.path.join(root, "got10k_val_split.txt")
        if not os.path.exists(split_file):
            split_file = os.path.join(env_settings().repo_dir, "data_specs",
                                      "got10k_val_split.txt")
        if not os.path.exists(split_file):
            # silently returning the full train list would score the wrong
            # split; fail loudly instead
            raise FileNotFoundError(
                "got10k_ltrval needs got10k_val_split.txt in the dataset root "
                "or data_specs/ (see data_specs/README.md)")
        with open(split_file) as f:
            ids = [int(l) for l in f if l.strip()]
        names = [names[i] for i in ids]
    seqs = []
    for name in names:
        if not name:
            continue
        anno = load_text(os.path.join(base, name, "groundtruth.txt")).reshape(-1, 4)
        frame_files = sorted(
            (f for f in os.listdir(os.path.join(base, name)) if f.endswith(".jpg")),
            key=lambda f: int(f[:-4]))
        frames = [os.path.join(base, name, f) for f in frame_files]
        seqs.append(Sequence(name, frames, "got10k", anno))
    return SequenceList(seqs)


def trackingnet_dataset(set_name: str = "TEST") -> SequenceList:
    base = env_settings().trackingnet_path
    anno_dir = os.path.join(base, set_name, "anno")
    names = sorted(os.path.splitext(f)[0] for f in os.listdir(anno_dir) if f.endswith(".txt"))
    seqs = []
    for name in names:
        anno = load_text(os.path.join(anno_dir, f"{name}.txt")).reshape(-1, 4)
        fdir = os.path.join(base, set_name, "frames", name)
        frame_files = sorted((f for f in os.listdir(fdir) if f.endswith(".jpg")),
                             key=lambda f: int(os.path.splitext(f)[0]))
        frames = [os.path.join(fdir, f) for f in frame_files]
        seqs.append(Sequence(name, frames, "trackingnet", anno))
    return SequenceList(seqs)


DATASET_BUILDERS: Dict[str, Callable[[], SequenceList]] = {
    "otb99": lambda: otb99_dataset("test"),
    "otb99_train": lambda: otb99_dataset("train"),
    "tnl2k": tnl2k_dataset,
    "lasot": lasot_dataset,
    "lasotext": lasotext_dataset,
    "got10k_test": lambda: got10k_dataset("test"),
    "got10k_val": lambda: got10k_dataset("val"),
    "got10k_ltrval": lambda: got10k_dataset("ltrval"),
    "trackingnet": lambda: trackingnet_dataset("TEST"),
    "lasot_lmdb": lambda: _lasot_lmdb_dataset(),
}


def _lasot_lmdb_dataset() -> SequenceList:
    """LMDB-packed LaSOT test set (parity: lib/test/evaluation/
    lasot_lmdbdataset.py). Keys: '<class>/<seq>/groundtruth.txt' (newline
    rows), '<class>/<seq>/{full_occlusion,out_of_view}.txt' (comma ints),
    '<class>/<seq>/img/%08d.jpg'; frame refs are (db_path, key) pairs."""
    from ..utils.lmdb_utils import decode_str

    base = env_settings().lasot_lmdb_path
    # dataset-root override wins over the bundled published table (same
    # precedence as the train adapters)
    split = os.path.join(base, "lasot_test_split.txt")
    if not os.path.exists(split):
        split = os.path.join(env_settings().repo_dir, "data_specs",
                             "lasot_test_split.txt")
    if not os.path.exists(split):
        raise FileNotFoundError(
            "lasot_lmdb needs the published lasot_test_split.txt in "
            "data_specs/ or the dataset root (see data_specs/README.md)")
    with open(split) as f:
        names = [l.strip() for l in f if l.strip()]
    seqs = []
    for name in names:
        cls = name.rsplit("-", 1)[0]
        rows = decode_str(base, f"{cls}/{name}/groundtruth.txt").split("\n")[:-1]
        anno = np.asarray([list(map(float, r.split(","))) for r in rows],
                          np.float64)
        occ = np.asarray(list(map(int, decode_str(
            base, f"{cls}/{name}/full_occlusion.txt").split(","))))
        oov = np.asarray(list(map(int, decode_str(
            base, f"{cls}/{name}/out_of_view.txt").split(","))))
        visible = np.logical_and(occ == 0, oov == 0)
        frames = [(base, f"{cls}/{name}/img/{i:08d}.jpg")
                  for i in range(1, anno.shape[0] + 1)]
        seqs.append(Sequence(name, frames, "lasot_lmdb", anno,
                             target_visible=visible))
    return SequenceList(seqs)


def get_dataset(*names: str) -> SequenceList:
    out = SequenceList()
    for n in names:
        if n not in DATASET_BUILDERS:
            raise KeyError(f"unknown dataset {n!r}; available: {sorted(DATASET_BUILDERS)}")
        out.extend(DATASET_BUILDERS[n]())
    return out
