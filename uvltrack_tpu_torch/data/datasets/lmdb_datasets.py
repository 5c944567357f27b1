"""LMDB-packed training dataset adapters.

Parity with the reference's *_lmdb family (lib/train/dataset/{got10k_lmdb,
lasot_lmdb,imagenetvid_lmdb,coco_seq_lmdb,tracking_net_lmdb}.py): identical
key schemas — each environment packs the original directory layout as keys —
so environments built for the reference load here unchanged. Backed by
utils/lmdb_utils (lmdb C binding when installed, pure-Python reader
otherwise), so no native wheel is required.

The port's own copy of uvltrack_tpu/data/datasets/lmdb_datasets.py (framework-free; the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from ...utils.lmdb_utils import decode_img, decode_json, decode_str
from .base import BaseVideoDataset
from .image_datasets import CocoSeq, _MiniCoco
from .video_datasets import ImagenetVID


def _specs_file(root: str, name: str) -> str:
    """Find a published split file in the dataset root or <repo>/data_specs."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    for cand in (os.path.join(root, name), os.path.join(repo, "data_specs", name)):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(
        f"split file {name} not found in {root} or {repo}/data_specs "
        "(published by pytracking/LTR; see data_specs/README.md)")


class Got10kLmdb(BaseVideoDataset):
    """GOT-10k packed as LMDB (lib/train/dataset/got10k_lmdb.py).

    Keys: 'train/list.txt', 'train/<seq>/groundtruth.txt' (newline rows,
    trailing empty line), 'train/<seq>/{absence,cover}.label',
    'train/<seq>/%08d.jpg' (frames start at 1)."""

    def __init__(self, root: str, split: str = "vottrain", image_loader=None):
        super().__init__("got10k_lmdb", root, image_loader)
        all_seqs = decode_str(root, "train/list.txt").split("\n")
        all_seqs = [s.strip() for s in all_seqs if s.strip()]
        splits = {
            "vottrain": "got10k_vot_train_split.txt",
            "votval": "got10k_vot_val_split.txt",
            "ltrtrain": "got10k_train_split.txt",
            "ltrval": "got10k_val_split.txt",
            "train": None, "train_full": "got10k_train_full_split.txt",
        }
        if split not in splits:
            raise ValueError(f"unknown GOT-10k LMDB split {split!r}; "
                             f"expected one of {sorted(splits)}")
        list_file = splits[split]
        if list_file:
            with open(_specs_file(root, list_file)) as f:
                ids = [int(l) for l in f if l.strip()]
            self.sequence_list = [all_seqs[i] for i in ids]
        else:
            self.sequence_list = all_seqs

    def is_grounding_sequence(self):
        return False

    def is_vl_sequence(self):
        return False

    def get_sequence_info(self, seq_id):
        seq = f"train/{self.sequence_list[seq_id]}"
        rows = decode_str(self.root, f"{seq}/groundtruth.txt").split("\n")[:-1]
        bbox = np.asarray([list(map(float, r.split(","))) for r in rows],
                          np.float64)
        absence = np.asarray(list(map(
            int, decode_str(self.root, f"{seq}/absence.label").split("\n")[:-1])))
        cover = np.asarray(list(map(
            int, decode_str(self.root, f"{seq}/cover.label").split("\n")[:-1])))
        valid = (bbox[:, 2] > 0) & (bbox[:, 3] > 0)
        visible = (absence == 0) & (cover > 0) & valid
        return {"bbox": bbox, "valid": valid, "visible": visible,
                "visible_ratio": cover.astype(np.float64) / 8.0}

    def get_frames(self, seq_id, frame_ids, anno=None):
        seq = f"train/{self.sequence_list[seq_id]}"
        frames = [decode_img(self.root, f"{seq}/{i + 1:08d}.jpg")
                  for i in frame_ids]
        anno = anno or self.get_sequence_info(seq_id)
        frame_annos = {k: [v[i] for i in frame_ids] for k, v in anno.items()
                       if k != "visible_ratio"}
        return frames, frame_annos, {"language": None}


class LasotLmdb(BaseVideoDataset):
    """LaSOT packed as LMDB (lib/train/dataset/lasot_lmdb.py).

    Keys: '<class>/<class>-<vid>/groundtruth.txt' (newline rows),
    '<class>/<class>-<vid>/{full_occlusion,out_of_view}.txt' (comma ints),
    '<class>/<class>-<vid>/img/%08d.jpg'. Tracking-only in the reference
    (the LMDB pack predates the NL annotations)."""

    def __init__(self, root: str, split: str = "train", image_loader=None):
        super().__init__("lasot_lmdb", root, image_loader)
        with open(_specs_file(root, f"lasot_{split}_split.txt")) as f:
            self.sequence_list = [l.strip() for l in f if l.strip()]

    def is_grounding_sequence(self):
        return False

    def is_vl_sequence(self):
        return False

    def _seq_key(self, seq_id):
        name = self.sequence_list[seq_id]
        return f"{name.rsplit('-', 1)[0]}/{name}"

    def get_sequence_info(self, seq_id):
        seq = self._seq_key(seq_id)
        rows = decode_str(self.root, f"{seq}/groundtruth.txt").split("\n")[:-1]
        bbox = np.asarray([list(map(float, r.split(","))) for r in rows],
                          np.float64)
        occ = np.asarray(list(map(
            int, decode_str(self.root, f"{seq}/full_occlusion.txt").split(","))))
        oov = np.asarray(list(map(
            int, decode_str(self.root, f"{seq}/out_of_view.txt").split(","))))
        valid = (bbox[:, 2] > 0) & (bbox[:, 3] > 0)
        visible = (occ == 0) & (oov == 0) & valid
        return {"bbox": bbox, "valid": valid, "visible": visible}

    def get_frames(self, seq_id, frame_ids, anno=None):
        seq = self._seq_key(seq_id)
        frames = [decode_img(self.root, f"{seq}/img/{i + 1:08d}.jpg")
                  for i in frame_ids]
        anno = anno or self.get_sequence_info(seq_id)
        frame_annos = {k: [v[i] for i in frame_ids] for k, v in anno.items()}
        return frames, frame_annos, {"language": None}


class TrackingNetLmdb(BaseVideoDataset):
    """TrackingNet packed as per-set LMDBs (lib/train/dataset/tracking_net_lmdb.py).

    <root>/seq_list.json (filesystem) lists (set_id, video) pairs; each set
    lives in <root>/TRAIN_<i>_lmdb with keys 'anno/<video>.txt' and
    'frames/<video>/<j>.jpg' (frames start at 0)."""

    def __init__(self, root: str, set_ids: Optional[List[int]] = None,
                 image_loader=None):
        super().__init__("trackingnet_lmdb", root, image_loader)
        with open(os.path.join(root, "seq_list.json")) as f:
            seqs = json.load(f)
        set_ids = set_ids if set_ids is not None else list(range(12))
        self.sequence_list = [(int(s), v) for s, v in seqs if int(s) in set_ids]

    def is_grounding_sequence(self):
        return False

    def is_vl_sequence(self):
        return False

    def _db(self, set_id):
        return os.path.join(self.root, f"TRAIN_{set_id}_lmdb")

    def get_sequence_info(self, seq_id):
        s, name = self.sequence_list[seq_id]
        rows = decode_str(self._db(s), f"anno/{name}.txt").split("\n")[:-1]
        bbox = np.asarray([list(map(float, r.split(","))) for r in rows],
                          np.float64)
        valid = (bbox[:, 2] > 0) & (bbox[:, 3] > 0)
        return {"bbox": bbox, "valid": valid, "visible": valid.copy()}

    def get_frames(self, seq_id, frame_ids, anno=None):
        s, name = self.sequence_list[seq_id]
        frames = [decode_img(self._db(s), f"frames/{name}/{i}.jpg")
                  for i in frame_ids]
        anno = anno or self.get_sequence_info(seq_id)
        frame_annos = {k: [v[i] for i in frame_ids] for k, v in anno.items()}
        return frames, frame_annos, {"language": None}


class ImagenetVidLmdb(ImagenetVID):
    """ImageNet-VID packed as LMDB (lib/train/dataset/imagenetvid_lmdb.py).

    Keys: 'cache.json' (the tracklet metadata) and
    'Data/VID/train/ILSVRC2015_VID_train_%04d/ILSVRC2015_train_%08d/%06d.JPEG'."""

    def __init__(self, root: str, min_length: int = 0,
                 max_target_area: float = 1.0):
        BaseVideoDataset.__init__(self, "imagenetvid_lmdb", root, None)
        seqs = decode_json(root, "cache.json")
        self.sequence_list = self._filter(seqs, min_length, max_target_area)

    def get_frames(self, seq_id, frame_ids, anno=None):
        s = self.sequence_list[seq_id]
        keys = ["/".join(["Data", "VID", "train",
                          f"ILSVRC2015_VID_train_{s['set_id']:04d}",
                          f"ILSVRC2015_train_{s['vid_id']:08d}",
                          f"{i + s['start_frame']:06d}.JPEG"])
                for i in frame_ids]
        frames = [decode_img(self.root, k) for k in keys]
        anno = anno or self.get_sequence_info(seq_id)
        frame_annos = {k: [v[i] for i in frame_ids] for k, v in anno.items()}
        return frames, frame_annos, {"language": None}


class CocoSeqLmdb(CocoSeq):
    """COCO instances packed as LMDB (lib/train/dataset/coco_seq_lmdb.py).

    Keys: 'annotations/instances_<split><version>.json' and
    'images/<split><version>/<file_name>'."""

    def __init__(self, root: str, version: str = "2017", split: str = "train"):
        BaseVideoDataset.__init__(self, "coco_lmdb", root, None)
        self.img_prefix = f"images/{split}{version}"
        self.coco = _MiniCoco(
            decode_json(root, f"annotations/instances_{split}{version}.json"))
        self.sequence_list = [a for a in self.coco.anns
                              if not self.coco.anns[a].get("iscrowd", 0)]

    def get_frames(self, seq_id, frame_ids, anno=None):
        a = self.coco.anns[self.sequence_list[seq_id]]
        img = decode_img(
            self.root,
            f"{self.img_prefix}/{self.coco.imgs[a['image_id']]['file_name']}")
        frames = [img.copy() for _ in frame_ids]
        anno = anno or self.get_sequence_info(seq_id)
        frame_annos = {k: [v[0] for _ in frame_ids] for k, v in anno.items()}
        return frames, frame_annos, {"language": self.get_language(seq_id)}
