"""Image (pseudo-video) training datasets: COCO instances and RefCOCOg.

Parity with lib/train/dataset/coco_seq.py and refcoco_seq.py/refer.py: each
object instance is a 1-frame "sequence"; COCO contributes tracking samples
with the category name as a weak caption; RefCOCOg contributes grounding and
vision-language samples with real referring expressions. Implemented with a
minimal pure-python COCO/REFER reader (no pycocotools dependency).

The port's own copy of uvltrack_tpu/data/datasets/image_datasets.py (framework-free; the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List

import numpy as np

from .base import BaseVideoDataset


class _MiniCoco:
    """Minimal COCO instances reader: anns, imgs, cats."""

    def __init__(self, anno_path):
        if isinstance(anno_path, dict):  # pre-decoded (LMDB-packed) instances
            data = anno_path
        else:
            with open(anno_path) as f:
                data = json.load(f)
        self.imgs = {im["id"]: im for im in data["images"]}
        self.cats = {c["id"]: c for c in data.get("categories", [])}
        self.anns = {a["id"]: a for a in data["annotations"]}


class CocoSeq(BaseVideoDataset):
    """<root>/{annotations/instances_train2017.json, train2017/*.jpg}"""

    def __init__(self, root: str, version: str = "2017", split: str = "train",
                 image_loader=None):
        from .base import opencv_loader

        super().__init__("coco", root, image_loader or opencv_loader)
        self.img_dir = os.path.join(root, f"{split}{version}")
        self.coco = _MiniCoco(os.path.join(
            root, "annotations", f"instances_{split}{version}.json"))
        self.sequence_list = [a for a in self.coco.anns
                              if not self.coco.anns[a].get("iscrowd", 0)]

    def is_video_sequence(self):
        return False

    def is_grounding_sequence(self):
        return False

    def is_vl_sequence(self):
        return False

    def get_sequence_info(self, seq_id):
        a = self.coco.anns[self.sequence_list[seq_id]]
        bbox = np.asarray(a["bbox"], np.float64)[None]
        valid = (bbox[:, 2] > 0) & (bbox[:, 3] > 0)
        return {"bbox": bbox, "valid": valid, "visible": valid.copy()}

    def get_language(self, seq_id):
        a = self.coco.anns[self.sequence_list[seq_id]]
        cat = self.coco.cats.get(a["category_id"], {})
        return cat.get("name")

    def get_frames(self, seq_id, frame_ids, anno=None):
        a = self.coco.anns[self.sequence_list[seq_id]]
        path = os.path.join(self.img_dir, self.coco.imgs[a["image_id"]]["file_name"])
        img = self.image_loader(path)
        frames = [img.copy() for _ in frame_ids]
        anno = anno or self.get_sequence_info(seq_id)
        frame_annos = {k: [v[0] for _ in frame_ids] for k, v in anno.items()}
        return frames, frame_annos, {"language": self.get_language(seq_id)}


class RefCocoSeq(BaseVideoDataset):
    """RefCOCO-family grounding dataset.

    Layout (standard REFER release under the COCO root):
      <root>/<name>/refs(<splitBy>).p  + <root>/<name>/instances.json
      images under <root>/train2014/.
    """

    def __init__(self, root: str, name: str = "refcocog", splitBy: str = "google",
                 split: str = "train", version: str = "2014", image_loader=None):
        from .base import opencv_loader

        super().__init__(name, root, image_loader or opencv_loader)
        self.img_dir = os.path.join(root, f"train{version}")
        with open(os.path.join(root, name, f"refs({splitBy}).p"), "rb") as f:
            refs = pickle.load(f)
        with open(os.path.join(root, name, "instances.json")) as f:
            inst = json.load(f)
        self.imgs = {im["id"]: im for im in inst["images"]}
        self.anns = {a["id"]: a for a in inst["annotations"]}
        self.refs: List[Dict] = [r for r in refs
                                 if r["split"] == split and r["ann_id"] in self.anns]
        self.sequence_list = list(range(len(self.refs)))

    def is_video_sequence(self):
        return False

    def is_tracking_sequence(self):
        return False

    def is_grounding_sequence(self):
        return True

    def is_vl_sequence(self):
        return True

    def get_sequence_info(self, seq_id):
        ref = self.refs[self.sequence_list[seq_id]]
        bbox = np.asarray(self.anns[ref["ann_id"]]["bbox"], np.float64)[None]
        valid = (bbox[:, 2] > 0) & (bbox[:, 3] > 0)
        return {"bbox": bbox, "valid": valid, "visible": valid.copy()}

    def get_language(self, seq_id):
        ref = self.refs[self.sequence_list[seq_id]]
        return ref["sentences"][-1]["sent"].lower()

    def get_frames(self, seq_id, frame_ids, anno=None):
        ref = self.refs[self.sequence_list[seq_id]]
        img_meta = self.imgs[ref["image_id"]]
        path = os.path.join(self.img_dir, img_meta["file_name"])
        img = self.image_loader(path)
        frames = [img.copy() for _ in frame_ids]
        anno = anno or self.get_sequence_info(seq_id)
        frame_annos = {k: [v[0] for _ in frame_ids] for k, v in anno.items()}
        return frames, frame_annos, {"language": self.get_language(seq_id)}


class Object365(BaseVideoDataset):
    """Objects365 detection boxes as 1-frame tracking sequences
    (lib/train/dataset/object365.py): <root>/{imgs/objects365_v{1,2}_%08d.jpg,
    zhiyuan_objv2_train.json}. Caption is 'the <class> in the view'
    (utils.py::generate_sentence); tracking-capable only, like the
    reference (is_grounding_sequence False)."""

    def __init__(self, root: str, split: str = "train", image_loader=None):
        from .base import opencv_loader

        super().__init__("object365", root, image_loader or opencv_loader)
        self.img_dir = os.path.join(root, "imgs")
        with open(os.path.join(root, "zhiyuan_objv2_train.json")) as f:
            data = json.load(f)
        self.annotations = data["annotations"]
        self.id2class = {c["id"]: c["name"] for c in data.get("categories", [])}

    def is_video_sequence(self):
        return False

    def get_num_sequences(self):
        return len(self.annotations)

    def get_sequence_info(self, seq_id):
        bbox = np.asarray(self.annotations[seq_id]["bbox"], np.float64)[None]
        valid = (bbox[:, 2] > 0) & (bbox[:, 3] > 0)
        return {"bbox": bbox, "valid": valid, "visible": valid.copy()}

    def get_frames(self, seq_id, frame_ids, anno=None):
        desc = self.annotations[seq_id]
        path = os.path.join(self.img_dir,
                            "objects365_v1_%08d.jpg" % desc["image_id"])
        if not os.path.exists(path):
            path = os.path.join(self.img_dir,
                                "objects365_v2_%08d.jpg" % desc["image_id"])
        img = self.image_loader(path)
        frames = [img.copy() for _ in frame_ids]
        anno = anno or self.get_sequence_info(seq_id)
        frame_annos = {k: [v[0] for _ in frame_ids] for k, v in anno.items()}
        name = self.id2class.get(desc["category_id"], "object")
        return frames, frame_annos, {
            "language": f"the {name.lower()} in the view"}


class VisualGenome(BaseVideoDataset):
    """Visual Genome region descriptions as 1-frame grounding sequences
    (lib/train/dataset/visualgenome.py): <root>/{VG_100K/<image_id>.jpg,
    region_descriptions_new.json with flat [{image_id,x,y,width,height,
    phrase}] entries}."""

    def __init__(self, root: str, split: str = "train", image_loader=None):
        from .base import opencv_loader

        super().__init__("visualgenome", root, image_loader or opencv_loader)
        self.img_dir = os.path.join(root, "VG_100K")
        with open(os.path.join(root, "region_descriptions_new.json")) as f:
            self.regions = json.load(f)

    def is_video_sequence(self):
        return False

    def is_grounding_sequence(self):
        return True

    def get_num_sequences(self):
        return len(self.regions)

    def get_sequence_info(self, seq_id):
        d = self.regions[seq_id]
        bbox = np.asarray([d["x"], d["y"], d["width"], d["height"]],
                          np.float64)[None]
        valid = (bbox[:, 2] > 0) & (bbox[:, 3] > 0)
        return {"bbox": bbox, "valid": valid, "visible": valid.copy()}

    def get_frames(self, seq_id, frame_ids, anno=None):
        d = self.regions[seq_id]
        img = self.image_loader(os.path.join(self.img_dir,
                                             "%d.jpg" % d["image_id"]))
        frames = [img.copy() for _ in frame_ids]
        anno = anno or self.get_sequence_info(seq_id)
        frame_annos = {k: [v[0] for _ in frame_ids] for k, v in anno.items()}
        return frames, frame_annos, {"language": d["phrase"].lower()}
