"""Training video-dataset adapters: LaSOT(+ext), GOT-10k, TrackingNet, TNL2K,
OTB99.

Parity with lib/train/dataset/{lasot,got10k,tracking_net,tnl2k,otb99}.py:
standard public disk layouts, visibility from occlusion/out-of-view (LaSOT,
TNL2K) or absence+cover labels (GOT-10k), per-sequence language where the
dataset provides it. Capability flags route datasets to sampler tasks
(lasot.py:83-89, got10k.py:77-83, tnl2k.py:36-42, otb99.py:30-36).

The port's own copy of uvltrack_tpu/data/datasets/video_datasets.py (framework-free; the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional

import numpy as np

from .base import BaseVideoDataset


def _repo_data_specs() -> str:
    """<repo>/data_specs — bundled published split tables (the reference
    ships the same constant files under lib/train/data_specs/)."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))), "data_specs")


def _load_csv(path: str) -> np.ndarray:
    for d in (",", "\t", " "):
        try:
            return np.loadtxt(path, delimiter=d, dtype=np.float64, ndmin=2)
        except Exception:
            continue
    raise IOError(f"cannot parse {path}")


def _read_line(path: str) -> str:
    with open(path) as f:
        return f.readlines()[0].rstrip()


def _read_int_line(path: str) -> np.ndarray:
    with open(path) as f:
        txt = f.read().replace("\n", ",")
    return np.array([int(v) for v in txt.split(",") if v.strip() != ""], np.int64)


class Lasot(BaseVideoDataset):
    """<root>/<class>/<class-N>/{img/%08d.jpg, groundtruth.txt,
    full_occlusion.txt, out_of_view.txt, nlp.txt}"""

    def __init__(self, root: str, split: str = "train", image_loader=None,
                 name: str = "lasot"):
        from .base import opencv_loader

        super().__init__(name, root, image_loader or opencv_loader)
        self.sequence_list = self._list_sequences(split)

    def _list_sequences(self, split) -> List[str]:
        """Sequence names for the protocol-II split (lasot.py:52-60 /
        lasot_test.py:53-59 use the published lasot_{train,test}_split.txt).
        Resolution order: dataset-root override file, then the bundled
        data_specs table. NO silent fall-through to all sequences — a missing
        split file would silently merge train and test (val contamination)."""
        legacy = os.path.join(self.root, f"{split}ing_set.txt")
        if os.path.exists(legacy):
            with open(legacy) as f:
                return [l.strip() for l in f if l.strip()]
        fname = f"lasot_{split}_split.txt"
        for cand in (os.path.join(self.root, fname),
                     os.path.join(_repo_data_specs(), fname)):
            if os.path.exists(cand):
                with open(cand) as f:
                    return [l.strip() for l in f if l.strip()]
        raise FileNotFoundError(
            f"LaSOT split '{split}': no {split}ing_set.txt in {self.root} and "
            f"no {fname} in {self.root} or <repo>/data_specs/. Refusing to "
            f"fall back to ALL sequences (train/test contamination).")

    def is_grounding_sequence(self):
        return True

    def is_vl_sequence(self):
        return True

    def _seq_path(self, seq_id):
        name = self.sequence_list[seq_id]
        cls = name.rsplit("-", 1)[0]
        return os.path.join(self.root, cls, name)

    def get_sequence_info(self, seq_id):
        p = self._seq_path(seq_id)
        bbox = _load_csv(os.path.join(p, "groundtruth.txt"))
        occ = _read_int_line(os.path.join(p, "full_occlusion.txt"))
        oov = _read_int_line(os.path.join(p, "out_of_view.txt"))
        valid = (bbox[:, 2] > 0) & (bbox[:, 3] > 0)
        visible = (occ == 0) & (oov == 0) & valid
        return {"bbox": bbox, "valid": valid, "visible": visible}

    def get_language(self, seq_id):
        p = os.path.join(self._seq_path(seq_id), "nlp.txt")
        return _read_line(p).lower() if os.path.exists(p) else None

    def get_frames(self, seq_id, frame_ids, anno=None):
        p = self._seq_path(seq_id)
        frames = [self.image_loader(os.path.join(p, "img", f"{i+1:08d}.jpg"))
                  for i in frame_ids]
        anno = anno or self.get_sequence_info(seq_id)
        frame_annos = {k: [v[i] for i in frame_ids] for k, v in anno.items()}
        return frames, frame_annos, {"language": self.get_language(seq_id)}


class LasotExt(Lasot):
    def __init__(self, root: str, image_loader=None):
        super().__init__(root, split="train", image_loader=image_loader,
                         name="lasotext")

    def _list_sequences(self, split) -> List[str]:
        # LaSOT-ext has no split table: the reference globs every sequence
        # (lasotext.py:54) — the extension set is train-only by construction
        return sorted(os.path.basename(p.rstrip(os.sep)) for p in
                      glob.glob(os.path.join(self.root, "*", "*-*" + os.sep)))

    def is_grounding_sequence(self):
        return False


class Got10k(BaseVideoDataset):
    """<root>/<split>/GOT-10k_*_{N}/{%08d.jpg, groundtruth.txt, absence.label,
    cover.label, meta_info.ini}. Tracking-only (no language)."""

    def __init__(self, root: str, split: str = "vottrain", image_loader=None):
        from .base import opencv_loader

        super().__init__("got10k", root, image_loader or opencv_loader)
        self.split = split
        base = os.path.join(root, "train")
        split_tables = {
            "vottrain": "got10k_vot_train_split.txt",
            "votval": "got10k_vot_val_split.txt",
            "ltrtrain": "got10k_train_split.txt",
            "ltrval": "got10k_val_split.txt",
            "train": None,  # the full official train list (list.txt)
        }
        if split not in split_tables:
            raise ValueError(f"unknown GOT-10k split '{split}' "
                             f"(known: {sorted(split_tables)})")
        list_file = split_tables[split]
        with open(os.path.join(base, "list.txt")) as f:
            all_seqs = [l.strip() for l in f if l.strip()]
        if list_file is None:
            self.sequence_list = all_seqs
        else:
            split_path = self._find_split_file(root, list_file)
            if split_path is None:
                # got10k.py:51-55 hard-depends on these files; silently using
                # ALL sequences would make vottrain == votval (contamination)
                raise FileNotFoundError(
                    f"GOT-10k split '{split}': {list_file} not found in "
                    f"{root} or <repo>/data_specs/. Refusing to fall back "
                    f"to the full sequence list.")
            with open(split_path) as f:
                ids = [int(l) for l in f if l.strip()]
            self.sequence_list = [all_seqs[i] for i in ids]
        self.base = base

    @staticmethod
    def _find_split_file(root: str, list_file):
        """Split files (integer sequence-id lists, pytracking/LTR lineage) are
        searched in the dataset root and in <repo>/data_specs/ — place the
        published files there (parity: lib/train/data_specs/)."""
        if not list_file:
            return None
        for cand in (os.path.join(root, list_file),
                     os.path.join(_repo_data_specs(), list_file)):
            if os.path.exists(cand):
                return cand
        return None

    def is_grounding_sequence(self):
        return False

    def is_vl_sequence(self):
        return False

    def _seq_path(self, seq_id):
        return os.path.join(self.base, self.sequence_list[seq_id])

    def get_sequence_info(self, seq_id):
        p = self._seq_path(seq_id)
        bbox = _load_csv(os.path.join(p, "groundtruth.txt"))
        valid = (bbox[:, 2] > 0) & (bbox[:, 3] > 0)
        absence = _read_int_line(os.path.join(p, "absence.label"))
        cover = _read_int_line(os.path.join(p, "cover.label"))
        visible = (absence == 0) & (cover > 0) & valid
        return {"bbox": bbox, "valid": valid, "visible": visible,
                "visible_ratio": cover.astype(np.float64) / 8.0}

    def get_frames(self, seq_id, frame_ids, anno=None):
        p = self._seq_path(seq_id)
        frames = [self.image_loader(os.path.join(p, f"{i+1:08d}.jpg"))
                  for i in frame_ids]
        anno = anno or self.get_sequence_info(seq_id)
        frame_annos = {k: [v[i] for i in frame_ids] for k, v in anno.items()
                       if k != "visible_ratio"}
        return frames, frame_annos, {"language": None}


class TrackingNet(BaseVideoDataset):
    """<root>/TRAIN_i/{anno/<seq>.txt, frames/<seq>/<j>.jpg}. Tracking-only."""

    def __init__(self, root: str, set_ids: Optional[List[int]] = None,
                 image_loader=None):
        from .base import opencv_loader

        super().__init__("trackingnet", root, image_loader or opencv_loader)
        set_ids = set_ids if set_ids is not None else list(range(12))
        self.sequence_list = []
        for s in set_ids:
            anno_dir = os.path.join(root, f"TRAIN_{s}", "anno")
            if not os.path.isdir(anno_dir):
                continue
            for f in sorted(os.listdir(anno_dir)):
                if f.endswith(".txt"):
                    self.sequence_list.append((s, os.path.splitext(f)[0]))

    def is_grounding_sequence(self):
        return False

    def get_sequence_info(self, seq_id):
        s, name = self.sequence_list[seq_id]
        bbox = _load_csv(os.path.join(self.root, f"TRAIN_{s}", "anno", f"{name}.txt"))
        valid = (bbox[:, 2] > 0) & (bbox[:, 3] > 0)
        return {"bbox": bbox, "valid": valid, "visible": valid.copy()}

    def get_frames(self, seq_id, frame_ids, anno=None):
        s, name = self.sequence_list[seq_id]
        fdir = os.path.join(self.root, f"TRAIN_{s}", "frames", name)
        frames = [self.image_loader(os.path.join(fdir, f"{i}.jpg")) for i in frame_ids]
        anno = anno or self.get_sequence_info(seq_id)
        frame_annos = {k: [v[i] for i in frame_ids] for k, v in anno.items()}
        return frames, frame_annos, {"language": None}


class Tnl2k(BaseVideoDataset):
    """<root>/<seq>/{imgs/*, groundtruth.txt, language.txt}. All three tasks."""

    def __init__(self, root: str, image_loader=None):
        from .base import opencv_loader

        super().__init__("tnl2k", root, image_loader or opencv_loader)
        self.sequence_list = sorted(
            os.path.basename(p.rstrip(os.sep))
            for p in glob.glob(os.path.join(root, "*" + os.sep))
            if os.path.exists(os.path.join(p, "groundtruth.txt")))
        self._frames_cache = {}

    def is_grounding_sequence(self):
        return True

    def is_vl_sequence(self):
        return True

    def _seq_path(self, seq_id):
        return os.path.join(self.root, self.sequence_list[seq_id])

    def _frame_files(self, seq_id):
        if seq_id not in self._frames_cache:
            self._frames_cache[seq_id] = sorted(
                glob.glob(os.path.join(self._seq_path(seq_id), "imgs", "*")))
        return self._frames_cache[seq_id]

    def get_sequence_info(self, seq_id):
        p = self._seq_path(seq_id)
        bbox = _load_csv(os.path.join(p, "groundtruth.txt"))
        valid = (bbox[:, 2] > 0) & (bbox[:, 3] > 0)
        visible = valid.copy()
        occ_f = os.path.join(p, "full_occlusion.txt")
        oov_f = os.path.join(p, "out_of_view.txt")
        if os.path.exists(occ_f) and os.path.exists(oov_f):
            occ = _read_int_line(occ_f)
            oov = _read_int_line(oov_f)
            n = min(len(occ), len(oov), len(bbox))
            visible[:n] = (occ[:n] == 0) & (oov[:n] == 0) & valid[:n]
        return {"bbox": bbox, "valid": valid, "visible": visible}

    def get_language(self, seq_id):
        return _read_line(os.path.join(self._seq_path(seq_id), "language.txt")).lower()

    def get_frames(self, seq_id, frame_ids, anno=None):
        files = self._frame_files(seq_id)
        frames = [self.image_loader(files[i]) for i in frame_ids]
        anno = anno or self.get_sequence_info(seq_id)
        frame_annos = {k: [v[i] for i in frame_ids] for k, v in anno.items()}
        return frames, frame_annos, {"language": self.get_language(seq_id)}


class Otb99(BaseVideoDataset):
    """<root>/OTB_videos/<seq> + OTB_query_<split>/<seq>.txt. All tasks."""

    def __init__(self, root: str, split: str = "train", image_loader=None):
        from .base import opencv_loader

        super().__init__("otb99", root, image_loader or opencv_loader)
        qdir = os.path.join(root, f"OTB_query_{split}")
        self.split = split
        self.sequence_list = sorted(
            os.path.splitext(os.path.basename(p))[0]
            for p in glob.glob(os.path.join(qdir, "*.txt")))
        self._frames_cache = {}

    def is_grounding_sequence(self):
        return True

    def is_vl_sequence(self):
        return True

    def _seq_path(self, seq_id):
        return os.path.join(self.root, "OTB_videos", self.sequence_list[seq_id])

    def _frame_files(self, seq_id):
        if seq_id not in self._frames_cache:
            self._frames_cache[seq_id] = sorted(
                glob.glob(os.path.join(self._seq_path(seq_id), "img", "*")))
        return self._frames_cache[seq_id]

    def get_sequence_info(self, seq_id):
        bbox = _load_csv(os.path.join(self._seq_path(seq_id), "groundtruth_rect.txt"))
        valid = (bbox[:, 2] > 0) & (bbox[:, 3] > 0)
        return {"bbox": bbox, "valid": valid, "visible": valid.copy()}

    def get_language(self, seq_id):
        q = os.path.join(self.root, f"OTB_query_{self.split}",
                         f"{self.sequence_list[seq_id]}.txt")
        return _read_line(q).lower()

    def get_frames(self, seq_id, frame_ids, anno=None):
        files = self._frame_files(seq_id)
        frames = [self.image_loader(files[i]) for i in frame_ids]
        anno = anno or self.get_sequence_info(seq_id)
        frame_annos = {k: [v[i] for i in frame_ids] for k, v in anno.items()}
        return frames, frame_annos, {"language": self.get_language(seq_id)}


def _vid_process_anno(root: str) -> List[dict]:
    """Build per-tracklet sequences from the ImageNet-VID XML annotations
    (parity: lib/train/dataset/imagenetvid.py:107-160). Each tracklet is a
    dict {set_id, vid_id, class_name, start_frame, anno, target_visible,
    image_size}; a tracklet ends at its first missing frame."""
    import xml.etree.ElementTree as ET

    base = os.path.join(root, "Annotations", "VID", "train")
    all_sequences = []
    for set_name in sorted(os.listdir(base)):
        set_id = int(set_name.split("_")[-1])
        for vid in sorted(os.listdir(os.path.join(base, set_name))):
            vid_id = int(vid.split("_")[-1])
            files = sorted(os.listdir(os.path.join(base, set_name, vid)))
            first = ET.parse(os.path.join(base, set_name, vid, files[0]))
            image_size = [int(first.find("size/width").text),
                          int(first.find("size/height").text)]
            objects = [ET.ElementTree(
                file=os.path.join(base, set_name, vid, f)).findall("object")
                for f in files]
            tracklets = {}
            for f_id, targets in enumerate(objects):
                for t in targets:
                    tid = t.find("trackid").text
                    tracklets.setdefault(tid, f_id)
            for tid, start in tracklets.items():
                anno, visible = [], []
                class_name = None
                for f_id in range(start, len(objects)):
                    found = False
                    for t in objects[f_id]:
                        if t.find("trackid").text == tid:
                            class_name = class_name or t.find("name").text
                            x1 = int(t.find("bndbox/xmin").text)
                            y1 = int(t.find("bndbox/ymin").text)
                            x2 = int(t.find("bndbox/xmax").text)
                            y2 = int(t.find("bndbox/ymax").text)
                            anno.append([x1, y1, x2 - x1, y2 - y1])
                            visible.append(t.find("occluded").text == "0")
                            found = True
                            break
                    if not found:
                        break
                all_sequences.append({
                    "set_id": set_id, "vid_id": vid_id,
                    "class_name": class_name, "start_frame": start,
                    "anno": anno, "target_visible": visible,
                    "image_size": image_size})
    return all_sequences


class ImagenetVID(BaseVideoDataset):
    """ImageNet-VID tracklets (parity: lib/train/dataset/imagenetvid.py).

    <root>/{Annotations,Data}/VID/train/ILSVRC2015_VID_train_%04d/
    ILSVRC2015_train_%08d/{%06d.xml,.JPEG}. Tracklet metadata is cached to
    <root>/cache.json after the first scan. Tracking-only."""

    def __init__(self, root: str, image_loader=None, min_length: int = 0,
                 max_target_area: float = 1.0):
        import json

        from .base import opencv_loader

        super().__init__("imagenetvid", root, image_loader or opencv_loader)
        cache = os.path.join(root, "cache.json")
        if os.path.isfile(cache):
            with open(cache) as f:
                seqs = json.load(f)
        else:
            seqs = _vid_process_anno(root)
            with open(cache, "w") as f:
                json.dump(seqs, f)
        self.sequence_list = self._filter(seqs, min_length, max_target_area)

    @staticmethod
    def _filter(seqs, min_length, max_target_area):
        def ratio(s):
            a = np.asarray(s["anno"], np.float64)
            sz = np.asarray(s["image_size"], np.float64)
            return np.sqrt(a[0, 2] * a[0, 3] / sz.prod())

        return [s for s in seqs
                if len(s["anno"]) >= min_length and ratio(s) < max_target_area]

    def is_grounding_sequence(self):
        return False

    def is_vl_sequence(self):
        return False

    def get_sequence_info(self, seq_id):
        s = self.sequence_list[seq_id]
        bbox = np.asarray(s["anno"], np.float64)
        valid = (bbox[:, 2] > 0) & (bbox[:, 3] > 0)
        visible = np.asarray(s["target_visible"], bool) & valid
        return {"bbox": bbox, "valid": valid, "visible": visible}

    def _frame_path(self, s, frame_id):
        return os.path.join(
            self.root, "Data", "VID", "train",
            f"ILSVRC2015_VID_train_{s['set_id']:04d}",
            f"ILSVRC2015_train_{s['vid_id']:08d}",
            f"{frame_id + s['start_frame']:06d}.JPEG")

    def get_frames(self, seq_id, frame_ids, anno=None):
        s = self.sequence_list[seq_id]
        frames = [self.image_loader(self._frame_path(s, i)) for i in frame_ids]
        anno = anno or self.get_sequence_info(seq_id)
        frame_annos = {k: [v[i] for i in frame_ids] for k, v in anno.items()}
        return frames, frame_annos, {"language": None}


class WebUAV(BaseVideoDataset):
    """WebUAV-3M training split (lib/train/dataset/webuav.py):
    <root>/train/Train/<seq>/{groundtruth_rect.txt, absent.txt, img/*} with
    captions at <root>/language/Language/Train/<seq>/language.txt. Serves
    all three tasks (tracking / grounding / VL), like the reference."""

    def __init__(self, root: str, split: str = "train", image_loader=None):
        from .base import opencv_loader

        super().__init__("webuav", root, image_loader or opencv_loader)
        base = os.path.join(root, "train", "Train")
        self.sequence_list = sorted(
            d for d in os.listdir(base)
            if os.path.isdir(os.path.join(base, d))) if os.path.isdir(base) else []
        self._base = base
        self._frame_lists = {}  # seq_id -> sorted img paths (glob once, not
        # per draw: WebUAV sequences run to thousands of frames and the
        # sampler indexes 2-3 of them per sample)

    def is_grounding_sequence(self):
        return True

    def is_vl_sequence(self):
        return True

    def get_num_sequences(self):
        return len(self.sequence_list)

    def _seq_path(self, seq_id):
        return os.path.join(self._base, self.sequence_list[seq_id])

    def get_sequence_info(self, seq_id):
        path = self._seq_path(seq_id)
        bbox = np.loadtxt(os.path.join(path, "groundtruth_rect.txt"),
                          delimiter=",", dtype=np.float64).reshape(-1, 4)
        valid = (bbox[:, 2] > 0) & (bbox[:, 3] > 0)
        absent_file = os.path.join(path, "absent.txt")
        visible = valid.copy()
        if os.path.exists(absent_file):
            with open(absent_file) as f:
                absent = np.asarray(
                    [int(v) for v in f.read().replace(",", " ").split()], bool)
            visible = valid & ~absent[: len(valid)]
        return {"bbox": bbox, "valid": valid, "visible": visible}

    def _language(self, seq_id):
        path = os.path.join(self.root, "language", "Language", "Train",
                            self.sequence_list[seq_id], "language.txt")
        if os.path.exists(path):
            with open(path) as f:
                return f.readline().rstrip().lower()
        return None

    def get_frames(self, seq_id, frame_ids, anno=None):
        images = self._frame_lists.get(seq_id)
        if images is None:
            images = self._frame_lists[seq_id] = sorted(
                glob.glob(os.path.join(self._seq_path(seq_id), "img", "*")))
        frames = [self.image_loader(images[i]) for i in frame_ids]
        anno = anno or self.get_sequence_info(seq_id)
        frame_annos = {k: [v[i] for i in frame_ids] for k, v in anno.items()}
        return frames, frame_annos, {"language": self._language(seq_id)}
