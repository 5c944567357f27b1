"""Dataset-name -> training dataset instances (parity: names2datasets,
lib/train/base_functions.py:28-71). Paths come from eval.environment
(local_paths.yaml / UVLTRACK_*_PATH env vars).

The port's own copy of uvltrack_tpu/data/builders.py (framework-free; the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import List

from ..eval.environment import env_settings


def names2datasets(names: List[str]) -> List:
    from .datasets.image_datasets import CocoSeq, RefCocoSeq
    from .datasets.video_datasets import (Got10k, ImagenetVID, Lasot, LasotExt,
                                          Otb99, TrackingNet, Tnl2k)

    s = env_settings()
    out = []
    for name in names:
        if name == "LASOT":
            out.append(Lasot(s.lasot_path, split="train"))
        elif name == "LASOT_test":
            out.append(Lasot(s.lasot_path, split="test"))
        elif name == "LASOTEXT":
            out.append(LasotExt(s.lasotext_path))
        elif name == "GOT10K_vottrain":
            out.append(Got10k(s.got10k_path, split="vottrain"))
        elif name == "GOT10K_votval":
            out.append(Got10k(s.got10k_path, split="votval"))
        elif name == "GOT10K_train_full":
            out.append(Got10k(s.got10k_path, split="train"))
        elif name == "TRACKINGNET":
            out.append(TrackingNet(s.trackingnet_path))
        elif name == "TNL2K":
            out.append(Tnl2k(s.tnl2k_path))
        elif name in ("TNL2K_test",):
            out.append(Tnl2k(_tnl2k_test_path(s)))
        elif name == "OTB99":
            out.append(Otb99(s.otb99_path, split="train"))
        elif name == "OTB99_test":
            out.append(Otb99(s.otb99_path, split="test"))
        elif name == "COCO17":
            out.append(CocoSeq(s.coco_path))
        elif name == "REFCOCOG":
            out.append(RefCocoSeq(s.coco_path))
        elif name == "REFCOCOG_val":
            out.append(RefCocoSeq(s.coco_path, split="val"))
        elif name == "VID":
            out.append(ImagenetVID(s.imagenet_path))
        elif name == "Object365":
            from .datasets.image_datasets import Object365

            out.append(Object365(s.object365_path))
        elif name == "VisualGenome":
            from .datasets.image_datasets import VisualGenome

            out.append(VisualGenome(s.visualgenome_path))
        elif name == "WEBUAV":
            from .datasets.video_datasets import WebUAV

            out.append(WebUAV(s.webuav_path))
        elif name.endswith("_lmdb"):
            out.append(_lmdb_dataset(name, s))
        else:
            raise ValueError(f"unknown training dataset {name!r}")
    return out


def _tnl2k_test_path(s) -> str:
    """The reference keeps a distinct env entry (tnl2k_test_dir,
    base_functions.py:38); honor tnl2k_test_path if set, else swap a
    'train' LEAF component for 'test' (never substrings elsewhere in the
    path — '/data/training_sets/tnl2k/train' must not become
    '/data/testing_sets/...')."""
    import os

    if s.tnl2k_test_path:
        return s.tnl2k_test_path
    head, leaf = os.path.split(s.tnl2k_path.rstrip("/"))
    if leaf.lower() == "train":
        return os.path.join(head, leaf.replace("train", "test").replace(
            "Train", "Test"))
    raise ValueError(
        "TNL2K_test needs tnl2k_test_path in local_paths.yaml (or a "
        f"tnl2k_path ending in 'train' to swap); got {s.tnl2k_path!r}")


def _lmdb_dataset(name: str, s):
    """LMDB-packed variants (reference lib/train/dataset/*_lmdb.py); the
    suffix selects the packed adapter against the same env path + '_lmdb'."""
    from .datasets.lmdb_datasets import (CocoSeqLmdb, Got10kLmdb,
                                         ImagenetVidLmdb, LasotLmdb,
                                         TrackingNetLmdb)

    base = name[:-len("_lmdb")]
    if base == "LASOT":
        return LasotLmdb(s.lasot_lmdb_path)
    if base.startswith("GOT10K_"):
        return Got10kLmdb(s.got10k_lmdb_path, split=base[len("GOT10K_"):])
    if base == "TRACKINGNET":
        return TrackingNetLmdb(s.trackingnet_lmdb_path)
    if base == "VID":
        return ImagenetVidLmdb(s.imagenet_lmdb_path)
    if base == "COCO17":
        return CocoSeqLmdb(s.coco_lmdb_path)
    raise ValueError(f"unknown training dataset {name!r}")
