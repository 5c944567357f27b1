"""Benchmark-server submission packagers (a copy of
uvltrack_tpu/eval/packagers.py).

Parity with lib/test/utils/transform_got10k.py / transform_trackingnet.py:
- GOT-10k server wants <seq>/<seq>_001.txt (comma xywh) + <seq>_time.txt,
  zipped per tracker.
- TrackingNet wants flat <seq>.txt with comma-separated xywh, zipped.
"""

from __future__ import annotations

import glob
import os
import shutil
import zipfile

import numpy as np


def _load_boxes(path: str) -> np.ndarray:
    first = open(path).readline()
    delim = "\t" if "\t" in first else ","
    return np.loadtxt(path, delimiter=delim).reshape(-1, 4)


def transform_got10k(results_dir: str, out_dir: str, zip_name: str = "got10k_submit"):
    stage = os.path.join(out_dir, zip_name)
    os.makedirs(stage, exist_ok=True)
    seqs = [f[:-4] for f in os.listdir(results_dir)
            if f.endswith(".txt") and not f.endswith("_time.txt")]
    for seq in sorted(seqs):
        seq_dir = os.path.join(stage, seq)
        os.makedirs(seq_dir, exist_ok=True)
        boxes = _load_boxes(os.path.join(results_dir, f"{seq}.txt"))
        np.savetxt(os.path.join(seq_dir, f"{seq}_001.txt"), boxes,
                   delimiter=",", fmt="%.4f")
        time_src = os.path.join(results_dir, f"{seq}_time.txt")
        if os.path.exists(time_src):
            times = np.loadtxt(time_src).reshape(-1)
            np.savetxt(os.path.join(seq_dir, f"{seq}_time.txt"), times, fmt="%.8f")
    zip_path = os.path.join(out_dir, f"{zip_name}.zip")
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as z:
        for path in glob.glob(os.path.join(stage, "**", "*"), recursive=True):
            z.write(path, os.path.relpath(path, stage))
    shutil.rmtree(stage)
    return zip_path


def transform_trackingnet(results_dir: str, out_dir: str,
                          zip_name: str = "trackingnet_submit"):
    stage = os.path.join(out_dir, zip_name)
    os.makedirs(stage, exist_ok=True)
    seqs = [f[:-4] for f in os.listdir(results_dir)
            if f.endswith(".txt") and not f.endswith("_time.txt")]
    for seq in sorted(seqs):
        boxes = _load_boxes(os.path.join(results_dir, f"{seq}.txt"))
        np.savetxt(os.path.join(stage, f"{seq}.txt"), boxes,
                   delimiter=",", fmt="%.4f")
    zip_path = os.path.join(out_dir, f"{zip_name}.zip")
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as z:
        for path in glob.glob(os.path.join(stage, "*")):
            z.write(path, os.path.relpath(path, stage))
    shutil.rmtree(stage)
    return zip_path
