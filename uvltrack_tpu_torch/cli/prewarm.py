"""Dataset pre-warmer CLI (parity: tracking/pre_read_datasets.py).

Touches each LMDB dataset's index key so the first real epoch doesn't pay
cold-cache latency, one thread per store (the reference uses one process per
store; the work is mmap page faults, which release the GIL). --full
additionally streams every data.mdb into the OS page cache — on a host
with local SSD this is what actually hides the first-epoch read wall.

dataset_str letters match the reference: g=got10k_lmdb, l=lasot_lmdb,
c=coco_lmdb, v=vid_lmdb, t=trackingnet_lmdb.

The port's own copy of uvltrack_tpu/cli/prewarm.py (framework-free; the port
imports nothing of the JAX package), reading through the port's
utils/lmdb_utils.py:

    python -m uvltrack_tpu_torch.cli.prewarm --data_dir DIR [--dataset_str glcvt] [--full]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

INDEX_KEYS = {
    "got10k_lmdb": "train/list.txt",
    "lasot_lmdb": "LaSOTBenchmark.json",
    "coco_lmdb": "annotations/instances_train2017.json",
    "vid_lmdb": "cache.json",
}


def _touch(lmdb_dir: str, key: str, full: bool) -> int:
    from ..utils.lmdb_utils import decode_str

    n = len(decode_str(lmdb_dir, key) or "")
    if full:
        path = os.path.join(lmdb_dir, "data.mdb")
        if os.path.isfile(path):
            with open(path, "rb", buffering=0) as f:
                while f.read(1 << 24):
                    pass
    return n


def trackingnet_jobs(data_dir: str):
    """One (lmdb_dir, anno key) per TRAIN_i shard, from seq_list.json
    (pre_read_datasets.py:22-31)."""
    root = os.path.join(data_dir, "trackingnet_lmdb")
    with open(os.path.join(root, "seq_list.json")) as f:
        seq_list = json.load(f)
    jobs, prev = [], -1
    for set_idx, seq_name in seq_list:
        if set_idx != prev:
            jobs.append((os.path.join(root, f"TRAIN_{set_idx}_lmdb"),
                         f"anno/{seq_name}.txt"))
            prev = set_idx
    return jobs


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", required=True,
                   help="directory holding the *_lmdb stores")
    p.add_argument("--dataset_str", default="glcvt",
                   help="which stores to warm (subset of 'glcvt')")
    p.add_argument("--full", action="store_true",
                   help="stream whole data.mdb files into the page cache")
    args = p.parse_args(argv)

    jobs = [(os.path.join(args.data_dir, name), key)
            for letter, name, key in
            (("g", "got10k_lmdb", INDEX_KEYS["got10k_lmdb"]),
             ("l", "lasot_lmdb", INDEX_KEYS["lasot_lmdb"]),
             ("c", "coco_lmdb", INDEX_KEYS["coco_lmdb"]),
             ("v", "vid_lmdb", INDEX_KEYS["vid_lmdb"]))
            if letter in args.dataset_str]
    if "t" in args.dataset_str:
        jobs += trackingnet_jobs(args.data_dir)

    t0 = time.time()
    with ThreadPoolExecutor(max_workers=max(1, len(jobs))) as pool:
        sizes = list(pool.map(
            lambda j: _touch(j[0], j[1], args.full), jobs))
    print(f"pre-read {len(jobs)} stores ({sum(sizes)} index bytes) "
          f"in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
