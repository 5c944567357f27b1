"""LMDB-backed dataset IO (parity: lib/utils/lmdb_utils.py:11-42; a copy of
uvltrack_tpu/utils/lmdb_utils.py without its pure-Python reader).

Cached per-path LMDB handles with image/str/json decode, through the lmdb C
binding, imported at first use (it raises ImportError where the binding is
not installed), and cv2 for images.
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np

_ENVS: Dict[str, object] = {}


class _CReader:
    """A read-only lmdb environment with a .get(key) surface."""

    def __init__(self, db_path: str):
        import lmdb

        self.env = lmdb.open(db_path, readonly=True, lock=False,
                             readahead=False, meminit=False)

    def get(self, key):
        if isinstance(key, str):
            key = key.encode()
        with self.env.begin(write=False) as txn:
            return txn.get(key)


def get_env(db_path: str):
    if db_path not in _ENVS:
        _ENVS[db_path] = _CReader(db_path)
    return _ENVS[db_path]


def read_bytes(db_path: str, key: str) -> bytes:
    buf = get_env(db_path).get(key)
    if buf is None:
        raise KeyError(f"{key!r} not found in {db_path}")
    return buf


def decode_img(db_path: str, key: str) -> np.ndarray:
    import cv2

    buf = read_bytes(db_path, key)
    arr = np.frombuffer(buf, np.uint8)
    img = cv2.imdecode(arr, cv2.IMREAD_COLOR)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def decode_str(db_path: str, key: str) -> str:
    return read_bytes(db_path, key).decode()


def decode_json(db_path: str, key: str):
    return json.loads(decode_str(db_path, key))
