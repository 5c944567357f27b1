"""LMDB-backed dataset IO (parity: lib/utils/lmdb_utils.py:11-42; a copy of
uvltrack_tpu/utils/lmdb_utils.py).

Cached per-path LMDB handles with image/str/json decode. Backend order, the
JAX package's: the lmdb C binding when installed, otherwise the port's own
pure-Python reader (utils/lmdb_native.py), two complete readers of the same
file format; the *_lmdb dataset adapters work either way.
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np

try:
    import lmdb

    HAS_LMDB = True
except ImportError:
    lmdb = None
    HAS_LMDB = False

_ENVS: Dict[str, object] = {}


class _CReader:
    """Adapter giving the lmdb package the native Reader's .get() surface."""

    def __init__(self, db_path: str):
        self.env = lmdb.open(db_path, readonly=True, lock=False,
                             readahead=False, meminit=False)

    def get(self, key):
        if isinstance(key, str):
            key = key.encode()
        with self.env.begin(write=False) as txn:
            return txn.get(key)


def get_env(db_path: str):
    if db_path not in _ENVS:
        if HAS_LMDB:
            _ENVS[db_path] = _CReader(db_path)
        else:
            from .lmdb_native import Reader

            _ENVS[db_path] = Reader(db_path)
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
