"""Native (C++) runtime pieces, loaded via ctypes (a copy of
uvltrack_tpu/native/__init__.py).

Currently: libjpeg-backed frame decoding (jpeg_loader.cc; from a file, or
from bytes for the HTTP service), built with g++
at first use into the build directory of ops/build.py (build/kernels/ at
the root of the checkout, listed in .gitignore, or
$UVLTRACK_TORCH_BUILD_DIR), with a cv2 fallback, plus a threaded sequence
prefetcher that keeps decode ahead of the device (replaces the reference's
dataloader-worker / jpeg4py IO path, lib/train/data/image_loader.py:15-100).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Iterator, List, Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jpeg_loader.cc")

_lib = None
_tried = False


def _so_path() -> str:
    from ..ops.build import build_dir

    return str(build_dir() / "_jpeg_loader.so")


def _build(so: str) -> bool:
    """g++ into a file of this process's own, then renamed into place, so
    processes that build at once never load a half-written library."""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", _SRC, "-ljpeg", "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def load_library():
    """Build (if needed) and load the native decoder. Returns None on failure."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = _so_path()
    if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(_SRC):
        if not _build(so):
            return None
    try:
        lib = ctypes.CDLL(so)
        lib.uvl_jpeg_dims.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_int),
                                      ctypes.POINTER(ctypes.c_int)]
        lib.uvl_jpeg_dims.restype = ctypes.c_int
        lib.uvl_jpeg_decode.argtypes = [ctypes.c_char_p,
                                        ctypes.POINTER(ctypes.c_ubyte),
                                        ctypes.c_long,
                                        ctypes.POINTER(ctypes.c_int),
                                        ctypes.POINTER(ctypes.c_int)]
        lib.uvl_jpeg_decode.restype = ctypes.c_int
        lib.uvl_jpeg_dims_mem.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                          ctypes.POINTER(ctypes.c_int),
                                          ctypes.POINTER(ctypes.c_int)]
        lib.uvl_jpeg_dims_mem.restype = ctypes.c_int
        lib.uvl_jpeg_decode_mem.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                            ctypes.POINTER(ctypes.c_ubyte),
                                            ctypes.c_long,
                                            ctypes.POINTER(ctypes.c_int),
                                            ctypes.POINTER(ctypes.c_int)]
        lib.uvl_jpeg_decode_mem.restype = ctypes.c_int
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def decode_jpeg(path: str) -> Optional[np.ndarray]:
    """Decode a JPEG to an RGB uint8 (H, W, 3) array; None if unavailable."""
    lib = load_library()
    if lib is None:
        return None
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.uvl_jpeg_dims(path.encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    buf = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.uvl_jpeg_decode(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        buf.nbytes, ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        return None
    return buf


def decode_jpeg_bytes(data: bytes) -> Optional[np.ndarray]:
    """Decode JPEG bytes to an RGB uint8 (H, W, 3) array; None if the
    native library is unavailable. Raises ValueError on bytes libjpeg
    cannot decode."""
    lib = load_library()
    if lib is None:
        return None
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.uvl_jpeg_dims_mem(data, len(data), ctypes.byref(h), ctypes.byref(w)) != 0:
        raise ValueError("undecodable image bytes")
    buf = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.uvl_jpeg_decode_mem(
        data, len(data), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        buf.nbytes, ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise ValueError("undecodable image bytes")
    return buf


def imread_rgb(path: str) -> np.ndarray:
    """Fast path: native libjpeg; fallback: cv2 (for png/bmp/broken files)."""
    if path.lower().endswith((".jpg", ".jpeg")):
        img = decode_jpeg(path)
        if img is not None:
            return img
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"could not read image {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class SequencePrefetcher:
    """Decode frames in background threads, `depth` frames ahead of the
    consumer — IO overlaps the device step during evaluation."""

    def __init__(self, paths: List[str], depth: int = 8, num_threads: int = 2,
                 loader=imread_rgb):
        self.paths = paths
        self.loader = loader
        self.depth = depth  # max frames decoded ahead of the consumer
        self.threads = []
        self._idx = 0
        self._lock = threading.Lock()
        self._results = {}
        self._cv = threading.Condition()
        self._next_emit = 0
        for _ in range(max(1, num_threads)):
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self.threads.append(t)

    def _worker(self):
        while True:
            with self._lock:
                if self._idx >= len(self.paths):
                    return
                i = self._idx
                self._idx += 1
            # bound memory: wait until the consumer is close
            while True:
                with self._cv:
                    if i - self._next_emit < self.depth:
                        break
                    self._cv.wait(timeout=0.2)
            try:
                img = self.loader(self.paths[i])
            except Exception as e:  # surface on consume
                img = e
            with self._cv:
                self._results[i] = img
                self._cv.notify_all()

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(len(self.paths)):
            with self._cv:
                while i not in self._results:
                    self._cv.wait(timeout=0.5)
                img = self._results.pop(i)
                self._next_emit = i + 1
                self._cv.notify_all()
            if isinstance(img, Exception):
                raise img
            yield img

    def __len__(self):
        return len(self.paths)
