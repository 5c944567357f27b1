"""A pure-Python reader of flax's msgpack checkpoints (the JAX trainer's
ep%04d.msgpack, uvltrack_tpu/train/checkpoint.py), for machines without the
`msgpack` package (the card's machine has none).

It decodes what `flax.serialization.msgpack_serialize` writes:

- the msgpack types: nil, bool, ints, floats, str, bin, arrays (lists) and
  maps (dicts);
- flax's ext types (flax/serialization.py `_MsgpackExtType`): ndarray = 1 and
  npscalar = 3, each a nested msgpack (shape, dtype name, C-order bytes), and
  native_complex = 2, a nested (real, imag);
- the `__msgpack_chunked_array__` dicts that split an array above flax's
  MAX_CHUNK_SIZE into flat chunks, joined back here.

bfloat16, which numpy lacks, comes back through `ml_dtypes` where it is
installed (as flax returns it), else as a numpy uint16 view of the same bits;
`msgpack_restore(..., bf16="float32")` widens it to float32 instead, exactly.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


def _bfloat16():
    """ml_dtypes' bfloat16 where it is installed, else None."""
    try:
        import ml_dtypes
    except ImportError:
        return None
    return ml_dtypes.bfloat16


class _Reader:
    def __init__(self, data: bytes, ext_hook=None):
        self.buf = memoryview(data)
        self.pos = 0
        self.ext_hook = ext_hook

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self.take(self.unpack(">" + "BHI"[b - 0xC4])))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.unpack(">" + "BHI"[b - 0xC7])
            return self.ext(self.unpack(">b"), n)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if 0xCC <= b <= 0xD3:  # uint 8-64, int 8-64
            return self.unpack(">" + "BHIQbhiq"[b - 0xCC])
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return str(self.take(self.unpack(">" + "BHI"[b - 0xD9])), "utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">" + "HI"[b - 0xDC]))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">" + "HI"[b - 0xDE]))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, code: int, n: int) -> Any:
        data = bytes(self.take(n))
        if self.ext_hook is None:
            raise ValueError(f"msgpack: ext type {code} without a decoder")
        return self.ext_hook(code, data)


def unpackb(data: bytes, ext_hook=None) -> Any:
    """One msgpack object from `data` (raw=False: str as str, bin as bytes);
    ext types go to ext_hook(code, bytes)."""
    r = _Reader(data, ext_hook)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError("msgpack: trailing data after the object")
    return out


def _ndarray(data: bytes, bf16: str) -> np.ndarray:
    shape, name, buffer = unpackb(data)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buffer, dtype=np.uint16).reshape(shape)
        if bf16 == "float32":
            return (bits.astype(np.uint32) << 16).view(np.float32)
        dt = _bfloat16()
        return bits.view(dt) if dt is not None else bits
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape)


def _unchunk(d: Any) -> Any:
    """Join every chunked-array dict of the tree back into one array."""
    if isinstance(d, dict):
        if CHUNKED in d:
            shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
            chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in d.items()}
    return d


def msgpack_restore(data: bytes, bf16: str = "native") -> Any:
    """The tree `flax.serialization.msgpack_restore` returns for `data`:
    dicts, lists, Python scalars and numpy arrays (read-only views of the
    bytes, as flax's). bf16="native": bfloat16 through ml_dtypes, or a uint16
    view without it; "float32": widened to float32."""
    if bf16 not in ("native", "float32"):
        raise ValueError(f"bf16 must be 'native' or 'float32', got {bf16!r}")

    def hook(code: int, payload: bytes) -> Any:
        if code == EXT_NDARRAY:
            return _ndarray(payload, bf16)
        if code == EXT_NPSCALAR:
            return _ndarray(payload, bf16)[()]
        if code == EXT_COMPLEX:
            re, im = unpackb(payload)
            return complex(re, im)
        raise ValueError(f"msgpack: unknown ext type {code}")

    return _unchunk(unpackb(data, hook))


def read_checkpoint(path: str) -> Tuple[dict, dict, int]:
    """A JAX trainer checkpoint (ep%04d.msgpack): (state, extra, epoch), as
    its CheckpointManager.restore_raw returns them, every bfloat16 leaf
    widened to float32."""
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read(), bf16="float32")
    return payload["state"], payload.get("extra", {}), int(payload["epoch"])
