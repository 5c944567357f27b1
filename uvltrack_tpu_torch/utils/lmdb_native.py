"""Self-contained LMDB file-format reader/writer (no liblmdb dependency).

The reference's *_lmdb dataset family (lib/utils/lmdb_utils.py:11-42,
lib/train/dataset/*_lmdb.py) reads standard LMDB environments. The lmdb wheel
is not part of this image, so this module implements the on-disk format
(LMDB file format v1, magic 0xBEEFC0DE — stable since 2013) directly:

- `Reader`: mmap + B-tree descent, supporting the main DB, branch/leaf pages
  and overflow (BIGDATA) values — everything a read-only dataset needs.
- `write_lmdb`: bulk writer producing a valid single-transaction environment
  from sorted key/value pairs (used by tools and tests; real LMDB C readers
  accept its output — the layout follows mdb.c's page/node structs exactly).

Not supported (unused by the datasets): DUPSORT, named sub-DBs, writes into
existing environments, and readers concurrent with writers.

Struct layout notes (little-endian, 64-bit, from mdb.c):
  MDB_page header (16 bytes): p_pgno u64 | mp_pad u16 | mp_flags u16 |
    pb_lower u16, pb_upper u16 (union: pb_pages u32 for OVERFLOW)
  MDB_meta (at page offset 16): mm_magic u32, mm_version u32, mm_address u64,
    mm_mapsize u64, mm_dbs[2] (48 bytes each), mm_last_pg u64, mm_txnid u64;
    the page size lives in mm_dbs[0].md_pad.
  MDB_db (48 bytes): md_pad u32, md_flags u16, md_depth u16,
    md_branch_pages u64, md_leaf_pages u64, md_overflow_pages u64,
    md_entries u64, md_root u64
  MDB_node (8-byte header): mn_lo u16, mn_hi u16, mn_flags u16, mn_ksize u16,
    key bytes, data bytes. Leaf data size = lo | hi<<16; branch child pgno =
    lo | hi<<16 | flags<<32. F_BIGDATA leaf data = u64 overflow pgno.

The port's own copy of uvltrack_tpu/utils/lmdb_native.py (framework-free; the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import mmap
import os
import struct
from bisect import bisect_right
from typing import Iterable, List, Optional, Tuple

MDB_MAGIC = 0xBEEFC0DE
MDB_VERSION = 1
P_INVALID = 0xFFFFFFFFFFFFFFFF

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08

F_BIGDATA = 0x01

PAGEHDRSZ = 16
NODESZ = 8

_META = struct.Struct("<IIQQ")            # magic, version, address, mapsize
_DB = struct.Struct("<IHHQQQQQ")          # pad, flags, depth, branch, leaf, ovf, entries, root
_TAIL = struct.Struct("<QQ")              # last_pg, txnid
_PGHDR = struct.Struct("<QHHHH")          # pgno, pad, flags, lower, upper
_OVHDR = struct.Struct("<QHHI")           # pgno, pad, flags, pb_pages
_NODE = struct.Struct("<HHHH")            # lo, hi, flags, ksize


def _data_path(path: str) -> str:
    return os.path.join(path, "data.mdb") if os.path.isdir(path) else path


class Reader:
    """Read-only view of an LMDB environment's main DB."""

    def __init__(self, path: str):
        self.path = _data_path(path)
        self._f = open(self.path, "rb")
        try:
            self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        except Exception:
            self._f.close()
            raise
        try:
            meta = self._pick_meta()
        except Exception:
            # probing callers (is-this-lmdb? scans) must not leak the
            # fd/mapping on every non-LMDB candidate
            self.close()
            raise
        (self.psize, _flags, self.depth, _b, _l, _o, self.entries,
         self.root) = meta

    def _read_meta(self, off: int):
        magic, version, _addr, _mapsize = _META.unpack_from(self._mm, off + PAGEHDRSZ)
        if magic != MDB_MAGIC:
            raise ValueError(f"{self.path}: bad LMDB magic {magic:#x}")
        if version != MDB_VERSION:
            raise ValueError(f"{self.path}: unsupported LMDB version {version}")
        free_db = _DB.unpack_from(self._mm, off + PAGEHDRSZ + _META.size)
        main_db = _DB.unpack_from(self._mm, off + PAGEHDRSZ + _META.size + _DB.size)
        _last_pg, txnid = _TAIL.unpack_from(
            self._mm, off + PAGEHDRSZ + _META.size + 2 * _DB.size)
        psize = free_db[0]  # mm_psize == mm_dbs[0].md_pad
        return txnid, (psize, main_db[1], main_db[2], main_db[3], main_db[4],
                       main_db[5], main_db[6], main_db[7])

    def _pick_meta(self):
        # meta page 0 is at offset 0; meta page 1 starts at psize — read meta0
        # first to learn psize, then compare txnids
        t0, m0 = self._read_meta(0)
        t1, m1 = self._read_meta(m0[0])
        return m1 if t1 > t0 else m0

    # ------------------------------------------------------------- page walk
    def _page(self, pgno: int) -> int:
        return pgno * self.psize

    def _nodes(self, off: int) -> Tuple[int, List[int]]:
        _pgno, _pad, flags, lower, _upper = _PGHDR.unpack_from(self._mm, off)
        n = (lower - PAGEHDRSZ) >> 1
        ptrs = struct.unpack_from(f"<{n}H", self._mm, off + PAGEHDRSZ)
        return flags, list(ptrs)

    def _node_key(self, page_off: int, ptr: int) -> bytes:
        _lo, _hi, _flags, ksize = _NODE.unpack_from(self._mm, page_off + ptr)
        base = page_off + ptr + NODESZ
        return self._mm[base:base + ksize]

    def get(self, key: bytes) -> Optional[bytes]:
        if isinstance(key, str):
            key = key.encode()
        if self.root == P_INVALID:
            return None
        pgno = self.root
        for _ in range(self.depth - 1):  # branch levels
            off = self._page(pgno)
            flags, ptrs = self._nodes(off)
            if not flags & P_BRANCH:  # corrupt/unsupported file: fail loudly
                raise ValueError(f"{self.path}: expected branch page at {pgno}")
            keys = [self._node_key(off, p) for p in ptrs[1:]]
            idx = bisect_right(keys, key)  # node 0's key is implicit -inf
            lo, hi, nflags, _ks = _NODE.unpack_from(self._mm, off + ptrs[idx])
            pgno = lo | (hi << 16) | (nflags << 32)
        off = self._page(pgno)
        flags, ptrs = self._nodes(off)
        if not flags & P_LEAF:  # e.g. DUPSORT/LEAF2 features we don't support
            raise ValueError(f"{self.path}: expected leaf page at {pgno}")
        keys = [self._node_key(off, p) for p in ptrs]
        idx = bisect_right(keys, key) - 1
        if idx < 0 or keys[idx] != key:
            return None
        ptr = ptrs[idx]
        lo, hi, nflags, ksize = _NODE.unpack_from(self._mm, off + ptr)
        dsize = lo | (hi << 16)
        dbase = off + ptr + NODESZ + ksize
        if nflags & F_BIGDATA:
            (ovpgno,) = struct.unpack_from("<Q", self._mm, dbase)
            ovoff = self._page(ovpgno)
            _pg, _pad, ovflags, _pages = _OVHDR.unpack_from(self._mm, ovoff)
            if not ovflags & P_OVERFLOW:
                raise ValueError(
                    f"{self.path}: expected overflow page at {ovpgno}")
            start = ovoff + PAGEHDRSZ
            return self._mm[start:start + dsize]
        return self._mm[dbase:dbase + dsize]

    def keys(self) -> Iterable[bytes]:
        """All keys in order (leaf-level scan)."""
        if self.root == P_INVALID:
            return
        stack = [(self.root, self.depth)]
        while stack:
            pgno, level = stack.pop()
            off = self._page(pgno)
            flags, ptrs = self._nodes(off)
            if flags & P_BRANCH:
                children = []
                for p in ptrs:
                    lo, hi, nflags, _ks = _NODE.unpack_from(self._mm, off + p)
                    children.append(lo | (hi << 16) | (nflags << 32))
                stack.extend((c, level - 1) for c in reversed(children))
            else:
                for p in ptrs:
                    yield self._node_key(off, p)

    def close(self):
        self._mm.close()
        self._f.close()


# --------------------------------------------------------------------- write

def _even(n: int) -> int:
    return (n + 1) & ~1


class _PageBuilder:
    """Accumulates sorted nodes into fixed-size pages (ptrs grow from the
    front, node data packed from the back — mdb.c's layout)."""

    def __init__(self, psize: int, flags: int):
        self.psize = psize
        self.flags = flags
        self.reset()

    def reset(self):
        self.ptrs: List[int] = []
        self.blobs: List[bytes] = []
        self.upper = self.psize
        self.first_key: Optional[bytes] = None

    def fits(self, node: bytes) -> bool:
        lower = PAGEHDRSZ + 2 * (len(self.ptrs) + 1)
        return self.upper - _even(len(node)) >= lower

    def add(self, node: bytes, key: bytes):
        self.upper -= _even(len(node))
        self.ptrs.append(self.upper)
        self.blobs.append(node)
        if self.first_key is None:
            self.first_key = key

    def render(self, pgno: int) -> bytes:
        page = bytearray(self.psize)
        lower = PAGEHDRSZ + 2 * len(self.ptrs)
        _PGHDR.pack_into(page, 0, pgno, 0, self.flags, lower, self.upper)
        struct.pack_into(f"<{len(self.ptrs)}H", page, PAGEHDRSZ, *self.ptrs)
        for ptr, blob in zip(self.ptrs, self.blobs):
            page[ptr:ptr + len(blob)] = blob
        return bytes(page)


def _leaf_node(key: bytes, data: bytes, bigdata_pgno: Optional[int]) -> bytes:
    if bigdata_pgno is not None:
        return (_NODE.pack(len(data) & 0xFFFF, len(data) >> 16, F_BIGDATA,
                           len(key)) + key + struct.pack("<Q", bigdata_pgno))
    return _NODE.pack(len(data) & 0xFFFF, len(data) >> 16, 0, len(key)) + key + data


def _branch_node(key: bytes, child: int) -> bytes:
    return _NODE.pack(child & 0xFFFF, (child >> 16) & 0xFFFF,
                      (child >> 32) & 0xFFFF, len(key)) + key


def write_lmdb(path: str, items: Iterable[Tuple[bytes, bytes]],
               psize: int = 4096, subdir: bool = True) -> str:
    """Write a fresh LMDB environment holding `items` in the main DB.

    items must have unique keys; they are sorted here. Returns the data file
    path. Layout: [meta0, meta1, leaf/overflow pages..., branch pages...].
    """
    items = sorted((k.encode() if isinstance(k, str) else k,
                    v.encode() if isinstance(v, str) else v)
                   for k, v in items)
    for i, (k, _) in enumerate(items):
        if not 0 < len(k) < (psize - PAGEHDRSZ) // 4:
            raise ValueError(f"key size {len(k)} out of range")
        if i and k == items[i - 1][0]:  # sorted -> duplicates are adjacent
            raise ValueError(f"duplicate key {k!r}: a main-DB environment "
                             "holds one value per key")

    nodemax = (psize - PAGEHDRSZ) // 2 - 2  # conservative mdb me_nodemax
    pages: List[bytes] = []  # data pages, pgno = index + 2
    next_pgno = 2
    n_leaf = n_branch = n_ovf = 0

    def flush(builder, level_entries):
        nonlocal next_pgno
        page = builder.render(next_pgno)
        pages.append(page)
        level_entries.append((builder.first_key, next_pgno))
        next_pgno += 1
        builder.reset()

    # ---- leaves (+ overflow runs interleaved before their leaf page)
    leaf_entries: List[Tuple[bytes, int]] = []
    lb = _PageBuilder(psize, P_LEAF)
    for k, v in items:
        big = NODESZ + len(k) + len(v) > nodemax
        # probe with the final node size (BIGDATA nodes carry an 8-byte pgno)
        probe = _leaf_node(k, v, 0) if big else _leaf_node(k, v, None)
        if not lb.fits(probe):
            flush(lb, leaf_entries)
        if big:
            n_ov_pages = -(-(len(v) + PAGEHDRSZ) // psize)
            ovpgno = next_pgno
            ov = bytearray(n_ov_pages * psize)
            _OVHDR.pack_into(ov, 0, ovpgno, 0, P_OVERFLOW, n_ov_pages)
            ov[PAGEHDRSZ:PAGEHDRSZ + len(v)] = v
            for i in range(n_ov_pages):
                pages.append(bytes(ov[i * psize:(i + 1) * psize]))
            next_pgno += n_ov_pages
            n_ovf += n_ov_pages
            node = _leaf_node(k, v, bigdata_pgno=ovpgno)
        else:
            node = probe
        lb.add(node, k)
    if lb.ptrs:
        flush(lb, leaf_entries)
    n_leaf = len(leaf_entries)

    # ---- branches, bottom-up
    depth = 1
    entries = leaf_entries
    root = entries[0][1] if len(entries) == 1 else None
    while len(entries) > 1:
        depth += 1
        up: List[Tuple[bytes, int]] = []
        bb = _PageBuilder(psize, P_BRANCH)
        for i, (first_key, child) in enumerate(entries):
            key = b"" if not bb.ptrs else first_key  # first node: implicit -inf
            node = _branch_node(key, child)
            if not bb.fits(node):
                flush(bb, up)
                node = _branch_node(b"", child)
            bb.add(node, first_key)
        if bb.ptrs:
            flush(bb, up)
        n_branch += len(up)
        entries = up
    if root is None:
        root = entries[0][1] if entries else P_INVALID
    if not items:
        root, depth = P_INVALID, 0

    # ---- metas
    last_pg = next_pgno - 1
    mapsize = max((last_pg + 1) * psize, 1 << 20)

    def meta(txnid: int, m_root: int, m_depth: int) -> bytes:
        page = bytearray(psize)
        _PGHDR.pack_into(page, 0, txnid & 1, 0, P_META, 0, 0)
        _META.pack_into(page, PAGEHDRSZ, MDB_MAGIC, MDB_VERSION, 0, mapsize)
        # free DB: md_pad carries the page size (mm_psize)
        _DB.pack_into(page, PAGEHDRSZ + _META.size,
                      psize, 0, 0, 0, 0, 0, 0, P_INVALID)
        if txnid == 0:
            _DB.pack_into(page, PAGEHDRSZ + _META.size + _DB.size,
                          0, 0, 0, 0, 0, 0, 0, P_INVALID)
            _TAIL.pack_into(page, PAGEHDRSZ + _META.size + 2 * _DB.size, 1, 0)
        else:
            _DB.pack_into(page, PAGEHDRSZ + _META.size + _DB.size,
                          0, 0, m_depth, n_branch, n_leaf, n_ovf,
                          len(items), m_root)
            _TAIL.pack_into(page, PAGEHDRSZ + _META.size + 2 * _DB.size,
                            last_pg, 1)
        return bytes(page)

    if subdir:
        os.makedirs(path, exist_ok=True)
        out = os.path.join(path, "data.mdb")
    else:
        out = path
    with open(out, "wb") as f:
        f.write(meta(0, P_INVALID, 0))
        f.write(meta(1, root, depth))
        for page in pages:
            f.write(page)
    return out
