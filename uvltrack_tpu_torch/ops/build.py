"""nvcc build of the hand-written Hopper kernels under csrc/, bound with ctypes.

Each csrc/<name>.cu is compiled on its own into lib<name>-<hash>.so with a
plain C interface (nvcc -gencode arch=compute_90a,code=sm_90a -shared), at
first use, into the build directory: $UVLTRACK_TORCH_BUILD_DIR, else
build/kernels/ at the root of the checkout (listed in .gitignore). The hash
covers the source, the shared header and the flags, so an edited kernel is
rebuilt and an unchanged one is loaded as it is. `build()` starts one nvcc
per source, all at once, and waits for all of them.

Nothing here runs at import: the CPU tests import every module of the port,
and this machine class has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("ln_qkv", "qkv_attention")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@dataclass
class BuildRecord:
    name: str
    path: str
    cmd: List[str] = field(default_factory=list)
    seconds: float = 0.0
    cached: bool = True
    ptxas: List[str] = field(default_factory=list)  # -Xptxas -v lines


RECORDS: Dict[str, BuildRecord] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("UVLTRACK_TORCH_BUILD_DIR")
    return Path(env) if env else CSRC.parent.parent / "build" / "kernels"


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA_HOME, PATH, /usr/local/cuda): the "
                       "CUDA kernels of uvltrack_tpu_torch build on a machine "
                       "with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for part in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Sequence[str]] = None) -> Dict[str, BuildRecord]:
    """Compile the named kernel sources (all by default) that are not built
    yet, one nvcc process each, started together. Raises with nvcc's output
    if any fails."""
    names = list(names or SOURCES)
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        path = _lib_path(name)
        if path.exists():
            RECORDS.setdefault(name, BuildRecord(name, str(path)))
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, cmd, path, tmp, time.perf_counter())
    failed = []
    for name, (proc, cmd, path, tmp, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
        RECORDS[name] = BuildRecord(
            name, str(path), cmd, seconds, cached=False,
            ptxas=[ln.strip() for ln in log.splitlines() if "ptxas" in ln])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {n: RECORDS[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        lib.uvl_error_string.argtypes = [ctypes.c_int]
        lib.uvl_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.uvl_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
