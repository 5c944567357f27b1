"""nvcc build of the hand-written Hopper kernels under csrc/, bound with ctypes.

Each csrc/<name>.cu is compiled on its own into lib<name>-<hash>.so with a
plain C interface (nvcc -gencode arch=compute_90a,code=sm_90a -shared), at
first use, into the build directory: $UVLTRACK_TORCH_BUILD_DIR, else
build/kernels/ at the root of the checkout (listed in .gitignore). The hash
covers the source, the shared headers (csrc/*.cuh) and the flags, so an
edited kernel is rebuilt and an unchanged one is loaded as it is. `build()`
starts one nvcc per source, all at once, and waits for all of them.

Every wrapper under ops/ launches its kernel through `launch()`, which
calls the library's `uvl_<name>` entry point, raises on the CUDA error code
it returns and counts the launch in LAUNCHES per kernel and instantiation
(a kernel that is not a source of its own, `dense`, the default path's
weight products of ops/ln_qkv_attn_proj.py::dense_f32, names the library it
launches from);
`require()` and `check_cuda()` are the wrappers' argument checks, and
`no_grad_through()` refuses a launch that autograd would need a gradient
through (ops/autograd.py holds the kernels that have a backward).

Nothing here runs at import: the CPU tests import every module of the port,
and this machine class has no nvcc.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

from ..utils import tracing

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("ln_qkv", "qkv_attention", "proj_residual", "attention", "ln_mlp", "split_hilo")
# -lcuda: csrc/gemm_sm90.cuh encodes its TMA descriptors with the driver's
# cuTensorMapEncodeTiled (nvcc links the toolkit's libcuda stub; the driver
# provides the library at run time)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lcuda"]


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
    for part in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
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
        with tracing.span("setup.kernels"):
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
        lib.uvl_error_string.argtypes = [ctypes.c_int]
        lib.uvl_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


# ---------------------------------------------------------------- launching
PTR, INT, I64, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# (kernel, instantiation) -> launches since the last reset
LAUNCHES: Counter = Counter()
# (kernel, instantiation) -> calls recorded into a CUDA graph under stream
# capture: they launch nothing until the graph is replayed, and a replay
# calls no wrapper, so the graph's owner counts its replays
# (track/tracker.py::JitTracker)
CAPTURED: Counter = Counter()
# "kernel[instantiation-body]" -> eager launches of an instantiation that
# has more than one body (ln_qkv's and proj_residual's bf16 and int8
# weights, ln_mlp's bf16 weights: the 64-row body "-64" and the large-M body
# "-lm"; qkv_attention's split body "-64" and batch body "-lm"), which
# LAUNCHES counts under the instantiation itself; reset only by
# reset_body_counts, so a caller can count the bodies over runs that reset
# LAUNCHES
BODIES: Counter = Counter()
# "kernel[reason]" -> calls on CUDA tensors that a kernel's entry handed to
# its plain version (ops/ln_qkv_attn_proj.py::dense_f32: "dense[dtype]",
# "dense[int8w]", "dense[grad]", ...), eager or under capture alike; never
# reset (a caller takes the difference)
FALLBACKS: Counter = Counter()
_FNS: Dict[str, object] = {}  # entry point name -> the bound entry point


def launch_counts() -> dict:
    """{kernel: launches since the last reset, over all its instantiations}
    for every kernel source, and for `dense` once it has launched."""
    out = dict.fromkeys(SOURCES, 0)
    for (kernel, _), n in LAUNCHES.items():
        out[kernel] = out.get(kernel, 0) + n
    return out


def instantiation_counts() -> dict:
    """{"kernel[instantiation]": launches} of every kernel launched."""
    return {f"{k}[{i}]": n for (k, i), n in sorted(LAUNCHES.items()) if n}


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def body_counts() -> dict:
    """{"kernel[instantiation-body]": eager launches} since the last
    reset_body_counts."""
    return {k: n for k, n in sorted(BODIES.items()) if n}


def reset_body_counts() -> None:
    BODIES.clear()


@contextlib.contextmanager
def body_delta(set_aside: bool = False):
    """The eager launches by body that the block makes: yields a dict that
    holds, once the block has ended, {"kernel[instantiation-body]": launches
    in the block} (those that moved). set_aside: the block's launches are
    then taken back out of the body counts, as if it had launched none."""
    before = Counter(BODIES)
    delta: Dict[str, int] = {}
    try:
        yield delta
    finally:
        delta.update({k: n - before[k] for k, n in sorted(BODIES.items()) if n != before[k]})
        if set_aside:
            BODIES.clear()
            BODIES.update(before)


def fallback_counts() -> dict:
    """{"kernel[reason]": calls handed to the plain version} so far."""
    return {k: n for k, n in sorted(FALLBACKS.items()) if n}


def captured_counts() -> dict:
    """{"kernel[instantiation]": calls} recorded into CUDA graphs so far
    (never reset: a caller takes the difference around its capture)."""
    return {f"{k}[{i}]": n for (k, i), n in sorted(CAPTURED.items()) if n}


def dtype_tag(t: torch.Tensor) -> str:
    return {torch.bfloat16: "bf16", torch.float32: "fp32", torch.int8: "int8"}[t.dtype]


def require(cond: bool, msg: str) -> None:
    """A wrapper's argument check: raise ValueError(msg) unless cond."""
    if not cond:
        raise ValueError(msg)


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """All tensors on one CUDA device, contiguous and 16-byte aligned."""
    dev = tensors[0].device
    for t in tensors:
        require(t.is_cuda and t.device == dev,
                f"{name}: all tensors must be on one CUDA device, got {t.device}")
        require(t.is_contiguous(), f"{name}: tensors must be contiguous")
        require(t.data_ptr() % 16 == 0, f"{name}: tensors must be 16-byte aligned")


def grad_needed(*tensors: torch.Tensor) -> bool:
    """Autograd records and one of the tensors needs a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def no_grad_through(name: str, tensors, remedy: str) -> None:
    """Refuse a launch whose output autograd would need a gradient through:
    the kernel writes into a tensor of its own, which has no grad_fn, so the
    gradient would silently stop there. The autograd Functions of
    ops/autograd.py launch with autograd off and pass."""
    if grad_needed(*tensors):
        raise RuntimeError(f"{name}: an input needs a gradient, and the kernel has none of "
                           f"its own; {remedy}")


def launch(kernel: str, inst: str, argtypes, *args, stream_of: torch.Tensor,
           entry: str = "", body: str = "", lib: str = "") -> None:
    """Call `uvl_<kernel>` (or the library's other entry point `entry`) of
    lib<kernel> (or of lib<lib>) with args and, as its last argument,
    PyTorch's current stream on the device of `stream_of`; raise on the CUDA
    error code it returns, and count one launch of kernel[inst] (in CAPTURED
    instead when the stream is capturing a CUDA graph: nothing runs then);
    an eager launch of a named `body` also counts in BODIES as
    kernel[inst-body]."""
    entry = entry or f"uvl_{kernel}"
    fn = _FNS.get(entry)
    if fn is None:
        fn = getattr(library(lib or kernel), entry)
        fn.argtypes = [*argtypes, PTR]
        fn.restype = ctypes.c_int
        _FNS[entry] = fn
    rc = fn(*args, torch.cuda.current_stream(stream_of.device).cuda_stream)
    if rc != 0:
        msg = _LIBS[lib or kernel].uvl_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA error {rc} ({msg})")
    capturing = torch.cuda.is_current_stream_capturing()
    (CAPTURED if capturing else LAUNCHES)[(kernel, inst)] += 1
    if body and not capturing:
        BODIES[f"{kernel}[{inst}-{body}]"] += 1
