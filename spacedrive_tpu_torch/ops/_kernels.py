"""Build the port's CUDA sources at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles with nvcc for ``sm_90a`` into its own shared
library under the package's ``_build/`` directory (gitignored), named by a
hash of the source so an edited kernel rebuilds. The libraries export plain C
launchers: pointers and the stream as ``c_void_p``, sizes as ``c_int``, each
returning ``cudaGetLastError()`` after its launch. Nothing falls back: a
missing nvcc, a failed compile or a refused launch raises.

``LAUNCHES`` counts kernel launches by kernel name (one per :func:`launch`);
``LAUNCHES_BY_SHAPE`` counts the same launches by (kernel, caller's tag,
shape), the tag set by :func:`tagged` (the BLAKE3 kernels hash cas messages
and chunk ids at the same shapes); ``PLAIN_ON_CUDA`` counts calls of a
kernel's plain PyTorch version on CUDA tensors; ``LAUNCHES_BY_ORIGIN`` counts
launches by (kernel, origin), the origin set by :func:`origin` around a
caller's whole call (the location watcher's identify passes), whatever tags
the layers below it set. A run that must prove it went
through the kernels resets them with :func:`reset_counts` and reads them
afterwards.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32

#: C launchers per source: function name -> argtypes (all return int)
SIGNATURES: dict[str, dict[str, list]] = {
    # (rows, lengths, base or NULL, total or NULL, cvs, B, C, device, stream)
    "blake3": {"blake3_chunk_cvs": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
               # (cvs, lengths, root or NULL, digests, B, C, device, stream)
               "blake3_merge": [_P, _P, _P, _P, _I, _I, _I, _P]},
    # (plane, lengths, gear, mask, out, B, L, device, stream)
    "cdc": {"gear_candidates": [_P, _P, _P, _U, _P, _I, _I, _I, _P]},
    # (rows, W, n, needle bytes on the host, needle length, out, device, stream)
    "search": {"search_substring": [_P, _I, _I, _P, _I, _P, _I, _P],
               # (rows, keys, W, n, needle, needle length, needle key, out, device, stream)
               "search_exact": [_P, _P, _I, _I, _P, _I, _I, _P, _I, _P],
               # (rows, prefix, W, n, bound, bound length, bound prefix, out, device, stream)
               "search_lex": [_P, _P, _I, _I, _P, _I, ctypes.c_uint64, _P, _I, _P]},
}

#: counted under ``_count_lock`` (:func:`count`): several threads launch at
#: once (a scan's dispatch thread beside a media-lane job, two libraries'
#: scans, a search), and ``counter[key] += 1`` is a read and a write
LAUNCHES: collections.Counter = collections.Counter()
LAUNCHES_BY_SHAPE: collections.Counter = collections.Counter()
PLAIN_ON_CUDA: collections.Counter = collections.Counter()
LAUNCHES_BY_ORIGIN: collections.Counter = collections.Counter()

#: ptxas report (registers, spills, shared memory) of each source's last build
BUILD_LOG: dict[str, str] = {}

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_tag = threading.local()
_origin = threading.local()


class KernelCompileError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def reset_counts() -> None:
    with _count_lock:
        LAUNCHES.clear()
        LAUNCHES_BY_SHAPE.clear()
        PLAIN_ON_CUDA.clear()
        LAUNCHES_BY_ORIGIN.clear()


def count(counter: collections.Counter, key, n: int = 1) -> None:
    """Add ``n`` to ``counter[key]`` under one lock; the port's module
    counters that several threads bump (the launch counters, the resize
    calls, the thumbnailer's decodes and encodes) all go through it."""
    with _count_lock:
        counter[key] += n


@contextlib.contextmanager
def tagged(tag: str):
    """Tag this thread's launches in ``LAUNCHES_BY_SHAPE`` with ``tag``."""
    outer = getattr(_tag, "value", None)
    _tag.value = tag
    try:
        yield
    finally:
        _tag.value = outer


@contextlib.contextmanager
def origin(name: str):
    """Count this thread's launches in ``LAUNCHES_BY_ORIGIN`` under ``name``."""
    outer = getattr(_origin, "value", None)
    _origin.value = name
    try:
        yield
    finally:
        _origin.value = outer


def nvcc() -> str:
    """nvcc from PATH, else from /usr/local/cuda, where the CUDA installer
    puts the toolkit."""
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise KernelCompileError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: list[str] | None = None) -> dict[str, float]:
    """Compile every listed source (default: all) whose library is missing,
    one nvcc process per source, all started together. Returns build
    seconds per source (0.0 for one already built); raises on any failure."""
    names = list(SIGNATURES) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {name: 0.0 for name in names}
    t0 = time.perf_counter()
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, target)
    failures = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failures:
        raise KernelCompileError("CUDA build failed:\n" + "\n".join(failures))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            for fn_name, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def launch(source: str, kernel: str, *args, shape: tuple[int, ...] = ()) -> None:
    """Call one C launcher, count the launch (by kernel, and by tag and
    ``shape``), raise if CUDA refused it."""
    rc = getattr(library(source), kernel)(*args)
    if rc != 0:
        raise KernelLaunchError(f"{kernel} launch failed: cudaError {rc}")
    with _count_lock:
        LAUNCHES[kernel] += 1
        LAUNCHES_BY_SHAPE[(kernel, getattr(_tag, "value", None), shape)] += 1
        LAUNCHES_BY_ORIGIN[(kernel, getattr(_origin, "value", None))] += 1


def stream_of(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
