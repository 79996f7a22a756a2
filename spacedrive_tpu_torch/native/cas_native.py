"""ctypes binding of the port's native cas gather (``cas_gather.cc``).

Counterpart of the gather half of ``spacedrive_tpu/native/cas_native.py``
(``_observe_gather`` :73, ``_default_gather_threads`` :87, ``gather_batch``
:106). The library is built with g++ at the first gather (a failed build
raises) and bound with ``ctypes.CDLL``, so each call releases the
interpreter lock for the whole batch: the gather threads of the scan
pipeline read beside each other and beside the dispatch and commit stages.

``GATHER_BATCHES`` counts the batches by the path that served them:
``ring`` (io_uring), ``threads`` (pread threads: fewer than 8 files, or
``SD_NO_URING``), ``ring_refused`` (pread threads because the ring was
refused, as a container's seccomp policy may do; logged once). Runs that must
prove the gather went native reset it with :func:`reset_counts` and read it
afterwards. The thread autotune's EWMA (:func:`gather_us_per_file`) is also
published as the ``sd_gather_us_per_file`` gauge.
"""

from __future__ import annotations

import collections
import ctypes
import logging
import os
import threading
import time
from pathlib import Path

from .. import telemetry
from . import build_shared

logger = logging.getLogger(__name__)

#: GatherPath codes of ``sd_cas_gather_batch``
PATHS = ("ring", "threads", "ring_refused")

GATHER_BATCHES: collections.Counter = collections.Counter()
_counts_lock = threading.Lock()
_lib_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

# Thread autotune: the gather is syscall-WAIT bound, not compute bound, so
# the right worker count tracks the filesystem's per-file latency, not the
# core count. We keep an EWMA of the *serial-equivalent* cost per file
# (wall µs/file × workers used — invariant to the worker count it was
# measured under) and size the pool so wall/file lands near _TARGET_US.
# The 4×cores heuristic only seeds the cold start.
_EWMA_ALPHA = 0.3
_TARGET_US = 25.0
_EWMA_LOCK = threading.Lock()
_ewma_us: float | None = None

_GATHER_US = telemetry.gauge(
    "sd_gather_us_per_file",
    "EWMA serial-equivalent native gather cost per file (µs); drives the "
    "gather thread autotune")


def library() -> ctypes.CDLL:
    """The gather library, built and bound on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_shared("sdcasgather", ["cas_gather.cc"])))
            lib.sd_cas_gather_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32)]
            lib.sd_cas_gather_batch.restype = ctypes.c_int32
            _lib = lib
        return _lib


def reset_counts() -> None:
    with _counts_lock:
        GATHER_BATCHES.clear()


def gather_us_per_file() -> float | None:
    """The EWMA serial-equivalent gather cost per file (µs), None before
    the first batch."""
    with _EWMA_LOCK:
        return _ewma_us


def _observe_gather(wall_s: float, n: int, threads: int) -> None:
    """Fold one batch's measured cost into the EWMA (µs/file, serialized)."""
    global _ewma_us
    if n <= 0 or wall_s <= 0.0:
        return
    serial_us = wall_s * 1e6 * max(1, threads) / n
    with _EWMA_LOCK:
        if _ewma_us is None:
            _ewma_us = serial_us
        else:
            _ewma_us = _EWMA_ALPHA * serial_us + (1.0 - _EWMA_ALPHA) * _ewma_us
        _GATHER_US.set(_ewma_us)


def _default_gather_threads(n: int) -> int:
    """Gather workers per batch. ``SD_CAS_GATHER_THREADS`` overrides; with a
    measured EWMA the count is sized so per-file wall cost lands near
    ``_TARGET_US``; cold start oversubscribes the cores (4× up to 16)."""
    raw = os.environ.get("SD_CAS_GATHER_THREADS", "").strip()
    if raw:
        try:
            return max(1, min(int(raw), n))
        except ValueError:
            pass
    with _EWMA_LOCK:
        ewma = _ewma_us
    if ewma is not None:
        return min(max(2, round(ewma / _TARGET_US)), 16, n)
    return min(max(2, (os.cpu_count() or 1) * 4), 16, n)


def gather_batch(paths: list[str | Path], sizes: list[int], out, lengths,
                 n_threads: int | None = None) -> str | None:
    """Fill rows of ``out`` (uint8, shape (>=n, row_stride), C-contiguous;
    a numpy array, or the numpy view of a pinned tensor) with cas sample
    messages and ``lengths`` (int32, (>=n,)) with true message byte counts
    (0 = per-file IO error, or a row stride too short). Returns the path
    that served the batch (one of :data:`PATHS`), None for no files."""
    n = len(paths)
    if n == 0:
        return None
    if out.dtype.itemsize != 1 or not out.flags["C_CONTIGUOUS"] or out.shape[0] < n:
        raise ValueError("out must be C-contiguous uint8 rows, one per file at least")
    if lengths.dtype.itemsize != 4 or not lengths.flags["C_CONTIGUOUS"] or lengths.shape[0] < n:
        raise ValueError("lengths must be C-contiguous int32, one per file at least")
    if n_threads is None:
        n_threads = _default_gather_threads(n)
    lib = library()
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(str(p)) for p in paths])
    c_sizes = (ctypes.c_uint64 * n)(*[int(s) for s in sizes])
    t0 = time.perf_counter()
    code = lib.sd_cas_gather_batch(
        ctypes.cast(c_paths, ctypes.POINTER(ctypes.c_char_p)),
        ctypes.cast(c_sizes, ctypes.POINTER(ctypes.c_uint64)),
        n, n_threads, out.ctypes.data_as(ctypes.c_void_p), out.strides[0],
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    _observe_gather(time.perf_counter() - t0, n, n_threads)
    path = PATHS[code]
    with _counts_lock:
        first_refusal = path == "ring_refused" and not GATHER_BATCHES[path]
        GATHER_BATCHES[path] += 1
    if first_refusal:
        logger.warning("io_uring refused or failed: the cas gather runs on pread threads")
    return path
