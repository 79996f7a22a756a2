"""Content-addressable-storage id (cas_id) generation.

Counterpart of ``spacedrive_tpu/objects/cas.py`` (the reference's sampling
scheme, core/src/object/cas.rs:23-62)::

    cas_id = hex(BLAKE3(size_le_8 ‖ samples))[:16]

where samples are the whole file when ``size <= 100KiB``, else the 8 KiB
header, four 10 KiB samples at ``8KiB + i*seek_jump`` with
``seek_jump = (size - 16KiB) // 4``, and the 8 KiB footer — a fixed
57,352-byte message. This module is the host-side gather and the scalar
oracle path; the batched hash runs in :mod:`..ops.blake3`. The gather has two
paths, as in the reference: :func:`read_sampled_batch_fast` through the
native fused gather (:mod:`..native.cas_native`, the interpreter lock
released for the whole batch), which the scan uses, and
:func:`read_sampled_batch`, plain Python reads with a per-file transient
retry, which takes the files the native gather could not read and the
batches an armed ``gather`` fault seam must see file by file.
"""

from __future__ import annotations

import collections
import struct
import threading
from pathlib import Path
from typing import BinaryIO

import numpy as np

from .. import faults
from ..native import cas_native
from ..retry import RetryPolicy, retry_call
from .blake3_ref import blake3

SAMPLE_COUNT = 4
SAMPLE_SIZE = 1024 * 10
HEADER_OR_FOOTER_SIZE = 1024 * 8
MINIMUM_FILE_SIZE = 1024 * 100

#: hashed message length of the sampled (large-file) path
SAMPLED_MESSAGE_LEN = 8 + 2 * HEADER_OR_FOOTER_SIZE + SAMPLE_COUNT * SAMPLE_SIZE  # 57352
#: longest hashed message of the whole-file (small) path
SMALL_MESSAGE_MAX_LEN = 8 + MINIMUM_FILE_SIZE  # 102408


def sample_offsets(size: int) -> list[tuple[int, int]]:
    """(offset, length) reads for a file of ``size`` bytes (> MINIMUM_FILE_SIZE),
    in hash order: header, 4 strided samples, footer."""
    seek_jump = (size - HEADER_OR_FOOTER_SIZE * 2) // SAMPLE_COUNT
    reads = [(0, HEADER_OR_FOOTER_SIZE)]
    reads += [(HEADER_OR_FOOTER_SIZE + i * seek_jump, SAMPLE_SIZE)
              for i in range(SAMPLE_COUNT)]
    reads.append((size - HEADER_OR_FOOTER_SIZE, HEADER_OR_FOOTER_SIZE))
    return reads


def cas_message_from_file(fh: BinaryIO, size: int) -> bytes:
    """The exact byte string the reference feeds its hasher."""
    parts = [struct.pack("<Q", size)]
    if size <= MINIMUM_FILE_SIZE:
        fh.seek(0)
        data = fh.read(size)
        if len(data) != size:
            raise EOFError(f"file shrank while hashing: got {len(data)}, want {size}")
        parts.append(data)
    else:
        for offset, length in sample_offsets(size):
            fh.seek(offset)
            chunk = fh.read(length)
            if len(chunk) != length:  # read_exact semantics (cas.rs:36,43,56)
                raise EOFError(f"short read at {offset}: got {len(chunk)}, want {length}")
            parts.append(chunk)
    return b"".join(parts)


def generate_cas_id(path: str | Path, size: int | None = None) -> str:
    """Scalar oracle path: the pure-Python BLAKE3 of the sampled message."""
    path = Path(path)
    if size is None:
        size = path.stat().st_size
    with open(path, "rb", buffering=0) as fh:
        message = cas_message_from_file(fh, size)
    return blake3(message).hex()[:16]


#: per-file gather retry: EINTR/EIO-class read errors are transient (flaky
#: media, interrupted syscalls), so a file is read up to 3 times before it
#: quarantines; a vanished, refused or truncated file raises at once
GATHER_RETRY = RetryPolicy(attempts=3, base_s=0.01, max_s=0.1, budget_s=1.0)


def _read_one_sampled(path: str | Path, size: int) -> bytes:
    faults.inject("gather", key=str(path))
    with open(path, "rb", buffering=0) as fh:
        return cas_message_from_file(fh, size)


def read_sampled_batch(paths: list[str | Path],
                       sizes: list[int]) -> list[bytes | Exception]:
    """Gather stage: one cas message per file, in order. Transient read
    errors retry under ``GATHER_RETRY``; any other per-file read error (file
    deleted or shrunk mid-scan), or a transient one that outlasts the retry,
    comes back in place as the exception, so the caller quarantines that
    file and keeps the batch."""
    out: list[bytes | Exception] = []
    for path, size in zip(paths, sizes):
        try:
            out.append(retry_call(lambda p=path, s=size: _read_one_sampled(p, s),
                                  policy=GATHER_RETRY))
        except (OSError, EOFError) as e:
            out.append(e)
    return out


#: the native gather's detours through the Python path: ``seam_armed``
#: counts batches an armed ``gather`` seam routed there, ``reread`` counts
#: files the native gather could not read (each re-read with its retry)
PYTHON_ROUTES: collections.Counter = collections.Counter()
_routes_lock = threading.Lock()


def _note_route(route: str) -> None:
    with _routes_lock:
        PYTHON_ROUTES[route] += 1


def message_len(size: int) -> int:
    """The cas message length of a file of ``size`` bytes."""
    return 8 + size if size <= MINIMUM_FILE_SIZE else SAMPLED_MESSAGE_LEN


def read_sampled_batch_fast(paths: list[str | Path],
                            sizes: list[int]) -> list[bytes | Exception]:
    """:func:`read_sampled_batch` through the native fused gather (io_uring,
    or threaded pread where the ring is refused), the interpreter lock
    released for the whole batch. Byte-identical messages and the same
    per-file error routing: a file the native gather could not read is
    re-read on the Python path with its transient retry, which either
    recovers it or returns the real error."""
    if not paths:
        return []
    # an armed gather fault plan needs per-file seam hits; the fused native
    # call is one opaque batch, so the whole batch takes the Python path
    if faults.seam_armed("gather"):
        _note_route("seam_armed")
        return read_sampled_batch(paths, sizes)
    msg_lens = [message_len(s) for s in sizes]
    # the native gather zero-pads each row to a 64-byte block boundary;
    # the stride must cover that, not just the longest message
    stride = (max(msg_lens) + 63) // 64 * 64
    rows = np.zeros((len(paths), stride), np.uint8)
    lengths = np.zeros(len(paths), np.int32)
    cas_native.gather_batch(paths, sizes, rows, lengths)
    out: list[bytes | Exception] = []
    for i, path in enumerate(paths):
        if lengths[i] == 0 and msg_lens[i] != 8:
            # degradation ladder, rung one: the fused gather reports only
            # pass or fail per row
            _note_route("reread")
            out.append(read_sampled_batch([path], [sizes[i]])[0])
        else:
            out.append(bytes(rows[i, : lengths[i]]))
    return out
