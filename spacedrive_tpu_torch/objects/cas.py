"""Content-addressable-storage id (cas_id) generation.

Counterpart of ``spacedrive_tpu/objects/cas.py`` (the reference's sampling
scheme, core/src/object/cas.rs:23-62)::

    cas_id = hex(BLAKE3(size_le_8 ‖ samples))[:16]

where samples are the whole file when ``size <= 100KiB``, else the 8 KiB
header, four 10 KiB samples at ``8KiB + i*seek_jump`` with
``seek_jump = (size - 16KiB) // 4``, and the 8 KiB footer — a fixed
57,352-byte message. This module is the host-side gather (plain Python reads)
and the scalar oracle path; the batched hash runs in :mod:`..ops.blake3`.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import BinaryIO

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
