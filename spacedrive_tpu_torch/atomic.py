"""Crash-safe artifact writes: temporary file, fsync, rename.

Counterpart of ``spacedrive_tpu/utils/atomic.py`` (``atomic_path`` :57,
``atomic_write_bytes`` :79, ``atomic_write_text`` :102), cut to what the
thumbnailer needs. A thumbnail is never visible half written: the payload
goes to a temporary file in the destination's directory (one filesystem,
so the rename is atomic), is fsynced, and is renamed over the destination;
the directory is then fsynced, best effort. A kill leaves the old file or
the new one, and at worst a stale ``*.sd-tmp*`` beside them, which
:func:`cleanup_stale_tmp` sweeps at boot (``cleanup_stale_tmp`` :127).
"""

from __future__ import annotations

import contextlib
import logging
import os
import shutil
import uuid
from pathlib import Path
from typing import Iterator

logger = logging.getLogger(__name__)

#: infix every temporary file carries, as in the reference
TMP_MARK = ".sd-tmp"


def _tmp_for(dest: Path) -> Path:
    dest.parent.mkdir(parents=True, exist_ok=True)
    return dest.parent / f"{dest.name}{TMP_MARK}.{uuid.uuid4().hex[:8]}"


def _fsync_dir(directory: Path) -> None:
    """Make the rename durable; some filesystems refuse a directory fd."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


@contextlib.contextmanager
def atomic_path(dest: str | Path) -> Iterator[Path]:
    """Yield a temporary path beside ``dest`` for a writer that needs a
    path (PIL's ``save``); on a clean exit fsync it and rename it into
    place, on an exception unlink it."""
    dest = Path(dest)
    tmp = _tmp_for(dest)
    try:
        yield tmp
        if tmp.exists():
            fd = os.open(tmp, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        os.replace(tmp, dest)
        _fsync_dir(dest.parent)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise


def atomic_write_bytes(dest: str | Path, data: bytes) -> None:
    dest = Path(dest)
    tmp = _tmp_for(dest)
    try:
        with open(tmp, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, dest)
        _fsync_dir(dest.parent)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise


def atomic_write_text(dest: str | Path, text: str) -> None:
    atomic_write_bytes(dest, text.encode("utf-8"))


def cleanup_stale_tmp(directory: str | Path) -> int:
    """Remove the ``*.sd-tmp*`` debris a kill left mid-write in
    ``directory`` and one level of subdirectories below it (the thumbnail
    cache keeps its files in two-hex shards); returns how many were
    removed."""
    directory = Path(directory)
    try:
        entries = (list(directory.glob(f"*{TMP_MARK}*"))
                   + list(directory.glob(f"*/*{TMP_MARK}*")))
    except OSError:
        return 0
    removed = 0
    for stale in entries:
        try:
            if stale.is_dir():
                shutil.rmtree(stale, ignore_errors=True)
            else:
                stale.unlink(missing_ok=True)
            removed += 1
        except OSError:
            logger.debug("could not remove stale temp %s", stale)
    if removed:
        logger.info("removed %d stale temp file(s) under %s", removed, directory)
    return removed
