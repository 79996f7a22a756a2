"""Retry with backoff, and the transient-versus-fatal taxonomy.

Counterpart of ``spacedrive_tpu/utils/retry.py`` (:70-93, :124-130) and of
``is_disk_full`` and ``note_disk_full`` in ``spacedrive_tpu/recovery.py``
(:67-87), cut to what the port needs: the gather stages (the cas message
read in :mod:`.objects.cas` and the chunk payload read in
:mod:`.objects.manifest`), the pipeline's committer and stage supervision
(:mod:`.pipeline.executor`) and the thumbnailer. It keeps no telemetry, only
the plain :data:`DISK_FULL` counter.

Transient means the same call can succeed if repeated: EINTR, EIO, EAGAIN
and EBUSY reads, SQLite's busy/locked errors, and any exception carrying a
true ``sd_transient`` attribute. A vanished file (ENOENT), a refused one
(EACCES) or a truncated one (EOFError) is not: it raises through on the
first try, and the caller quarantines that item. A full disk (ENOSPC,
EDQUOT, SQLite's "database or disk is full") is neither transient nor
fatal: retrying cannot free space, so the pipeline's committer pauses at its
last committed group instead.

Two classes of the reference are left out. The relay-flap class
(``ConnectionError`` / ``TimeoutError`` of a flapping device relay or peer
link) has nothing to classify: the port has no relay and no p2p. And
``is_device_wedge`` is not ported on purpose: it turns a device failure into
a pause, and the port lets a CUDA error fail the job instead.
"""

from __future__ import annotations

import dataclasses
import errno
import random
import sqlite3
import time
from collections import Counter
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """``attempts`` counts calls (1 = no retry); ``budget_s`` bounds the
    wall time from the first call to the last retry."""

    attempts: int = 3
    base_s: float = 0.05
    max_s: float = 2.0
    multiplier: float = 2.0
    #: +/- fraction of the delay drawn uniformly (0.5 → 50%..150%)
    jitter: float = 0.5
    budget_s: float = 10.0

    def delay(self, retry_index: int) -> float:
        d = min(self.max_s, self.base_s * self.multiplier ** retry_index)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * random.random() - 1.0)
        return max(0.0, d)


#: OSError errnos that mean "the same call can succeed if repeated"
TRANSIENT_ERRNOS = frozenset({errno.EINTR, errno.EIO, errno.EAGAIN, errno.EBUSY})


def is_transient_io(exc: BaseException) -> bool:
    return isinstance(exc, OSError) and exc.errno in TRANSIENT_ERRNOS


def is_sqlite_busy(exc: BaseException) -> bool:
    """SQLITE_BUSY / SQLITE_LOCKED, which surface as OperationalError text."""
    if not isinstance(exc, sqlite3.OperationalError):
        return False
    msg = str(exc).lower()
    return "locked" in msg or "busy" in msg


def is_transient(exc: BaseException) -> bool:
    """The union class :func:`retry_call` retries by default; an exception
    can also classify itself with a true ``sd_transient`` attribute."""
    return (is_sqlite_busy(exc) or is_transient_io(exc)
            or bool(getattr(exc, "sd_transient", False)))


def is_disk_full(exc: BaseException) -> bool:
    """ENOSPC or EDQUOT, or SQLite's own SQLITE_FULL ("database or disk is
    full"), which a full disk raises mid-commit instead of an OSError."""
    if isinstance(exc, OSError) and exc.errno in (
            errno.ENOSPC, getattr(errno, "EDQUOT", errno.ENOSPC)):
        return True
    return (isinstance(exc, sqlite3.OperationalError)
            and "disk is full" in str(exc).lower())


#: full disks absorbed by skipping the work, by site (``thumbnail``)
DISK_FULL: Counter = Counter()


def note_disk_full(site: str) -> None:
    """Count one ENOSPC that ``site`` absorbed (the thumbnailer skips the
    file: a thumbnail can be made again later)."""
    DISK_FULL[site] += 1


def retry_call(fn: Callable[[], Any], *, policy: RetryPolicy,
               classify: Callable[[BaseException], bool] = is_transient) -> Any:
    """Call ``fn`` until it returns, raises an error ``classify`` calls not
    retryable, or the policy's attempts or wall budget run out; then the
    last error raises. The reference's ``cancel_check`` hook is not ported:
    the port has no command channel to poll (ROADMAP Queue 1 item 8)."""
    deadline = time.monotonic() + policy.budget_s
    retries = 0
    while True:
        try:
            return fn()
        except BaseException as exc:  # noqa: BLE001 — classified below
            if not classify(exc):
                raise
            retries += 1
            if retries >= policy.attempts:
                raise
            delay = policy.delay(retries - 1)
            if time.monotonic() + delay > deadline:
                raise
            time.sleep(delay)
