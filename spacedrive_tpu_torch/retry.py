"""Retry with backoff, and the transient-versus-fatal taxonomy.

Counterpart of ``spacedrive_tpu/utils/retry.py`` (:70-93, :124-130) and of
``is_disk_full`` and ``note_disk_full`` in ``spacedrive_tpu/recovery.py``
(:67-87), cut to what the port needs: the gather stages (the cas message
read in :mod:`.objects.cas` and the chunk payload read in
:mod:`.objects.manifest`), the pipeline's committer and stage supervision
(:mod:`.pipeline.executor`) and the thumbnailer. Its accounting is the
reference's families: ``sd_retry_attempts_total``,
``sd_retry_backoff_seconds_total``, ``sd_retry_gave_up_total`` and
``sd_recovery_disk_full_total{site}`` with a ``disk.full`` event; the plain
:data:`DISK_FULL` counter stays beside the last.

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
link) is not in :func:`is_transient`: the port has no relay, and the p2p
sync sessions classify a dropped link themselves (``p2p.nlm``). And
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

from . import telemetry


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


#: backoff quantum of :func:`retry_call`: how long a pause or cancel can
#: wait behind a retry's sleep
POLL_S = 0.05

#: full disks absorbed by skipping the work, by site (``thumbnail``)
DISK_FULL: Counter = Counter()

_ATTEMPTS = telemetry.counter(
    "sd_retry_attempts_total",
    "re-calls made after a transient failure (utils/retry.py)")
_BACKOFF_S = telemetry.counter(
    "sd_retry_backoff_seconds_total",
    "total wall time spent in retry backoff")
_GAVE_UP = telemetry.counter(
    "sd_retry_gave_up_total",
    "retry budgets exhausted (attempts or wall budget)")
_DISK_FULL = telemetry.counter(
    "sd_recovery_disk_full_total",
    "ENOSPC hits absorbed by graceful degradation, per site",
    labels=("site",))


def note_disk_full(site: str) -> None:
    """Count one ENOSPC that ``site`` absorbed (the thumbnailer skips the
    file: a thumbnail can be made again later; a trace export keeps the
    trace in the ring) — counter + flight-recorder event."""
    DISK_FULL[site] += 1
    _DISK_FULL.inc(site=site)
    telemetry.event("disk.full", site=site)


def retry_call(fn: Callable[[], Any], *, policy: RetryPolicy,
               classify: Callable[[BaseException], bool] = is_transient,
               cancel_check: Callable[[], None] | None = None) -> Any:
    """Call ``fn`` until it returns, raises an error ``classify`` calls not
    retryable, or the policy's attempts or wall budget run out; then the
    last error raises. ``cancel_check`` runs between backoff quanta of
    :data:`POLL_S` and before each retry; what it raises (the job's
    ``JobPaused`` or ``JobCanceled``) propagates at once and drops the
    pending transient error."""
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
                _GAVE_UP.inc()
                raise
            delay = policy.delay(retries - 1)
            if time.monotonic() + delay > deadline:
                _GAVE_UP.inc()
                raise
            waited = 0.0
            while waited < delay:
                if cancel_check is not None:
                    cancel_check()
                quantum = min(POLL_S, delay - waited)
                time.sleep(quantum)
                waited += quantum
            if cancel_check is not None:
                cancel_check()
            _ATTEMPTS.inc()
            _BACKOFF_S.inc(waited)
