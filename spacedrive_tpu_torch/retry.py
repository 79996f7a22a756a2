"""Retry with backoff for transient read errors.

Counterpart of ``spacedrive_tpu/utils/retry.py``, cut to what the gather
stages need (the cas message read in :mod:`.objects.cas` and the chunk
payload read in :mod:`.objects.manifest`): the :class:`RetryPolicy`, the
transient-errno test and :func:`retry_call` with the same attempts,
jittered exponential backoff and wall budget. It keeps no telemetry and has
no cancel hook.

Transient means the same read can succeed if repeated: EINTR, EIO, EAGAIN
and EBUSY. A vanished file (ENOENT), a refused one (EACCES) or a truncated
one (EOFError) is not retried: it raises through on the first try, and the
caller quarantines that item.
"""

from __future__ import annotations

import dataclasses
import errno
import random
import time
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


def retry_call(fn: Callable[[], Any], *, policy: RetryPolicy) -> Any:
    """Call ``fn`` until it returns, raises an error that is not transient
    (:func:`is_transient_io`), or the policy's attempts or wall budget run
    out; then the last error raises."""
    deadline = time.monotonic() + policy.budget_s
    retries = 0
    while True:
        try:
            return fn()
        except OSError as exc:
            if not is_transient_io(exc):
                raise
            retries += 1
            if retries >= policy.attempts:
                raise
            delay = policy.delay(retries - 1)
            if time.monotonic() + delay > deadline:
                raise
            time.sleep(delay)
