"""Hybrid logical clock: the order of CRDT operations.

A copy of ``spacedrive_tpu/sync/hlc.py``: a 64-bit NTP64 timestamp whose
high 32 bits are unix seconds and low 32 bits the fraction, made strictly
monotonic per library by bumping past the last value seen (local or
remote). It fits SQLite's INTEGER (i64) until the year 2106.
"""

from __future__ import annotations

import threading
import time


def ntp64(unix_seconds: float) -> int:
    sec = int(unix_seconds)
    frac = int((unix_seconds - sec) * (1 << 32))
    return (sec << 32) | (frac & 0xFFFFFFFF)


def to_unix(ts: int) -> float:
    return (ts >> 32) + (ts & 0xFFFFFFFF) / (1 << 32)


#: Maximum tolerated clock skew when witnessing a remote timestamp. uhlc
#: rejects timestamps beyond a drift bound for the same reason: one peer
#: sending a timestamp near 2^63 would otherwise permanently poison the
#: library clock (it persists via the op-log floor across restarts) and
#: eventually overflow SQLite's i64 as local ops bump past it. Accepting
#: far-future stamps is also an LWW exploit: a "year 2100" update would win
#: every per-field arbitration forever. Tradeoff: an honest peer skewed
#: more than this replicates with a (skew − bound) delay — its ops sort
#: after all sane ops, so they wait at the window tail (never blocking
#: other instances) and apply once wall time catches up.
MAX_DRIFT_SECONDS = 900


class HLC:
    """Monotonic hybrid clock; thread-safe (domain writers + ingest thread)."""

    def __init__(self, last: int = 0) -> None:
        self._last = last
        self._lock = threading.Lock()

    def now(self) -> int:
        with self._lock:
            self._last = max(ntp64(time.time()), self._last + 1)
            return self._last

    def update(self, remote_ts: int) -> bool:
        """Witness a remote timestamp (ingest.rs HLC update on receive).
        Returns False — without witnessing — for anything that is not a
        plausible NTP64 instant within the drift bound."""
        if not isinstance(remote_ts, int) or isinstance(remote_ts, bool) \
                or remote_ts <= 0:
            return False
        if remote_ts > ntp64(time.time() + MAX_DRIFT_SECONDS):
            return False
        with self._lock:
            self._last = max(self._last, remote_ts)
        return True

    @property
    def last(self) -> int:
        with self._lock:
            return self._last
