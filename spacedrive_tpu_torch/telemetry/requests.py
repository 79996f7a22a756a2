"""Per-procedure request telemetry for the serving tier.

Every rspc dispatch (``api/router.py resolve()``) runs through
:func:`observed`, which maintains the ``sd_rspc_*`` families — request
counts by ``{proc, kind, outcome}``, a per-procedure latency histogram,
an in-flight gauge, transport payload bytes — and a bounded
**slow-request ring**: a request slower than ``SD_SLOW_REQUEST_MS``
(default 250) keeps its full span tree, so a slow ``search.paths`` shows
its SQL / reader-lock / serialize breakdown instead of just a number.

Each observed request opens a small :class:`~.spans.Trace` that is NOT
put in the job-trace ring (requests are orders of magnitude more
frequent than jobs); the trace only survives if the request crossed the
slow threshold. While the request span is open, ``models/base.query``
sees :func:`spans.current_trace` with ``record_db_spans`` set and nests
one ``db.query`` span per SELECT — the breakdown the ring serves.

Cardinality: ``proc`` is the router's procedure key — a closed set
(~100 keys, fixed at mount). ``outcome`` ∈ {ok, api_error, error, shed}:
``api_error`` is a well-formed 4xx-class rejection (``ApiError``),
``error`` an unexpected 5xx-class crash, and ``shed`` an admission-
control BUSY (``BusyError``, a 429 with retry-after) — kept distinct so
the SLO engine (telemetry/slo.py) can exclude deliberate load shedding
from error ratios. With ``tenant=`` the same observation also lands in
the bounded-cardinality ``sd_rspc_tenant_*`` families (tenant = the
8-hex library-id hash from ``slo.tenant_label``).

Exposure: ``telemetry.requestStats`` (rspc) serves :func:`stats` — the
per-procedure p50/p95/p99 estimates plus the slow ring — and every slow
capture emits an ``rspc.slow`` flight-recorder event, so the live SSE /
``telemetry.watch`` stream narrates slow requests as they happen.

``SD_TELEMETRY=off``: :func:`observed` degrades to a bare call — no
trace, no counters, zero allocation past one global read.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from collections import deque
from typing import Any, Callable

from . import counter, event, gauge, histogram
from .registry import REQUEST_BUCKETS, enabled, estimate_quantiles
from .spans import Trace

#: slow-request ring capacity (entries carry full span trees — bounded)
SLOW_RING = 64

_REQUESTS = counter(
    "sd_rspc_requests_total",
    "rspc procedure dispatches by procedure, kind and outcome",
    labels=("proc", "kind", "outcome"))
_SECONDS = histogram(
    "sd_rspc_request_seconds", "rspc dispatch latency per procedure",
    labels=("proc",), buckets=REQUEST_BUCKETS)
_IN_FLIGHT = gauge(
    "sd_rspc_in_flight", "rspc dispatches currently executing")
_PAYLOAD = counter(
    "sd_rspc_payload_bytes_total",
    "transport payload bytes per procedure and direction (in = request "
    "body, out = serialized response)", labels=("proc", "direction"))
_SLOW = counter(
    "sd_rspc_slow_requests_total",
    "requests slower than SD_SLOW_REQUEST_MS (each keeps its span tree "
    "in the slow-request ring)", labels=("proc",))
_P99 = gauge(
    "sd_rspc_request_p99_seconds",
    "estimated p99 of sd_rspc_request_seconds per procedure (published "
    "by the resource-watcher tick; alert target — histograms are not "
    "rule targets)", labels=("proc",))
_T_REQUESTS = counter("sd_rspc_tenant_requests_total",
                      labels=("tenant", "outcome"))
_T_SECONDS = histogram("sd_rspc_tenant_request_seconds",
                       labels=("tenant",), buckets=REQUEST_BUCKETS)

_SLOW_RING: deque[dict[str, Any]] = deque(maxlen=SLOW_RING)
_SLOW_LOCK = threading.Lock()

#: per-proc bucket snapshot at the previous publish_quantiles() tick —
#: the p99 gauge is computed over the WINDOW since then, not process
#: lifetime (a cumulative rank would keep an alert firing for hours
#: after a transient slow episode; window quantiles resolve with it)
_P99_PREV: dict[str, list[int]] = {}
_P99_LOCK = threading.Lock()


def slow_threshold_s() -> float:
    """``SD_SLOW_REQUEST_MS`` in seconds (default 250 ms); re-read per
    request so tests and operators can retune a live process."""
    try:
        return max(0.0, float(os.environ.get("SD_SLOW_REQUEST_MS",
                                             "250"))) / 1000.0
    except ValueError:
        return 0.25


def observed(proc: str, kind: str, fn: Callable[[], Any],
             tenant: str | None = None) -> Any:
    """Run one rspc dispatch under full request telemetry. The router's
    only integration point — transports stay unaware. ``tenant`` (a
    bounded ``slo.tenant_label`` hash) additionally records the dispatch
    in the per-tenant families the SLO engine reads."""
    if not enabled():
        return fn()
    # raw paired series writes, NOT the gated Family.inc: a runtime
    # set_enabled() toggle landing mid-request would otherwise drop one
    # side of the inc/dec pair and skew the gauge forever
    in_flight = _IN_FLIGHT.labels()
    with in_flight._lock:
        in_flight.value += 1.0
    trace = Trace(f"rspc-{uuid.uuid4().hex[:12]}", f"rspc.{proc}")
    #: models/base.query only records db spans for traces that opt in —
    #: job traces must keep their per-batch recording discipline
    trace.record_db_spans = True
    outcome = "ok"
    t0 = time.perf_counter()
    try:
        with trace.span("rspc.resolve"):
            return fn()
    except BaseException as e:
        # classified by name, not import — telemetry must not import the
        # api layer (the no-cycles rule this package is built on).
        # BusyError (an ApiError subclass) is checked first: an
        # admission-control shed is deliberate load management, and the
        # SLO engine excludes the `shed` outcome from error ratios.
        name = type(e).__name__
        outcome = ("shed" if name == "BusyError"
                   else "api_error" if name == "ApiError" else "error")
        raise
    finally:
        duration_s = time.perf_counter() - t0
        with in_flight._lock:
            in_flight.value -= 1.0
        _REQUESTS.inc(proc=proc, kind=kind, outcome=outcome)
        _SECONDS.observe(duration_s, proc=proc)
        if tenant is not None:
            _T_REQUESTS.inc(tenant=tenant, outcome=outcome)
            _T_SECONDS.observe(duration_s, tenant=tenant)
        if duration_s >= slow_threshold_s():
            _capture_slow(proc, kind, outcome, duration_s, trace)


def _capture_slow(proc: str, kind: str, outcome: str, duration_s: float,
                  trace: Trace) -> None:
    _SLOW.inc(proc=proc)
    trace.finish()
    entry = {
        "proc": proc,
        "kind": kind,
        "outcome": outcome,
        "duration_s": round(duration_s, 6),
        "unix": round(time.time(), 3),
        "tree": trace.tree(),
    }
    with _SLOW_LOCK:
        _SLOW_RING.append(entry)
    # narrate on the flight recorder (telemetry.watch / SSE); the tree
    # stays in the ring — events must stay small
    event("rspc.slow", proc=proc, kind=kind, outcome=outcome,
          duration_ms=round(duration_s * 1000.0, 1))


def record_payload(proc: str, bytes_in: int, bytes_out: int) -> None:
    """Transport-side payload accounting (the shell knows wire sizes; an
    in-process resolve never serializes)."""
    if not enabled():
        return
    if bytes_in:
        _PAYLOAD.inc(bytes_in, proc=proc, direction="in")
    if bytes_out:
        _PAYLOAD.inc(bytes_out, proc=proc, direction="out")


def slow_requests(limit: int = SLOW_RING) -> list[dict[str, Any]]:
    """Newest-first slice of the slow-request ring."""
    with _SLOW_LOCK:
        entries = list(_SLOW_RING)
    return list(reversed(entries))[:limit]


def clear_slow_requests() -> None:
    """Drop the ring and the p99 window baseline (telemetry.reset()
    zeroes the histograms — a stale baseline would make the first
    post-reset window read negative)."""
    with _SLOW_LOCK:
        _SLOW_RING.clear()
    with _P99_LOCK:
        _P99_PREV.clear()


def publish_quantiles() -> None:
    """Refresh ``sd_rspc_request_p99_seconds`` per live procedure series
    — called by the resource-watcher tick so the alert evaluator (which
    cannot target histograms) has a gauge. Computed over the WINDOW
    since the previous tick (bucket-count deltas): a cumulative-rank p99
    would pin an alert firing long after a transient slow episode
    drained; an idle window publishes 0 (no data), which resolves it."""
    if not enabled():
        return
    with _P99_LOCK:
        for labels, series in _SECONDS.series_items():
            counts, _total, n = series.read()
            if not n:
                continue
            proc = labels["proc"]
            prev = _P99_PREV.get(proc, [0] * len(counts))
            window = [c - p for c, p in zip(counts, prev)]
            _P99_PREV[proc] = counts
            if sum(window) <= 0:
                _P99.set(0.0, proc=proc)
                continue
            q = estimate_quantiles(_SECONDS.buckets, window, qs=(0.99,))
            _P99.set(round(q[0.99], 6), proc=proc)


def stats(slow_limit: int = 16) -> dict[str, Any]:
    """What ``telemetry.requestStats`` serves: per-procedure latency
    quantile estimates, outcome counts, in-flight, payload totals, and
    the slow-request ring (span trees included)."""
    procedures: dict[str, dict[str, Any]] = {}
    for labels, series in _SECONDS.series_items():
        counts, total, n = series.read()
        q = estimate_quantiles(_SECONDS.buckets, counts)
        procedures[labels["proc"]] = {
            "count": n,
            "total_s": round(total, 6),
            "mean_s": round(total / n, 6) if n else 0.0,
            "p50_s": round(q[0.5], 6),
            "p95_s": round(q[0.95], 6),
            "p99_s": round(q[0.99], 6),
        }
    for labels, value in _REQUESTS.series_items():
        stats_row = procedures.get(labels["proc"])
        if stats_row is None:
            continue
        if labels["outcome"] != "ok":
            stats_row["errors"] = int(stats_row.get("errors", 0)
                                      + value.value)
    for labels, value in _PAYLOAD.series_items():
        stats_row = procedures.get(labels["proc"])
        if stats_row is not None:
            stats_row[f"bytes_{labels['direction']}"] = int(value.value)
    return {
        "enabled": enabled(),
        "in_flight": _IN_FLIGHT.labels().value,
        "slow_threshold_ms": round(slow_threshold_s() * 1000.0, 1),
        "procedures": procedures,
        "slow": slow_requests(slow_limit),
    }
