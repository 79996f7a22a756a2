"""Unified telemetry: the metrics registry + structured spans.

One process-wide :class:`~.registry.Registry` and one bounded ring of
per-job :class:`~.spans.Trace` trees, exposed three ways:

- ``GET /metrics`` on the server shell — Prometheus text exposition;
- ``telemetry.snapshot`` / ``telemetry.jobTrace`` rspc queries;
- ``python -m spacedrive_tpu_torch.telemetry`` — pretty-printed snapshot.

The port of ``spacedrive_tpu/telemetry``. Its families carry the JAX
package's names, types, help texts, labels and bucket edges (the
catalogue is docs/architecture/observability.md's tables), so one
scrape reads the same on either package. Instrumented subsystems: job
lifecycle (queue wait, step latency, lane occupancy), every pipeline
stage (busy/blocked/idle), hasher dispatch (batches/files/bytes → live
files-per-sec and MFU against the card's roofline, ops/roofline.py),
retry.py (attempts, backoff, budget exhaustion), the fault seams, sync
ingest and the mesh, search, and the serving tier.

Families the port does not declare, because it has no code that would
record them (the README's port section lists them with their reasons):
``sd_hash_router_*`` and ``sd_search_router_*`` (no hybrid hasher, no
search backend router), ``sd_relay_*`` (no TPU relay), ``sd_net_link_*``,
``sd_p2p_banned_peers``, ``sd_p2p_bans_total`` and
``sd_p2p_throttled_sessions_total`` (no network fault model, no p2p
accept layer). The ``sd_lock_*`` families are declared and stay at zero:
the port has no lock sanitizer.

``SD_TELEMETRY=off`` turns every record call into a no-op (one global
read); spans still *measure* so job-report stage timings never depend
on the switch. This module imports nothing from the rest of the
package — any layer may instrument without cycles.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from collections import deque
from pathlib import Path
from typing import Any

from . import spans as _spans
from .registry import (
    DEFAULT_BUCKETS,
    LOCK_BUCKETS,
    METRIC_NAME_RE,
    REQUEST_BUCKETS,
    Registry,
    enabled,
    reload_enabled,
    set_enabled,
)
from .spans import Span, Trace

__all__ = [
    "DEFAULT_BUCKETS", "LOCK_BUCKETS", "METRIC_NAME_RE", "REQUEST_BUCKETS",
    "Registry",
    "Span", "Trace",
    "add_event_hook", "counter", "enabled", "event", "finish_trace",
    "gauge", "histogram", "job_trace", "recent_events", "registry",
    "reload_enabled", "remove_event_hook", "render_prometheus", "reset",
    "series_values", "set_enabled", "snapshot", "span", "start_trace",
    "value",
]

_REGISTRY = Registry()

#: the flight recorder: recent events (state transitions, fault firings,
#: sync sessions, alert edges) surfaced in snapshot() and
#: streamed live through the event hooks (telemetry.watch / SSE)
_EVENTS: deque[dict[str, Any]] = deque(maxlen=256)
_EVENTS_LOCK = threading.Lock()
_EVENTS_SEQ = 0
#: fan-out hooks (the Node bridges these onto its event bus); must be
#: cheap and never raise into the instrumented hot path
_EVENT_HOOKS: list[Any] = []


def registry() -> Registry:
    return _REGISTRY


# -- metric declaration passthroughs ------------------------------------------

def counter(name: str, help_text: str = "", labels=()):
    return _REGISTRY.counter(name, help_text, labels)


def gauge(name: str, help_text: str = "", labels=()):
    return _REGISTRY.gauge(name, help_text, labels)


def histogram(name: str, help_text: str = "", labels=(),
              buckets: tuple[float, ...] = DEFAULT_BUCKETS):
    return _REGISTRY.histogram(name, help_text, labels, buckets)


def value(name: str, **label_values: str) -> float:
    return _REGISTRY.value(name, **label_values)


def series_values(name: str):
    return _REGISTRY.series_values(name)


def render_prometheus() -> str:
    return _REGISTRY.render_prometheus()


# -- spans / traces ------------------------------------------------------------

def span(trace: Trace | None, name: str, parent: Span | None = None,
         detached: bool = False, **attrs: Any) -> Span:
    """A timed section under ``trace`` — or a bare timer when there is no
    trace (telemetry off, non-job context): callers read
    ``span.duration_s`` either way. ``parent`` pins a cross-thread parent
    (pipeline stage threads nest under the job thread's run span);
    ``detached`` spans join no thread stack, so they may be entered on
    one thread and exited on another (the sharded-prefetch page span)."""
    if trace is None:
        return Span(name, trace=None, attrs=attrs)
    return trace.span(name, parent=parent, detached=detached, **attrs)


def start_trace(name: str, trace_id: str | None = None,
                resume: bool = False, **attrs: Any) -> Trace | None:
    """Open a trace (None when telemetry is off — every consumer treats a
    missing trace as 'just time, don't record'). With ``resume=True`` an
    UNFINISHED ring entry under the same id is continued instead of
    replaced — how a paused-then-resumed job keeps one tree whose span
    sums still reconcile with its accumulated report metadata (a
    cross-process resume necessarily starts fresh)."""
    if not enabled():
        return None
    if resume and trace_id is not None:
        existing = _spans.get_trace(trace_id)
        if existing is not None and not existing.finished:
            return existing
    trace = Trace(trace_id or str(uuid.uuid4()), name, attrs)
    _spans.remember(trace)
    return trace


def finish_trace(trace: Trace | None,
                 export_dir: str | Path | None = None) -> dict[str, Any] | None:
    """Close the root span, export JSONL under ``<export_dir>/logs/traces/``
    and return the summarized form (what JobReport metadata carries)."""
    if trace is None:
        return None
    trace.finish()
    summary = trace.summary()
    if export_dir is not None:
        path = _spans.export_trace(trace, export_dir)
        if path:
            summary["file"] = path
    return summary


def job_trace(job_id: str,
              data_dir: str | Path | None = None) -> dict[str, Any] | None:
    """Nested span tree for a job: the in-memory ring first, then the
    exported JSONL (survives ring eviction and restarts)."""
    trace = _spans.get_trace(job_id)
    if trace is not None:
        return trace.tree()
    if data_dir is not None:
        return _spans.load_trace_tree(job_id, data_dir)
    return None


# -- events --------------------------------------------------------------------

def event(name: str, **attrs: Any) -> None:
    """A named point-in-time occurrence (job transition, fault fired,
    alert edge): counted, kept in the bounded
    flight-recorder ring with a process-monotonic ``seq``, and fanned out
    to the registered hooks for live streaming."""
    global _EVENTS_SEQ
    if not enabled():
        return
    # resolved per call (events are rare); the family is pre-declared
    counter("sd_telemetry_events_total", "named telemetry events",
            labels=("name",)).inc(name=name)
    with _EVENTS_LOCK:
        _EVENTS_SEQ += 1
        record = {"seq": _EVENTS_SEQ, "name": name,
                  "unix": round(time.time(), 3), **attrs}
        _EVENTS.append(record)
        hooks = list(_EVENT_HOOKS)
    for hook in hooks:
        try:
            hook(record)
        except Exception:  # a broken listener must never stall producers
            logging.getLogger(__name__).exception(
                "telemetry event hook failed for %s", name)


def add_event_hook(hook) -> None:
    """Register a live-event listener (``hook(record: dict)``); hooks run
    synchronously on the emitting thread — hand off, never block."""
    with _EVENTS_LOCK:
        if hook not in _EVENT_HOOKS:
            _EVENT_HOOKS.append(hook)


def remove_event_hook(hook) -> None:
    with _EVENTS_LOCK:
        if hook in _EVENT_HOOKS:
            _EVENT_HOOKS.remove(hook)


def recent_events(limit: int = 64,
                  after_seq: int | None = None) -> list[dict[str, Any]]:
    """Ring tail; with ``after_seq`` only events newer than that sequence
    number (how the SSE stream replays what a reconnecting tail missed)."""
    with _EVENTS_LOCK:
        events = list(_EVENTS)
    if after_seq is not None:
        events = [e for e in events if e.get("seq", 0) > after_seq]
    return events[-limit:]


# -- snapshot ------------------------------------------------------------------

def snapshot() -> dict[str, Any]:
    """The full state in one JSON-safe dict — what ``telemetry.snapshot``
    serves."""
    return {
        "enabled": enabled(),
        "metrics": _REGISTRY.snapshot(),
        "events": recent_events(),
        "recent_traces": _spans.recent_traces(),
    }


def reset() -> None:
    """Tests: zero every series, drop traces, events and the slow-request
    ring (the declared vocabulary survives)."""
    _REGISTRY.reset()
    _spans.clear_traces()
    with _EVENTS_LOCK:
        _EVENTS.clear()
    from . import requests as _requests  # local: requests imports this module
    from . import slo as _slo  # local: slo imports this module

    _requests.clear_slow_requests()
    _slo.reset_tenant_labels()
    _declare_core()


# -- the core vocabulary -------------------------------------------------------
# Declared eagerly so a scrape exposes the full metric set from process
# start, not only after the first scan/retry/fault touches each family.
# Instrumentation sites re-declare their families (same name/labels) to
# get module-local handles — the registry memoizes by name, and a
# mismatched re-declaration raises at the site module's import, which is
# the intended fail-fast: vocabulary drift breaks loudly in any test run
# instead of silently forking the series.

def _declare_core() -> None:
    gauge("sd_scan_files_per_sec",
          "files/s of the most recent completed identify pass")
    gauge("sd_hash_mfu",
          "u32-VPU model-op-utilization of the last hash batch "
          "(ops/roofline.py model)")
    gauge("sd_hash_files_per_sec", "files/s of the last hash batch")
    gauge("sd_hash_bytes_per_sec", "payload bytes/s of the last hash batch")
    busy = counter("sd_pipeline_stage_busy_seconds",
                   "time each pipeline stage spent executing its callable",
                   labels=("stage",))
    blocked = counter("sd_pipeline_stage_blocked_seconds",
                      "time each stage spent blocked on a full downstream "
                      "queue (backpressure)", labels=("stage",))
    idle = counter("sd_pipeline_stage_idle_seconds",
                   "time each stage spent waiting on an empty upstream "
                   "queue", labels=("stage",))
    for fam in (busy, blocked, idle):
        for stage in ("page", "hash", "commit"):
            fam.labels(stage=stage)
    counter("sd_retry_attempts_total",
            "re-calls made after a transient failure (utils/retry.py)")
    counter("sd_retry_backoff_seconds_total",
            "total wall time spent in retry backoff")
    counter("sd_retry_gave_up_total",
            "retry budgets exhausted (attempts or wall budget)")
    counter("sd_faults_fired_total", "injected faults fired, per seam:kind",
            labels=("seam", "kind"))
    counter("sd_recovered_batches_total",
            "hash batches re-dispatched on the CPU ladder after a device "
            "failure")
    counter("sd_quarantined_files_total",
            "per-item failures quarantined by the identifier")
    # sync ingest families carry a bounded-cardinality ``peer`` label
    # (hash-truncated node id, "local" for transport-less ingest) so two
    # aggressive peers are distinguishable in one scrape
    counter("sd_sync_ops_ingested_total", "CRDT ops received for ingest",
            labels=("peer",))
    counter("sd_sync_ops_applied_total",
            "ingested CRDT ops with materialized effect", labels=("peer",))
    counter("sd_p2p_hash_requests_total", "outbound remote-hasher batches")
    counter("sd_p2p_hash_bytes_total",
            "cas-message bytes shipped to remote hashers")
    histogram("sd_sync_window_seconds", "latency of one ingest window",
              labels=("peer",))
    # mesh observability: per-peer convergence lag + remote
    # attribution; declared here so the catalogue is scrape-visible from
    # boot (telemetry/mesh.py holds the matching module handles)
    gauge("sd_sync_peer_lag_ops",
          "CRDT ops the peer has logged that this node has not yet "
          "ingested (sender-declared backlog after each sync window)",
          labels=("peer",))
    gauge("sd_sync_peer_lag_seconds",
          "HLC delta between the peer's watermark and the newest op "
          "applied from it", labels=("peer",))
    histogram("sd_sync_apply_delay_seconds",
              "op_created -> op_applied end-to-end latency (op HLC stamp "
              "vs local wall clock at ingest)", labels=("peer",))
    counter("sd_sync_remote_windows_total",
            "sync ingest windows received per peer", labels=("peer",))
    counter("sd_sync_remote_sessions_total",
            "sync-over-wire sessions completed per peer", labels=("peer",))
    counter("sd_p2p_hash_serve_total",
            "inbound remote-hasher batches served per peer",
            labels=("peer",))
    counter("sd_p2p_hash_serve_bytes_total",
            "cas-message bytes hashed on behalf of remote peers",
            labels=("peer",))
    gauge("sd_alerts_firing",
          "1 while the named alert rule is firing (telemetry/alerts.py)",
          labels=("rule",))
    histogram("sd_job_queue_wait_seconds",
              "dispatch-queue wait per job", labels=("lane",))
    histogram("sd_job_step_seconds", "sequential step latency per job",
              labels=("job",))
    gauge("sd_jobs_running", "running workers per lane", labels=("lane",))
    gauge("sd_jobs_queued", "jobs waiting for lane capacity")
    counter("sd_jobs_completed_total", "finished jobs by name and status",
            labels=("job", "status"))
    counter("sd_commit_txns_total",
            "durable transactions opened by the pipeline committer (group "
            "commit coalesces SD_COMMIT_GROUP pages into each)")
    counter("sd_commit_txn_pages_total",
            "pipeline pages made durable through group-commit transactions")
    counter("sd_hash_batches_total", "hash batches dispatched per backend",
            labels=("backend",))
    counter("sd_hash_files_total", "files hashed per backend",
            labels=("backend",))
    counter("sd_hash_bytes_total", "cas-message payload bytes hashed per "
            "backend", labels=("backend",))
    histogram("sd_hash_batch_seconds", "hash batch latency per backend",
              labels=("backend",))
    counter("sd_telemetry_events_total", "named telemetry events",
            labels=("name",))
    # crash-consistent durability: boot integrity + repair ladder
    # + disk-full degradation (recovery.py and retry.py hold the matching
    # module handles)
    boot = counter("sd_boot_integrity_checks_total",
                   "boot-time library DB integrity checks by outcome",
                   labels=("outcome",))
    for outcome in ("ok", "corrupt"):
        boot.labels(outcome=outcome)
    counter("sd_boot_integrity_wal_recovered_total",
            "boots that found (and replayed) a non-empty WAL sidecar")
    histogram("sd_boot_integrity_check_seconds",
              "latency of one boot-time quick_check pass")
    counter("sd_recovery_repairs_total",
            "repair-ladder actions taken on a corrupt library DB",
            labels=("action",))
    counter("sd_recovery_cold_resumed_jobs_total",
            "interrupted jobs revived from their checkpoints at boot")
    counter("sd_recovery_disk_full_total",
            "ENOSPC hits absorbed by graceful degradation, per site",
            labels=("site",))
    # serving-tier observability: per-procedure request
    # telemetry, HTTP-layer families, the span-tagged sampling profiler
    # and the process resource watcher (telemetry/requests.py,
    # telemetry/profiler.py, server/shell.py, models/base.py hold the
    # matching module handles)
    counter("sd_rspc_requests_total",
            "rspc procedure dispatches by procedure, kind and outcome",
            labels=("proc", "kind", "outcome"))
    histogram("sd_rspc_request_seconds",
              "rspc dispatch latency per procedure", labels=("proc",),
              buckets=REQUEST_BUCKETS)
    gauge("sd_rspc_in_flight", "rspc dispatches currently executing")
    counter("sd_rspc_payload_bytes_total",
            "transport payload bytes per procedure and direction (in = "
            "request body, out = serialized response)",
            labels=("proc", "direction"))
    counter("sd_rspc_slow_requests_total",
            "requests slower than SD_SLOW_REQUEST_MS (each keeps its span "
            "tree in the slow-request ring)", labels=("proc",))
    gauge("sd_rspc_request_p99_seconds",
          "estimated p99 of sd_rspc_request_seconds per procedure "
          "(published by the resource-watcher tick; alert target — "
          "histograms are not rule targets)", labels=("proc",))
    # serve-tier SLO engine: bounded-cardinality per-tenant
    # request families (tenant = 8-hex library-id hash, LRU-capped with an
    # `other` overflow — telemetry/slo.py tenant_label), the per-objective
    # SLO gauges the engine publishes, and the rspc dispatch-admission
    # families (sync/admission.py DispatchBudget holds those handles)
    counter("sd_rspc_tenant_requests_total",
            "rspc dispatches per tenant class and outcome (tenant = "
            "bounded library-id hash; shed = admission-control BUSY, "
            "excluded from SLO error ratios)",
            labels=("tenant", "outcome"))
    histogram("sd_rspc_tenant_request_seconds",
              "rspc dispatch latency per tenant class",
              labels=("tenant",), buckets=REQUEST_BUCKETS)
    gauge("sd_slo_budget_remaining",
          "error budget remaining per SLO objective over its budget "
          "window (1 = untouched, 0 = exhausted)", labels=("objective",))
    gauge("sd_slo_burn_rate",
          "error-budget burn rate per SLO objective and trailing window "
          "(1 = burning exactly the sustainable rate)",
          labels=("objective", "window"))
    counter("sd_rspc_shed_total",
            "rspc dispatches answered BUSY by admission control, per "
            "tenant class", labels=("tenant",))
    gauge("sd_rspc_admission_in_flight",
          "rspc dispatches currently admitted by the dispatch budget")
    gauge("sd_rspc_admission_budget",
          "configured max concurrent rspc dispatches (SD_RSPC_BUDGET)")
    counter("sd_http_requests_total",
            "HTTP requests served by the shell, by route class and status",
            labels=("route", "status"))
    histogram("sd_http_request_seconds",
              "HTTP request latency per route class", labels=("route",),
              buckets=REQUEST_BUCKETS)
    counter("sd_http_response_bytes_total",
            "response payload bytes per route class (file/range streams "
            "count the streamed window)", labels=("route",))
    counter("sd_http_ws_messages_total",
            "websocket text messages by direction (in = client frames, "
            "out = responses/subscription events)", labels=("direction",))
    counter("sd_profile_samples_total",
            "wall-clock profiler samples attributed per active span name "
            "('other' = the sampled thread had no open span)",
            labels=("span",))
    gauge("sd_proc_rss_bytes", "resident set size of this process")
    gauge("sd_proc_open_fds", "open file descriptors of this process")
    gauge("sd_proc_threads", "live Python threads in this process")
    histogram("sd_db_reader_wait_seconds",
              "time reads spent waiting for the WAL reader connection "
              "lock (contended acquisitions only — reader/writer "
              "contention under serving load)")
    # multi-process reader pool: per-worker serving telemetry,
    # recorded in the NODE process at the dispatch seam (worker children
    # run with telemetry disabled; their stats ride the reply pipe) —
    # server/pool.py holds the matching module handles
    counter("sd_serve_worker_requests_total",
            "pool-dispatched query requests per worker slot and outcome "
            "(failover = the request was re-run in-process)",
            labels=("worker", "outcome"))
    histogram("sd_serve_worker_request_seconds",
              "round-trip latency of pool-dispatched queries per worker "
              "slot", labels=("worker",), buckets=REQUEST_BUCKETS)
    counter("sd_serve_worker_cache_total",
            "worker hot-directory-page LRU lookups by result (hit entries "
            "are watermark-checked — a stale page can never hit)",
            labels=("worker", "result"))
    counter("sd_serve_worker_restarts_total",
            "worker respawns by reason (crash = process died, timeout = "
            "unresponsive past SD_SERVE_REQUEST_TIMEOUT_S, health = "
            "failed ping)", labels=("worker", "reason"))
    gauge("sd_serve_workers", "live reader-pool worker processes")
    counter("sd_serve_invalidations_total",
            "per-library watermark bumps pushed to the worker page caches")
    histogram("sd_serve_queue_wait_seconds",
              "time a pool dispatch waited for an idle worker (saturation "
              "spills record the full SD_SERVE_QUEUE_WAIT_S wait) — the "
              "autosizer's input signal", buckets=REQUEST_BUCKETS)
    counter("sd_serve_pool_resizes_total",
            "autosizer resize decisions by direction (grow | shrink), "
            "each also a pool.resize flight-recorder event",
            labels=("direction",))
    # distributed read replicas: the ReplicaRouter dispatch
    # seam plus the replica-side serve arm — server/replica.py holds the
    # matching module handles. ``peer`` labels are mesh.peer_label hashes
    # (8 hex chars, bounded by fleet size).
    counter("sd_replica_dispatches_total",
            "pool-marked queries dispatched to a remote replica, per peer "
            "and outcome (ok | not_eligible | busy | error)",
            labels=("peer", "outcome"))
    counter("sd_replica_eligibility_rejections_total",
            "replica dispatches answered NOT_ELIGIBLE because the peer's "
            "applied HLC watermark did not cover the client's last write "
            "(the never-serve-a-stale-row gate)", labels=("peer",))
    counter("sd_replica_failovers_total",
            "replica-tier degradations to the next ladder rung (reason: "
            "not_eligible | busy | error | no_peers)", labels=("reason",))
    histogram("sd_replica_request_seconds",
              "round-trip latency of replica-served queries per peer",
              labels=("peer",), buckets=REQUEST_BUCKETS)
    counter("sd_replica_serves_total",
            "replica-SIDE serve outcomes for remote H_QUERY dispatches "
            "(ok | not_eligible | busy | error)", labels=("outcome",))
    # device-resident query engine: columnar search index + refresh
    # machinery (search/engine.py holds the matching module handles).
    # The help texts are the JAX package's, word for word, so the two
    # scrapes' HELP lines are equal. ``library`` labels are the
    # 8-hex library-id prefix — bounded like the sync ``peer`` labels.
    gauge("sd_search_index_rows",
          "live FilePath rows in the columnar search index per library",
          labels=("library",))
    gauge("sd_search_index_bytes",
          "resident bytes of the columnar search index per library",
          labels=("library",))
    histogram("sd_search_refresh_seconds",
              "latency of one search-index refresh pass (full or "
              "incremental)")
    counter("sd_search_refresh_total",
            "search-index refreshes by kind (full = rebuild, incremental "
            "= journal-driven delta)", labels=("kind",))
    gauge("sd_search_refresh_lag",
          "watermark bumps the search index is behind the library "
          "(0 = fresh; queries fall back to SQLite while > 0)",
          labels=("library",))
    counter("sd_search_queries_total",
            "search queries served per backend (device = JAX/Pallas "
            "kernels, cpu = numpy columnar, sqlite = the oracle path "
            "while the engine is armed)", labels=("backend",))
    histogram("sd_search_query_seconds",
              "search predicate-scoring latency per backend",
              labels=("backend",))
    counter("sd_search_fallbacks_total",
            "engine-armed queries that fell back to SQLite, by reason "
            "(stale | tags | needle | arg | toolarge | error | "
            "ineligible)", labels=("reason",))
    # the JAX package's lock sanitizer (SD_LOCK_SANITIZER=1) records
    # these; the port has no sanitizer, so they stay at zero here and are
    # declared for the scrape's parity
    histogram("sd_lock_wait_seconds",
              "time contended sanitized-lock acquisitions waited "
              "(SD_LOCK_SANITIZER=1 runs only)",
              labels=("name",), buckets=LOCK_BUCKETS)
    histogram("sd_lock_hold_seconds",
              "how long each sanitized lock was held per acquisition",
              labels=("name",), buckets=LOCK_BUCKETS)
    counter("sd_lock_contended_total",
            "sanitized-lock acquisitions that found the lock held",
            labels=("name",))


_declare_core()
