"""telemetry.* procedures: the rspc view of the unified
registry, the per-job trace trees, the live flight recorder, and the
alert evaluator.

- ``telemetry.snapshot`` — metrics + recent events + recent trace
  summaries in one JSON document (what ``python -m
  spacedrive_tpu_torch.telemetry`` pretty-prints).
- ``telemetry.jobTrace`` — the nested span tree of one job run (in-memory
  ring first, then the exported JSONL under ``<data_dir>/logs/traces/``),
  or null when nothing was recorded (``SD_TELEMETRY=off`` runs).
- ``telemetry.watch`` — SUBSCRIPTION: the flight-recorder event stream
  (job transitions, fault firings, router flips, sync sessions, alert
  edges) live over the websocket; the SSE twin is ``GET
  /telemetry/stream`` on the shell.
- ``telemetry.alerts`` — every alert rule with its live firing state.
- ``telemetry.sloStatus`` — the SLO engine's objectives with live SLI,
  error-budget remaining and multi-window burn rates, plus
  the rspc dispatch-admission budget state.
"""

from __future__ import annotations

from ... import telemetry
from ..router import ApiError
from ._util import filtered_subscription


def mount(router) -> None:
    @router.query("telemetry.snapshot")
    def snapshot(node, _arg):
        """Full telemetry state of this node process."""
        return telemetry.snapshot()

    @router.query("telemetry.jobTrace")
    def job_trace(node, arg):
        """Span tree for a job id (arg: the id string, or
        {"job_id": ...}); null when no trace was recorded."""
        job_id = arg.get("job_id") if isinstance(arg, dict) else arg
        if not job_id or not isinstance(job_id, str):
            raise ApiError("telemetry.jobTrace needs a job id")
        return telemetry.job_trace(job_id, data_dir=node.data_dir)

    @router.subscription("telemetry.watch")
    def watch(node, _arg):
        """Live flight-recorder tail: one event per telemetry.event()
        (the Node bridges the ring's hooks onto its event bus)."""
        return filtered_subscription(node, {"telemetry.event"})

    @router.query("telemetry.alerts")
    def alerts(node, _arg):
        """The SLO/alert rule set with live state (telemetry/alerts.py)."""
        evaluator = getattr(node, "alerts", None)
        return {"rules": evaluator.state() if evaluator is not None else []}

    @router.query("telemetry.sloStatus")
    def slo_status(node, _arg):
        """SLO objectives with live SLI / error budget / burn rates
        (telemetry/slo.py), plus dispatch-admission budget state — the
        serving tier's "are we inside our promises" page."""
        engine = getattr(node, "slo", None)
        budget = getattr(node, "dispatch_budget", None)
        return {
            "objectives": engine.status() if engine is not None else [],
            "dispatch_admission":
                budget.status() if budget is not None else None,
        }

    @router.query("telemetry.requestStats")
    def request_stats(node, arg):
        """Serving-tier request telemetry: per-procedure
        p50/p95/p99 latency estimates, outcome/payload counts, in-flight,
        and the slow-request ring with full span trees (arg: optional
        {"slow_limit": n})."""
        from ...telemetry import requests as rq

        limit = 16
        if isinstance(arg, dict):
            try:
                limit = max(0, min(int(arg.get("slow_limit", 16)),
                                   rq.SLOW_RING))
            except (TypeError, ValueError):
                raise ApiError("slow_limit must be an integer")
        out = rq.stats(slow_limit=limit)
        # serve-pool fold-in: the multi-process reader pool's
        # worker/cache/restart state, when one is running (null in the
        # degraded in-process mode)
        pool = getattr(node, "reader_pool", None)
        out["serve_pool"] = pool.status() if pool is not None else None
        return out
