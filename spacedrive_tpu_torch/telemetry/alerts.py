"""Declarative SLO/alert rules evaluated against the live registry.

Monarch-shaped (planet-scale in-memory monitoring): instead of
shipping raw scrapes to an external evaluator, a small ticker inside the
node evaluates **rules** against the in-memory series and fires edges
into the flight-recorder event ring (``alert.firing`` /
``alert.resolved``), the node notification surface, and the
``sd_alerts_firing{rule}`` gauge.

Rule grammar (one dict per rule; see ``AlertRule.from_dict`` /
``default_rules`` and docs/architecture/observability.md):

```
{"name": "sync-peer-lag",          # unique; becomes the {rule=} label
 "kind": "threshold",              # threshold | rate | absence
 "series": "sd_sync_peer_lag_ops", # counter/gauge family (sd_* vocabulary)
 "labels": {"peer": "ab12cd34"},   # optional exact-match filter; omitted
                                   # labels match any series
 "op": "gt",                       # gt | lt   (threshold & rate)
 "value": 500,                     # the threshold
 "for_s": 30,                      # condition must hold this long
 "window_s": 60,                   # rate: increase window (counters)
 "severity": "warning"}            # informational passthrough
```

Semantics:

- **threshold** — fires while any matching series compares true against
  ``value``. ``lt`` rules skip series whose value is 0 (an idle/never-
  touched gauge is "no data", not "below the floor").
- **rate** — per-second increase of the summed matching series over the
  trailing ``window_s``; compares like threshold. For counters.
- **absence** — fires while NO matching series exists (device numbers
  missing, an exporter that never came up). ``for_s`` doubles as the
  boot grace period.

Histogram families are not rule targets (alert on the gauges/counters
derived next to them instead).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from . import METRIC_NAME_RE, event, gauge, series_values

logger = logging.getLogger(__name__)

THRESHOLD = "threshold"
RATE = "rate"
ABSENCE = "absence"

_FIRING = gauge(
    "sd_alerts_firing",
    "1 while the named alert rule is firing (telemetry/alerts.py)",
    labels=("rule",))


class AlertRuleError(ValueError):
    """Malformed rule — raised at declaration, never inside the ticker."""


@dataclass(frozen=True)
class AlertRule:
    name: str
    kind: str
    series: str
    labels: dict[str, str] = field(default_factory=dict)
    op: str = "gt"
    value: float = 0.0
    for_s: float = 0.0
    window_s: float = 60.0
    severity: str = "warning"
    description: str = ""

    def __post_init__(self) -> None:
        if self.kind not in (THRESHOLD, RATE, ABSENCE):
            raise AlertRuleError(f"{self.name}: unknown kind {self.kind!r}")
        if self.op not in ("gt", "lt"):
            raise AlertRuleError(f"{self.name}: op must be gt|lt")
        if not METRIC_NAME_RE.match(self.series):
            raise AlertRuleError(
                f"{self.name}: series {self.series!r} outside the sd_* "
                "vocabulary")
        if self.for_s < 0 or self.window_s <= 0:
            raise AlertRuleError(f"{self.name}: negative/zero durations")

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "AlertRule":
        try:
            return cls(
                name=str(raw["name"]), kind=str(raw["kind"]),
                series=str(raw["series"]),
                labels={str(k): str(v)
                        for k, v in (raw.get("labels") or {}).items()},
                op=str(raw.get("op", "gt")),
                value=float(raw.get("value", 0.0)),
                for_s=float(raw.get("for_s", 0.0)),
                window_s=float(raw.get("window_s", 60.0)),
                severity=str(raw.get("severity", "warning")),
                description=str(raw.get("description", "")))
        except KeyError as e:
            raise AlertRuleError(f"rule missing {e.args[0]!r}") from None

    def to_dict(self) -> dict[str, Any]:
        return {"name": self.name, "kind": self.kind, "series": self.series,
                "labels": dict(self.labels), "op": self.op,
                "value": self.value, "for_s": self.for_s,
                "window_s": self.window_s, "severity": self.severity,
                "description": self.description}


def default_rules() -> list[AlertRule]:
    """The stock SLO set every node evaluates (override/extend via
    ``SD_ALERT_RULES`` pointing at a JSON list of rule dicts). The JAX
    package's ``device-numbers-missing`` rule is not in the port's set: it
    watches ``sd_hash_router_bytes_per_sec``, a family of the hybrid hash
    router, which the port does not have (its hashes run on the card or
    raise)."""
    return [
        AlertRule(
            name="sync-peer-lag", kind=THRESHOLD,
            series="sd_sync_peer_lag_ops", op="gt", value=500.0, for_s=30.0,
            description="a peer's declared sync backlog stayed above 500 "
                        "ops — ingest is not keeping up with that sender"),
        AlertRule(
            name="quarantine-spike", kind=RATE,
            series="sd_quarantined_files_total", op="gt", value=5.0,
            window_s=30.0, for_s=0.0,
            description="identifier quarantine rate above 5 files/s — a "
                        "location is rotting or a fault storm is live"),
        AlertRule(
            name="scan-rate-floor", kind=THRESHOLD,
            series="sd_scan_files_per_sec", op="lt", value=100.0, for_s=60.0,
            description="the last completed identify pass ran below 100 "
                        "files/s (0 = never scanned, which does not fire)"),
        AlertRule(
            name="db-quick-check-failed", kind=THRESHOLD,
            series="sd_boot_integrity_checks_total",
            labels={"outcome": "corrupt"}, op="gt", value=0.0, for_s=0.0,
            severity="critical",
            description="a library DB failed PRAGMA quick_check at boot — "
                        "the repair ladder quarantined it and restored the "
                        "newest backup (or recreated it fresh); inspect "
                        "libraries/quarantine/"),
        AlertRule(
            name="disk-full", kind=RATE,
            series="sd_recovery_disk_full_total", op="gt", value=0.01,
            window_s=60.0, for_s=0.0, severity="critical",
            description="ENOSPC is being absorbed by graceful degradation "
                        "(quarantined gathers, skipped thumbnails, ring-only "
                        "telemetry, paused commits) — free disk space"),
        # serving tier: the p99 gauge is published per
        # procedure by the resource-watcher tick (histograms are not rule
        # targets); errors ride the outcome label on the request counter
        AlertRule(
            name="rspc-query-p99", kind=THRESHOLD,
            series="sd_rspc_request_p99_seconds", op="gt", value=2.0,
            for_s=30.0,
            description="a procedure's estimated p99 dispatch latency "
                        "stayed above 2 s — the read path is melting under "
                        "load (check the slow-request ring for the span "
                        "breakdown)"),
        AlertRule(
            name="rspc-error-rate", kind=RATE,
            series="sd_rspc_requests_total",
            labels={"outcome": "error"}, op="gt", value=1.0,
            window_s=60.0, for_s=0.0, severity="critical",
            description="unexpected rspc dispatch failures above 1/s over "
                        "the last minute (api_error rejections do not "
                        "count) — a handler is crashing under traffic"),
    ]


def load_rules() -> list[AlertRule]:
    """default_rules(), or the JSON rule list named by ``SD_ALERT_RULES``
    (a malformed file logs and falls back — alerting must not wedge
    boot)."""
    import json
    import os
    from pathlib import Path

    path = os.environ.get("SD_ALERT_RULES")
    if not path:
        return default_rules()
    try:
        raw = json.loads(Path(path).read_text(encoding="utf-8"))
        return [AlertRule.from_dict(r) for r in raw]
    except Exception:
        logger.exception("SD_ALERT_RULES %r unusable; using defaults", path)
        return default_rules()


class _RuleState:
    __slots__ = ("pending_since", "firing", "value", "labels", "history")

    def __init__(self) -> None:
        self.pending_since: float | None = None
        self.firing = False
        self.value: float | None = None
        self.labels: dict[str, str] | None = None
        #: (t, summed value) samples for rate rules, trimmed to window_s
        self.history: list[tuple[float, float]] = []


class AlertEvaluator:
    """Evaluates the rule set on a ticker thread (or on demand via
    :meth:`evaluate_once` — tests drive it with an injected clock)."""

    def __init__(self, rules: list[AlertRule] | None = None,
                 interval_s: float = 5.0,
                 notify: Callable[[AlertRule, bool, float | None], None]
                 | None = None) -> None:
        self.rules = list(rules if rules is not None else load_rules())
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise AlertRuleError(f"duplicate rule names in {names}")
        self.interval_s = interval_s
        self._notify = notify
        self._states = {r.name: _RuleState() for r in self.rules}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "AlertEvaluator":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="sd-alerts")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.evaluate_once()
            except Exception:
                logger.exception("alert evaluation tick failed")

    # -- evaluation ----------------------------------------------------------
    def _matching(self, rule: AlertRule) -> list[tuple[dict[str, str], float]]:
        return [(lbls, v) for lbls, v in series_values(rule.series)
                if all(lbls.get(k) == v for k, v in rule.labels.items())]

    @staticmethod
    def _breach(rule: AlertRule, value: float) -> bool:
        return value > rule.value if rule.op == "gt" else value < rule.value

    def _condition(self, rule: AlertRule, state: _RuleState,
                   now: float) -> tuple[bool, float | None,
                                        dict[str, str] | None]:
        """(condition-true, offending value, offending labels)."""
        matching = self._matching(rule)
        if rule.kind == ABSENCE:
            return (not matching, None, dict(rule.labels) or None)
        if rule.kind == THRESHOLD:
            worst: tuple[float, dict[str, str]] | None = None
            for lbls, v in matching:
                if rule.op == "lt" and v == 0.0:
                    continue  # idle/never-written gauge: no data, no alert
                if self._breach(rule, v) and (
                        worst is None
                        or (v > worst[0] if rule.op == "gt" else v < worst[0])):
                    worst = (v, lbls)
            if worst is None:
                return False, None, None
            return True, worst[0], worst[1]
        # RATE: per-second increase of the summed series over the window
        total = sum(v for _lbls, v in matching)
        if state.history and total < state.history[-1][1]:
            # counter reset (pool/shell restart, telemetry.reset()): every
            # older sample is a stale-high baseline — keeping any would
            # clamp the computed rate to 0 for a full window (max() below)
            # and, worse, the next increments would be measured against
            # the pre-reset total. Start the window over from here.
            state.history.clear()
        state.history.append((now, total))
        floor = now - rule.window_s
        while len(state.history) > 1 and state.history[1][0] <= floor:
            state.history.pop(0)
        t0, v0 = state.history[0]
        if now - t0 <= 0:
            return False, None, None
        per_sec = max(0.0, total - v0) / (now - t0)
        return self._breach(rule, per_sec), round(per_sec, 3), None

    def evaluate_once(self, now: float | None = None) -> list[dict[str, Any]]:
        """One pass over every rule; returns the post-pass state() list.
        ``now`` is injectable so tests drive for_s/window_s without
        sleeping."""
        now = time.monotonic() if now is None else now
        with self._lock:
            for rule in self.rules:
                state = self._states[rule.name]
                cond, value, labels = self._condition(rule, state, now)
                if cond:
                    if state.pending_since is None:
                        state.pending_since = now
                    state.value, state.labels = value, labels
                    held = now - state.pending_since
                    if not state.firing and held >= rule.for_s:
                        state.firing = True
                        self._edge(rule, state, firing=True)
                else:
                    state.pending_since = None
                    state.value, state.labels = value, labels
                    if state.firing:
                        state.firing = False
                        self._edge(rule, state, firing=False)
            return self._state_locked()

    def _edge(self, rule: AlertRule, state: _RuleState, firing: bool) -> None:
        _FIRING.set(1.0 if firing else 0.0, rule=rule.name)
        event("alert.firing" if firing else "alert.resolved",
              rule=rule.name, series=rule.series, severity=rule.severity,
              value=state.value,
              **({"labels": state.labels} if state.labels else {}))
        logger.warning("alert %s %s (series %s, value %s)", rule.name,
                       "FIRING" if firing else "resolved", rule.series,
                       state.value)
        if self._notify is not None:
            try:
                self._notify(rule, firing, state.value)
            except Exception:
                logger.exception("alert notify hook failed for %s", rule.name)

    # -- introspection -------------------------------------------------------
    def _state_locked(self) -> list[dict[str, Any]]:
        out = []
        for rule in self.rules:
            s = self._states[rule.name]
            # "value" stays the CONFIGURED threshold (rule.to_dict());
            # the live observation rides separately — a healthy rule's
            # None observation must not clobber the threshold clients
            # render ("fires above <value>")
            out.append({**rule.to_dict(), "firing": s.firing,
                        "live_value": s.value,
                        "pending": s.pending_since is not None
                        and not s.firing})
        return out

    def state(self) -> list[dict[str, Any]]:
        """What ``telemetry.alerts`` serves: every rule + live status."""
        with self._lock:
            return self._state_locked()
