"""Declarative SLO engine over the serving-tier request telemetry.

Every rspc dispatch has latency histograms and outcome counters
(telemetry/requests.py); this module turns them into **objectives**: "99% of
requests (for a proc, or a tenant class) complete under X seconds,
measured over a budget window". Each objective maintains:

- the **SLI**: good requests / valid requests, read straight from the
  cumulative ``sd_rspc_request_seconds`` buckets (good = under the
  latency threshold and not an unexpected error) and
  ``sd_rspc_requests_total`` outcomes. BUSY sheds (admission control,
  outcome ``shed``) are *excluded from the valid set entirely* — a shed
  is deliberate load management with an explicit retry-after, not a
  broken promise, and counting it as an error would make admission
  control look like an outage.
- **error-budget remaining** over the objective's budget window
  (1.0 = untouched, 0.0 = exhausted), published as
  ``sd_slo_budget_remaining{objective}``.
- **multi-window burn rates** (the Google SRE fast/slow pairs, default
  5m/1h and 30m/6h), published as
  ``sd_slo_burn_rate{objective, window}``. A pair fires only when BOTH
  its windows burn above the pair's threshold (AND-gating: the short
  window proves it is happening *now*, the long window proves it is not
  a blip), emitting ``slo.burn`` flight-recorder events on both edges —
  which ride the existing event ring → SSE / ``telemetry.watch`` / CLI
  ``--follow`` plumbing for free.

Per-tenant SLIs read the bounded-cardinality ``sd_rspc_tenant_*``
families, labeled by :func:`tenant_label` — an 8-hex library-id hash in
the ``mesh.peer_label`` mold, LRU-capped at ``SD_TENANT_LABEL_CAP``
distinct tenants with an ``other`` overflow label, so a million
libraries can never explode the registry.

The engine mirrors :class:`~.alerts.AlertEvaluator`: a ticker thread in
production, :meth:`evaluate_once(now=...)` with an injected clock in
tests — burn-rate math over hours runs in microseconds on a virtual
clock. Like the alert evaluator's rate rules, cumulative samples that
*decrease* (a registry reset) restart the window instead of poisoning
it with a stale baseline.

Objectives load from ``SD_SLO_OBJECTIVES`` (a JSON list of objective
dicts) or fall back to :func:`default_objectives`. Served by the rspc
``telemetry.sloStatus`` query and rendered by
``python -m spacedrive_tpu_torch.telemetry --slo``.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any

from . import counter, event, gauge, histogram
from .registry import REQUEST_BUCKETS

logger = logging.getLogger(__name__)

# -- bounded tenant labels -----------------------------------------------------

#: distinct tenant hashes the registry will ever carry; everything past
#: the cap shares the ``other`` series (re-read per miss so tests can
#: retune; the assigned map itself is what bounds the registry)
_TENANT_CAP_DEFAULT = 64
OTHER_TENANT = "other"
LOCAL_TENANT = "local"

_TENANT_LOCK = threading.Lock()
#: tenant id -> 8-hex label, LRU-ordered (hot tenants stay introspectable
#: at the front of status dumps); insertion stops at the cap — an already
#: -assigned tenant keeps its label forever, so the registry's tenant
#: cardinality is hard-bounded at cap + 2 (``other`` + ``local``)
_TENANT_LRU: OrderedDict[str, str] = OrderedDict()


def _tenant_cap() -> int:
    import os

    try:
        return max(1, int(os.environ.get("SD_TENANT_LABEL_CAP",
                                         str(_TENANT_CAP_DEFAULT))))
    except ValueError:
        return _TENANT_CAP_DEFAULT


def tenant_label(library_id: str | None) -> str:
    """Bounded tenant label for a library id: 8 hex chars of blake2s
    (``mesh.peer_label``-style), ``local`` for node-scoped dispatches,
    ``other`` once ``SD_TENANT_LABEL_CAP`` distinct tenants are live."""
    if not library_id:
        return LOCAL_TENANT
    with _TENANT_LOCK:
        label = _TENANT_LRU.get(library_id)
        if label is not None:
            _TENANT_LRU.move_to_end(library_id)
            return label
        if len(_TENANT_LRU) >= _tenant_cap():
            return OTHER_TENANT
        import hashlib

        label = hashlib.blake2s(library_id.encode("utf-8", "replace"),
                                digest_size=4).hexdigest()
        _TENANT_LRU[library_id] = label
        return label


def reset_tenant_labels() -> None:
    """Tests: forget every assigned tenant (telemetry.reset() companion)."""
    with _TENANT_LOCK:
        _TENANT_LRU.clear()


def tenant_labels() -> list[str]:
    """Live tenant labels, most-recently-used last (introspection)."""
    with _TENANT_LOCK:
        return list(_TENANT_LRU.values())


# -- module metric handles -----------------------------------------------------
# families (help text, the single copy) are declared in _declare_core;
# these are get-or-create lookups exactly like server/pool.py's

_REQUESTS = counter("sd_rspc_requests_total",
                    labels=("proc", "kind", "outcome"))
_SECONDS = histogram("sd_rspc_request_seconds", labels=("proc",),
                     buckets=REQUEST_BUCKETS)
_T_REQUESTS = counter("sd_rspc_tenant_requests_total",
                      labels=("tenant", "outcome"))
_T_SECONDS = histogram("sd_rspc_tenant_request_seconds", labels=("tenant",),
                       buckets=REQUEST_BUCKETS)
_BUDGET = gauge("sd_slo_budget_remaining", labels=("objective",))
_BURN = gauge("sd_slo_burn_rate", labels=("objective", "window"))


# -- objectives ----------------------------------------------------------------

class SloObjectiveError(ValueError):
    """Malformed objective — raised at declaration, never in the ticker."""


def _window_label(seconds: float) -> str:
    if seconds % 3600 == 0 and seconds >= 3600:
        return f"{int(seconds // 3600)}h"
    if seconds % 60 == 0 and seconds >= 60:
        return f"{int(seconds // 60)}m"
    return f"{int(seconds)}s"


@dataclass(frozen=True)
class SloObjective:
    """One objective: {proc or tenant-class, latency threshold, target
    ratio, budget window}. ``proc=None, tenant=None`` covers every
    dispatch; ``tenant="*"`` aggregates the per-tenant families (so the
    per-tenant recording path itself is under an SLO); ``tenant="<8hex>"``
    pins one tenant class."""

    name: str
    threshold_s: float
    target: float
    window_s: float = 6 * 3600.0
    proc: str | None = None
    tenant: str | None = None
    #: (short, long) burn windows; a pair fires only when BOTH exceed
    #: its threshold (AND-gating)
    fast_windows: tuple[float, float] = (300.0, 3600.0)
    slow_windows: tuple[float, float] = (1800.0, 21600.0)
    fast_burn: float = 14.4
    slow_burn: float = 6.0
    severity: str = "warning"
    description: str = ""

    def __post_init__(self) -> None:
        if self.threshold_s <= 0:
            raise SloObjectiveError(f"{self.name}: threshold_s must be > 0")
        if not 0.0 < self.target < 1.0:
            raise SloObjectiveError(f"{self.name}: target must be in (0, 1)")
        if self.window_s <= 0:
            raise SloObjectiveError(f"{self.name}: window_s must be > 0")
        for pair in (self.fast_windows, self.slow_windows):
            if len(pair) != 2 or pair[0] <= 0 or pair[1] <= pair[0]:
                raise SloObjectiveError(
                    f"{self.name}: burn windows must be (short, long) with "
                    f"0 < short < long, got {pair}")
        if self.fast_burn <= 0 or self.slow_burn <= 0:
            raise SloObjectiveError(f"{self.name}: burn thresholds must "
                                    "be > 0")
        if self.proc is not None and self.tenant is not None:
            raise SloObjectiveError(
                f"{self.name}: proc and tenant filters are exclusive (one "
                "objective reads one family)")

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "SloObjective":
        try:
            return cls(
                name=str(raw["name"]),
                threshold_s=float(raw["threshold_s"]),
                target=float(raw["target"]),
                window_s=float(raw.get("window_s", 6 * 3600.0)),
                proc=(str(raw["proc"]) if raw.get("proc") else None),
                tenant=(str(raw["tenant"]) if raw.get("tenant") else None),
                fast_windows=tuple(float(w) for w in raw.get(
                    "fast_windows", (300.0, 3600.0))),
                slow_windows=tuple(float(w) for w in raw.get(
                    "slow_windows", (1800.0, 21600.0))),
                fast_burn=float(raw.get("fast_burn", 14.4)),
                slow_burn=float(raw.get("slow_burn", 6.0)),
                severity=str(raw.get("severity", "warning")),
                description=str(raw.get("description", "")))
        except KeyError as e:
            raise SloObjectiveError(
                f"objective missing {e.args[0]!r}") from None

    def to_dict(self) -> dict[str, Any]:
        return {"name": self.name, "threshold_s": self.threshold_s,
                "target": self.target, "window_s": self.window_s,
                "proc": self.proc, "tenant": self.tenant,
                "fast_windows": list(self.fast_windows),
                "slow_windows": list(self.slow_windows),
                "fast_burn": self.fast_burn, "slow_burn": self.slow_burn,
                "severity": self.severity, "description": self.description}


def default_objectives() -> list[SloObjective]:
    """The stock serving objectives (override via ``SD_SLO_OBJECTIVES``)."""
    return [
        SloObjective(
            name="queries-fast", threshold_s=0.25, target=0.99,
            window_s=6 * 3600.0,
            description="99% of rspc dispatches complete under 250 ms "
                        "(the slow-request threshold) over 6 h — the "
                        "whole-node read-path promise"),
        SloObjective(
            name="tenant-reads", tenant="*", threshold_s=1.0, target=0.995,
            window_s=6 * 3600.0,
            description="99.5% of library-scoped dispatches across every "
                        "tenant complete under 1 s over 6 h — the "
                        "multi-tenant fairness promise (sheds excluded; "
                        "admission control is not an outage)"),
    ]


def load_objectives() -> list[SloObjective]:
    """default_objectives(), or the JSON list named by
    ``SD_SLO_OBJECTIVES`` (malformed file logs and falls back — SLO
    evaluation must not wedge boot)."""
    import json
    import os
    from pathlib import Path

    path = os.environ.get("SD_SLO_OBJECTIVES")
    if not path:
        return default_objectives()
    try:
        raw = json.loads(Path(path).read_text(encoding="utf-8"))
        return [SloObjective.from_dict(o) for o in raw]
    except Exception:
        logger.exception("SD_SLO_OBJECTIVES %r unusable; using defaults",
                         path)
        return default_objectives()


# -- engine --------------------------------------------------------------------

class _ObjectiveState:
    __slots__ = ("history", "firing", "budget_remaining", "burn", "sli",
                 "good", "valid")

    def __init__(self) -> None:
        #: (t, cumulative good, cumulative valid) samples, trimmed to the
        #: longest window the objective reads
        self.history: list[tuple[float, float, float]] = []
        #: pair name ("fast" | "slow") -> currently firing
        self.firing: dict[str, bool] = {"fast": False, "slow": False}
        self.budget_remaining = 1.0
        self.burn: dict[str, float] = {}
        self.sli = 1.0
        self.good = 0.0
        self.valid = 0.0


class SloEngine:
    """Evaluates the objective set on a ticker thread (or on demand via
    :meth:`evaluate_once` — tests drive it with an injected clock, the
    same contract as :class:`~.alerts.AlertEvaluator`)."""

    def __init__(self, objectives: list[SloObjective] | None = None,
                 interval_s: float = 5.0) -> None:
        self.objectives = list(objectives if objectives is not None
                               else load_objectives())
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise SloObjectiveError(f"duplicate objective names in {names}")
        self.interval_s = interval_s
        self._states = {o.name: _ObjectiveState() for o in self.objectives}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "SloEngine":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="sd-slo")
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
                logger.exception("SLO evaluation tick failed")

    # -- SLI reads -----------------------------------------------------------
    @staticmethod
    def _good_under(seconds_family, threshold_s: float,
                    label: str, want: str | None) -> tuple[float, float]:
        """(under-threshold count, total count) summed over the family's
        series matching the ``label == want`` filter (``want=None`` or
        ``"*"`` matches all)."""
        under = total = 0.0
        boundaries = seconds_family.buckets
        for lbls, series in seconds_family.series_items():
            if want not in (None, "*") and lbls.get(label) != want:
                continue
            counts, _sum, n = series.read()
            total += n
            for i, bound in enumerate(boundaries):
                if bound <= threshold_s:
                    under += counts[i]
                else:
                    break
        return under, total

    @staticmethod
    def _outcomes(requests_family, label: str,
                  want: str | None) -> dict[str, float]:
        out: dict[str, float] = {}
        for lbls, series in requests_family.series_items():
            if want not in (None, "*") and lbls.get(label) != want:
                continue
            outcome = lbls.get("outcome", "")
            out[outcome] = out.get(outcome, 0.0) + series.value
        return out

    def _totals(self, obj: SloObjective) -> tuple[float, float]:
        """Cumulative (good, valid) for one objective. Sheds leave the
        valid set; unexpected errors leave the good set (conservatively
        assumed fast — a crash that was also slow cannot double-count)."""
        if obj.tenant is not None:
            under, total = self._good_under(_T_SECONDS, obj.threshold_s,
                                            "tenant", obj.tenant)
            outcomes = self._outcomes(_T_REQUESTS, "tenant", obj.tenant)
        else:
            under, total = self._good_under(_SECONDS, obj.threshold_s,
                                            "proc", obj.proc)
            outcomes = self._outcomes(_REQUESTS, "proc", obj.proc)
        sheds = outcomes.get("shed", 0.0)
        errors = outcomes.get("error", 0.0)
        valid = max(0.0, total - sheds)
        good = max(0.0, min(valid, under - sheds - errors))
        return good, valid

    # -- evaluation ----------------------------------------------------------
    @staticmethod
    def _window_delta(history: list[tuple[float, float, float]],
                      now: float, window_s: float) -> tuple[float, float]:
        """(bad, valid) accumulated over the trailing window: newest
        sample minus the newest sample at-or-before ``now - window_s``
        (the oldest retained sample when the process is younger than the
        window — a young window burns conservatively hot, never cold)."""
        if not history:
            return 0.0, 0.0
        floor = now - window_s
        base = history[0]
        for sample in history:
            if sample[0] <= floor:
                base = sample
            else:
                break
        _t1, good1, valid1 = history[-1]
        _t0, good0, valid0 = base
        valid_w = max(0.0, valid1 - valid0)
        bad_w = max(0.0, valid_w - max(0.0, good1 - good0))
        return bad_w, valid_w

    def evaluate_once(self, now: float | None = None) -> list[dict[str, Any]]:
        """One pass over every objective; returns the post-pass status()
        list. ``now`` is injectable so tests drive hour-long burn windows
        without sleeping."""
        now = time.monotonic() if now is None else now
        with self._lock:
            for obj in self.objectives:
                self._evaluate_objective(obj, self._states[obj.name], now)
            return self._status_locked()

    def _evaluate_objective(self, obj: SloObjective, state: _ObjectiveState,
                            now: float) -> None:
        good, valid = self._totals(obj)
        if state.history and (good < state.history[-1][1]
                              or valid < state.history[-1][2]):
            # cumulative counts went DOWN: the registry was reset (tests,
            # pool/shell restart) — a stale baseline would smear phantom
            # burn over a full window, so the window restarts here (the
            # same discipline as the alert evaluator's rate history)
            state.history.clear()
        state.history.append((now, good, valid))
        horizon = max(obj.window_s, obj.fast_windows[1], obj.slow_windows[1])
        floor = now - horizon
        # keep one sample at-or-before the floor as the window baseline
        while len(state.history) > 1 and state.history[1][0] <= floor:
            state.history.pop(0)

        state.good, state.valid = good, valid
        state.sli = (good / valid) if valid > 0 else 1.0
        budget_fraction = 1.0 - obj.target

        bad_bw, valid_bw = self._window_delta(state.history, now,
                                              obj.window_s)
        if valid_bw > 0:
            consumed = (bad_bw / valid_bw) / budget_fraction
            state.budget_remaining = max(0.0, 1.0 - consumed)
        else:
            state.budget_remaining = 1.0
        _BUDGET.set(round(state.budget_remaining, 6), objective=obj.name)

        burns: dict[str, float] = {}
        for window_s in (*obj.fast_windows, *obj.slow_windows):
            bad_w, valid_w = self._window_delta(state.history, now, window_s)
            rate = ((bad_w / valid_w) / budget_fraction
                    if valid_w > 0 else 0.0)
            label = _window_label(window_s)
            burns[label] = round(rate, 4)
            _BURN.set(burns[label], objective=obj.name, window=label)
        state.burn = burns

        for pair, windows, threshold in (
                ("fast", obj.fast_windows, obj.fast_burn),
                ("slow", obj.slow_windows, obj.slow_burn)):
            labels = tuple(_window_label(w) for w in windows)
            # AND-gate: BOTH windows must burn above the pair threshold
            firing = all(burns[lb] > threshold for lb in labels)
            if firing != state.firing[pair]:
                state.firing[pair] = firing
                event("slo.burn", objective=obj.name, pair=pair,
                      state="firing" if firing else "resolved",
                      windows=list(labels),
                      burn={lb: burns[lb] for lb in labels},
                      threshold=threshold, severity=obj.severity,
                      budget_remaining=round(state.budget_remaining, 4))
                logger.warning(
                    "SLO %s %s burn %s (windows %s, burn %s > %s, budget "
                    "%.1f%% left)", obj.name, pair,
                    "FIRING" if firing else "resolved", labels,
                    {lb: burns[lb] for lb in labels}, threshold,
                    state.budget_remaining * 100.0)

    # -- introspection -------------------------------------------------------
    def _status_locked(self) -> list[dict[str, Any]]:
        out = []
        for obj in self.objectives:
            s = self._states[obj.name]
            out.append({
                **obj.to_dict(),
                "sli": round(s.sli, 6),
                "good": s.good,
                "valid": s.valid,
                "budget_remaining": round(s.budget_remaining, 6),
                "burn": dict(s.burn),
                "firing": dict(s.firing),
            })
        return out

    def status(self) -> list[dict[str, Any]]:
        """What ``telemetry.sloStatus`` serves: every objective with its
        live SLI, budget, burn rates and firing pairs."""
        with self._lock:
            return self._status_locked()
