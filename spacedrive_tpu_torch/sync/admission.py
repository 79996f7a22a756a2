"""Admission control for sync ingest: shed, don't buffer.

A trimmed copy of ``spacedrive_tpu/sync/admission.py``'s
:class:`IngestBudget`. It tracks the ops and bytes admitted but not yet
durable across every ingest source of one node (``node.ingest_budget``):
the p2p sync responder's windows, the ``H_HASH`` batches a peer sends the
hash service and the delta transfer's chunk windows. ``try_admit`` returns
an :class:`Admission` token (``release()`` it when the window is durable)
or a :class:`Busy` verdict carrying ``retry_after_ms``; the responder then
answers the peer BUSY instead of buffering, and the peer backs off and
resumes from its acknowledged watermark (:mod:`..p2p.nlm`).

Fairness: a peer with nothing in flight that asks for no more than its
fair share (budget ÷ peers in flight) is never shed; only the hard global
bound sheds a peer that already holds work in flight. A node with nothing
in flight admits a window larger than the whole budget, so a peer can
always make progress.

The bounds come from ``SD_SYNC_INGEST_BUDGET_OPS`` (4,000) and
``SD_SYNC_INGEST_BUDGET_BYTES`` (32 MiB), the advised backoff from
``SD_SYNC_RETRY_AFTER_MS`` (200, scaled by how far over budget the node
is), all read when the budget is made. The ``sync_ingest`` fault seam
(:mod:`..faults`) sits at the check: an armed ``sync_ingest:overload``
sheds the window as a real over-budget node would. ``status()`` is what
``sync.fleetStatus`` reports.

:class:`DispatchBudget` (reference :246-330) is the same shape at the rspc
dispatch seam (``node.dispatch_budget``): one unit a dispatch in flight,
keyed by tenant (:func:`tenant_label`, the bounded library-id hash of
``spacedrive_tpu/telemetry/slo.py:88-113``) instead of peer, with the same
fair-share rule word for word and the same pressure-scaled
``retry_after_ms``. The router turns its :class:`Busy` into a ``BusyError``
(429). ``SD_RSPC_BUDGET`` (64) and ``SD_RSPC_RETRY_AFTER_MS`` (50) are read
when the budget is made; the ``rspc_admission`` seam sheds a dispatch as
``sync_ingest`` sheds a window. ``status()`` gives the in-flight and shed
counts as plain numbers.

Telemetry, as the reference's: ``sd_sync_shed_{windows,ops}_total{peer}``
with a ``sync.shed`` event, ``sd_sync_admission_{ops,bytes}_in_flight``
and ``_budget_{ops,bytes}`` for the ingest budget;
``sd_rspc_shed_total{tenant}`` with an ``rspc.shed`` event,
``sd_rspc_admission_in_flight`` and ``sd_rspc_admission_budget`` for the
dispatch budget. :func:`tenant_label` is :mod:`..telemetry.slo`'s.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass

from .. import faults, telemetry
from ..telemetry.slo import (LOCAL_TENANT, OTHER_TENANT, reset_tenant_labels,  # noqa: F401
                             tenant_label)

DEFAULT_BUDGET_OPS = 4000
DEFAULT_BUDGET_BYTES = 32 * 1024 * 1024
BASE_RETRY_AFTER_MS = 200
#: the rspc dispatches admitted at once (DispatchBudget); generous, the
#: bound is against queue collapse under overload, not healthy traffic
DEFAULT_DISPATCH_INFLIGHT = 64
#: what a shed rspc client is told to wait (ms), scaled by pressure
BASE_DISPATCH_RETRY_AFTER_MS = 50

_SHED_WINDOWS = telemetry.counter(
    "sd_sync_shed_windows_total",
    "ingest windows answered BUSY instead of buffered", labels=("peer",))
_SHED_OPS = telemetry.counter(
    "sd_sync_shed_ops_total",
    "CRDT ops shed by admission control (re-served after backoff)",
    labels=("peer",))
_ADMIT_OPS = telemetry.gauge(
    "sd_sync_admission_ops_in_flight",
    "CRDT ops admitted but not yet durable")
_ADMIT_BYTES = telemetry.gauge(
    "sd_sync_admission_bytes_in_flight",
    "window bytes admitted but not yet durable")
_BUDGET_OPS = telemetry.gauge(
    "sd_sync_admission_budget_ops", "configured ingest budget (ops)")
_BUDGET_BYTES = telemetry.gauge(
    "sd_sync_admission_budget_bytes", "configured ingest budget (bytes)")
# dispatch-admission families (help text lives in _declare_core)
_D_SHED = telemetry.counter("sd_rspc_shed_total", labels=("tenant",))
_D_INFLIGHT = telemetry.gauge("sd_rspc_admission_in_flight")
_D_BUDGET = telemetry.gauge("sd_rspc_admission_budget")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


@dataclass(frozen=True)
class Busy:
    """The shed verdict: when the peer should come back."""

    retry_after_ms: int
    reason: str = "over budget"


class Admission:
    """Token for one admitted window; ``release()`` once, when the window's
    ops are durable (or abandoned)."""

    __slots__ = ("_budget", "_peer", "_ops", "_bytes", "_released")

    def __init__(self, budget: "IngestBudget | DispatchBudget", peer: str, ops: int,
                 nbytes: int) -> None:
        self._budget = budget
        self._peer = peer
        self._ops = ops
        self._bytes = nbytes
        self._released = False

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        self._budget._release(self._peer, self._ops, self._bytes)


class IngestBudget:
    """The node-wide bound on (ops, bytes) in flight across every ingest
    source. Thread-safe."""

    def __init__(self, max_ops: int | None = None, max_bytes: int | None = None) -> None:
        if max_ops is None:
            max_ops = _env_int("SD_SYNC_INGEST_BUDGET_OPS", DEFAULT_BUDGET_OPS)
        if max_bytes is None:
            max_bytes = _env_int("SD_SYNC_INGEST_BUDGET_BYTES", DEFAULT_BUDGET_BYTES)
        self.max_ops = max(1, int(max_ops))
        self.max_bytes = max(1, int(max_bytes))
        self.base_retry_after_ms = _env_int("SD_SYNC_RETRY_AFTER_MS", BASE_RETRY_AFTER_MS)
        self._lock = threading.Lock()
        self._ops = 0
        self._bytes = 0
        #: peer label -> (ops, bytes) in flight
        self._per_peer: dict[str, tuple[int, int]] = {}
        self._shed_windows = 0
        self._shed_ops = 0
        _BUDGET_OPS.set(self.max_ops)
        _BUDGET_BYTES.set(self.max_bytes)

    def try_admit(self, peer: str, ops: int, nbytes: int = 0) -> Admission | Busy:
        """Admit ``ops`` / ``nbytes`` for ``peer`` or say when to come back."""
        try:
            faults.inject("sync_ingest", key=peer)
        except Exception:
            with self._lock:
                pressure = self._shed_locked(ops)
            return self._busy(peer, ops, pressure, "injected overload")
        with self._lock:
            p_ops, p_bytes = self._per_peer.get(peer, (0, 0))
            active = len(self._per_peer) + (0 if peer in self._per_peer else 1)
            over_global = (self._ops + ops > self.max_ops
                           or self._bytes + nbytes > self.max_bytes)
            if over_global and self._ops == 0 and self._bytes == 0:
                over_global = False  # idle node: an oversized window admits
            # fairness floor: a peer under its fair share (ops and bytes) is
            # shed by the global bound only when it already holds work
            fair_ops = self.max_ops // max(1, active)
            fair_bytes = self.max_bytes // max(1, active)
            under_share = (p_ops + ops <= max(fair_ops, 1)
                           and p_bytes + nbytes <= max(fair_bytes, 1))
            if over_global and (not under_share or p_ops > 0):
                pressure = self._shed_locked(ops)
            else:
                self._ops += ops
                self._bytes += nbytes
                self._per_peer[peer] = (p_ops + ops, p_bytes + nbytes)
                pressure = None
        if pressure is not None:
            return self._busy(peer, ops, pressure, "over budget")
        self._publish()
        return Admission(self, peer, ops, nbytes)

    def _busy(self, peer: str, ops: int, pressure: float, reason: str) -> Busy:
        _SHED_WINDOWS.inc(peer=peer)
        _SHED_OPS.inc(ops, peer=peer)
        telemetry.event("sync.shed", peer=peer, ops=ops, reason=reason)
        return Busy(int(self.base_retry_after_ms * pressure), reason)

    def _publish(self) -> None:
        with self._lock:
            ops, nbytes = self._ops, self._bytes
        _ADMIT_OPS.set(ops)
        _ADMIT_BYTES.set(nbytes)

    def _shed_locked(self, ops: int) -> float:
        """Count a shed window; returns the pressure that scales the advised
        backoff, so a storm of shed peers does not re-dial in lockstep."""
        self._shed_windows += 1
        self._shed_ops += ops
        return max(1.0, self._ops / self.max_ops)

    def _release(self, peer: str, ops: int, nbytes: int) -> None:
        with self._lock:
            self._ops = max(0, self._ops - ops)
            self._bytes = max(0, self._bytes - nbytes)
            p_ops, p_bytes = self._per_peer.get(peer, (0, 0))
            p_ops, p_bytes = max(0, p_ops - ops), max(0, p_bytes - nbytes)
            if p_ops == 0 and p_bytes == 0:
                self._per_peer.pop(peer, None)
            else:
                self._per_peer[peer] = (p_ops, p_bytes)
        self._publish()

    def status(self) -> dict:
        """The budget as ``sync.fleetStatus`` reports it."""
        with self._lock:
            return {
                "budget_ops": self.max_ops,
                "budget_bytes": self.max_bytes,
                "ops_in_flight": self._ops,
                "bytes_in_flight": self._bytes,
                "peers_in_flight": len(self._per_peer),
                "shed_windows": self._shed_windows,
                "shed_ops": self._shed_ops,
            }


class DispatchBudget:
    """The node-wide bound on rspc dispatches in flight, keyed by tenant.
    Thread-safe; the router admits every dispatch but ``telemetry.*``
    through ``node.dispatch_budget``."""

    def __init__(self, max_inflight: int | None = None) -> None:
        if max_inflight is None:
            max_inflight = _env_int("SD_RSPC_BUDGET", DEFAULT_DISPATCH_INFLIGHT)
        self.max_inflight = max(1, int(max_inflight))
        self.base_retry_after_ms = _env_int("SD_RSPC_RETRY_AFTER_MS",
                                            BASE_DISPATCH_RETRY_AFTER_MS)
        self._lock = threading.Lock()
        self._inflight = 0
        #: tenant label -> dispatches in flight
        self._per_tenant: dict[str, int] = {}
        self._shed = 0
        _D_BUDGET.set(self.max_inflight)

    def try_admit(self, tenant: str) -> Admission | Busy:
        """Admit one dispatch for ``tenant`` or say when to come back."""
        try:
            faults.inject("rspc_admission", key=tenant)
        except Exception:
            with self._lock:
                pressure = self._shed_locked()
            return self._busy(tenant, pressure, "injected overload")
        with self._lock:
            t_inflight = self._per_tenant.get(tenant, 0)
            active = len(self._per_tenant) + (0 if tenant in self._per_tenant else 1)
            over_global = self._inflight + 1 > self.max_inflight
            # fairness floor: a tenant under its fair share with nothing in
            # flight is never shed
            fair = self.max_inflight // max(1, active)
            under_share = t_inflight + 1 <= max(fair, 1)
            if over_global and (not under_share or t_inflight > 0):
                pressure = self._shed_locked()
            else:
                self._inflight += 1
                self._per_tenant[tenant] = t_inflight + 1
                pressure = None
            inflight = self._inflight
        if pressure is not None:
            return self._busy(tenant, pressure, "over budget")
        _D_INFLIGHT.set(inflight)
        return Admission(self, tenant, 1, 0)

    def _busy(self, tenant: str, pressure: float, reason: str) -> Busy:
        _D_SHED.inc(tenant=tenant)
        telemetry.event("rspc.shed", tenant=tenant, reason=reason)
        return Busy(int(self.base_retry_after_ms * pressure), reason)

    def _shed_locked(self) -> float:
        self._shed += 1
        return max(1.0, self._inflight / self.max_inflight)

    def _release(self, tenant: str, ops: int, nbytes: int) -> None:
        # the shared Admission token's callback (it passes ops=1)
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            t_inflight = max(0, self._per_tenant.get(tenant, 0) - 1)
            if t_inflight == 0:
                self._per_tenant.pop(tenant, None)
            else:
                self._per_tenant[tenant] = t_inflight
            inflight = self._inflight
        _D_INFLIGHT.set(inflight)

    def status(self) -> dict:
        with self._lock:
            return {
                "budget_inflight": self.max_inflight,
                "in_flight": self._inflight,
                "tenants_in_flight": len(self._per_tenant),
                "shed": self._shed,
            }
