"""Deterministic fault injection at the port's seams.

A trimmed copy of ``spacedrive_tpu/faults/__init__.py`` and
``faults/spec.py``, cut to what the port's seams need: ``gather`` (the
per-file cas message read, :mod:`.objects.cas`) and ``chunk`` (the
per-file manifest payload read, :mod:`.objects.manifest`), both inside
their transient retry, so an injected ``eio`` is retried like a real one;
``thumbnail`` (before each thumbnail is written,
:mod:`.objects.media.thumbnail`), where an ``enospc`` rehearses a full
disk; ``hash`` (before each hash dispatch of the identify job,
:mod:`.objects.file_identifier`); ``commit`` (at the BEGIN and the
COMMIT of every outermost database transaction, :mod:`.models.base`);
``rspc`` (before each procedure the router resolves, :mod:`.api.router`);
``backup`` (before a backup's archive is built and before it is
written) and ``restore`` (before a restore renames the extracted files
over the live ones), :mod:`.backups`; ``sync_ingest`` (the ingest
budget's admission check, :mod:`.sync.admission`: any kind sheds the
window, ``overload`` is the canonical one), ``rspc_admission`` (the
dispatch budget's admission check, the same way), ``p2p_send`` (before
each outbound sync session, hash batch, delta transfer and replica query,
:mod:`.p2p`), ``serve_worker`` (inside a reader-pool worker, before it
serves a dispatch, :mod:`.server.pool`) and ``replica_serve`` (where a
replica serves a peer's query: inside the pool worker that serves it when
the node runs a pool, else in the node's process, :mod:`.server.replica`).

A plan is a ``;``-separated list of ``seam:kind[:trigger]`` rules, armed by
:func:`install`, never from the environment: a child process that a test or
``chip_smoke.py`` starts to be killed reads its plan from its arguments and
installs it; a reader pool hands the plan armed when it spawns a worker
to that worker (:func:`current_spec`). The kinds are ``eio``
(``OSError(EIO)``), ``enospc`` (``OSError(ENOSPC)``), ``overload``
(:class:`IngestOverloadError`), ``busy`` (:class:`PeerBusyError`, a shed
answer) and ``kill``, which SIGKILLs the process at the seam (no atexit, no
flush: what the OOM killer or a power cut does). The trigger
is absent (every hit), ``once`` (the first hit) or ``skipN`` (every hit
after the first N: ``commit:kill:skip3`` dies at the fourth transaction
seam hit). At most one rule fires per hit, the first in spec order.
``inject`` is one module-global read when nothing is armed. A rule that
fires counts in ``sd_faults_fired_total{seam,kind}`` and emits a
``fault.fired`` event; ``trace_export`` (before a trace's JSONL is written,
:mod:`.telemetry.spans`) is a seam too.

An armed ``gather`` seam also routes a batch of the native gather through
the per-file Python path, where the seam is (:func:`seam_armed`).
"""

from __future__ import annotations

import errno
import os
import signal
import threading
from dataclasses import dataclass

from . import telemetry

#: every fired rule is visible to operators: ``sd_faults_fired_total``
#: with a ``fault.fired`` flight-recorder event
_FIRED_TOTAL = telemetry.counter(
    "sd_faults_fired_total", "injected faults fired, per seam:kind",
    labels=("seam", "kind"))


class FaultSpecError(ValueError):
    """A malformed spec, raised at :func:`install`, never at a seam."""


class PeerBusyError(RuntimeError):
    """A peer shed our request with an explicit BUSY answer (admission
    control). The caller backs off ``retry_after_ms`` and resumes from its
    acknowledged watermark; BUSY never means a dead peer. Not a fault kind:
    only a peer's answer raises it."""

    sd_transient = True
    sd_busy = True

    def __init__(self, msg: str, retry_after_ms: int = 250) -> None:
        super().__init__(msg)
        self.retry_after_ms = retry_after_ms


class IngestOverloadError(RuntimeError):
    """Injected admission-budget exhaustion (kind ``overload``)."""

    sd_transient = True


@dataclass
class FaultRule:
    seam: str
    kind: str
    once: bool = False
    #: hits to let pass before the rule fires on every later one
    skip: int = 0
    fired: int = 0

    def should_fire(self) -> bool:
        """Caller holds the plan lock."""
        if self.once and self.fired:
            return False
        if self.skip > 0:
            self.skip -= 1
            return False
        self.fired += 1
        return True


def _oserror(code: int, msg: str):
    return lambda key: OSError(code, f"{msg} [injected{': ' + key if key else ''}]")


def _kill(key: str):
    os.kill(os.getpid(), signal.SIGKILL)
    threading.Event().wait(3600.0)  # never reached


def _raise(cls, msg: str):
    return lambda key: cls(f"{msg} [injected{': ' + key if key else ''}]")


KINDS = {"eio": _oserror(errno.EIO, "I/O error"),
         "enospc": _oserror(errno.ENOSPC, "no space left on device"),
         "overload": _raise(IngestOverloadError, "ingest overload"),
         "busy": _raise(PeerBusyError, "peer busy"),
         "kill": _kill}


class FaultPlan:
    """Parsed, armed rules; ``check()`` is the seam entry point."""

    def __init__(self, spec: str) -> None:
        self.spec = spec
        self._lock = threading.Lock()
        self._rules: dict[str, list[FaultRule]] = {}
        for raw in (p.strip() for p in spec.split(";")):
            if raw:
                rule = self._parse_rule(raw)
                self._rules.setdefault(rule.seam, []).append(rule)
        if not self._rules:
            raise FaultSpecError(f"empty fault spec {spec!r}")

    @staticmethod
    def _parse_rule(raw: str) -> FaultRule:
        parts = [p.strip() for p in raw.split(":")]
        if len(parts) not in (2, 3):
            raise FaultSpecError(f"rule {raw!r}: expected seam:kind[:trigger]")
        seam, kind = parts[0], parts[1]
        if kind not in KINDS:
            raise FaultSpecError(f"rule {raw!r}: unknown kind {kind!r} (known: "
                                 f"{', '.join(sorted(KINDS))})")
        if len(parts) == 2:
            return FaultRule(seam, kind)
        trigger = parts[2]
        if trigger == "once":
            return FaultRule(seam, kind, once=True)
        if trigger.startswith("skip") and trigger[4:].isdigit():
            return FaultRule(seam, kind, skip=int(trigger[4:]))
        raise FaultSpecError(f"rule {raw!r}: the trigger is absent, 'once' or 'skip<N>'")

    def has_seam(self, seam: str) -> bool:
        return seam in self._rules

    def check(self, seam: str, key: str = "") -> None:
        """Raise if an armed rule for ``seam`` fires on this hit."""
        rules = self._rules.get(seam)
        if not rules:
            return
        with self._lock:
            rule = next((r for r in rules if r.should_fire()), None)
        if rule is not None:
            _FIRED_TOTAL.inc(seam=rule.seam, kind=rule.kind)
            telemetry.event("fault.fired", seam=rule.seam, kind=rule.kind,
                            key=key)
            raise KINDS[rule.kind](key)

    def fired(self) -> dict[str, int]:
        """``{"seam:kind": hits}`` of the rules that fired."""
        with self._lock:
            return {f"{r.seam}:{r.kind}": r.fired
                    for rules in self._rules.values() for r in rules if r.fired}


_PLAN: FaultPlan | None = None


def install(spec: str) -> FaultPlan:
    """Arm a plan (tests)."""
    global _PLAN
    _PLAN = FaultPlan(spec)
    return _PLAN


def clear() -> None:
    global _PLAN
    _PLAN = None


def current_spec() -> str | None:
    """The armed plan's spec, or None: what a process this one starts
    installs to share its seams."""
    plan = _PLAN
    return plan.spec if plan is not None else None


def seam_armed(seam: str) -> bool:
    """True when the armed plan has rules for ``seam``."""
    plan = _PLAN
    return plan is not None and plan.has_seam(seam)


def inject(seam: str, key: str = "") -> None:
    """The seam: raise if an armed rule fires, else nothing."""
    plan = _PLAN
    if plan is not None:
        plan.check(seam, key)


def fired() -> dict[str, int]:
    plan = _PLAN
    return plan.fired() if plan is not None else {}
