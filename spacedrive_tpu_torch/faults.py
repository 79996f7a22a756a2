"""Deterministic fault injection at the port's seams.

A trimmed copy of ``spacedrive_tpu/faults/__init__.py`` and
``faults/spec.py``, cut to what the port's seams need: ``gather`` (the
per-file cas message read, :mod:`.objects.cas`) and ``chunk`` (the
per-file manifest payload read, :mod:`.objects.manifest`), both inside
their transient retry, so an injected ``eio`` is retried like a real one;
and ``thumbnail`` (before each thumbnail is written,
:mod:`.objects.media.thumbnail`), where an ``enospc`` rehearses a full
disk.

A plan is a ``;``-separated list of ``seam:kind[:trigger]`` rules, armed by
:func:`install` (never from the environment). The kinds are ``eio``
(``OSError(EIO)``) and ``enospc`` (``OSError(ENOSPC)``); the trigger is
absent (every hit) or ``once`` (the first hit). At most one rule fires per
hit, the first in spec order. ``inject`` is one module-global read when
nothing is armed.

An armed ``gather`` seam also routes a batch of the native gather through
the per-file Python path, where the seam is (:func:`seam_armed`).
"""

from __future__ import annotations

import errno
import threading
from dataclasses import dataclass


class FaultSpecError(ValueError):
    """A malformed spec, raised at :func:`install`, never at a seam."""


@dataclass
class FaultRule:
    seam: str
    kind: str
    once: bool = False
    fired: int = 0

    def should_fire(self) -> bool:
        """Caller holds the plan lock."""
        if self.once and self.fired:
            return False
        self.fired += 1
        return True


def _oserror(code: int, msg: str):
    return lambda key: OSError(code, f"{msg} [injected{': ' + key if key else ''}]")


KINDS = {"eio": _oserror(errno.EIO, "I/O error"),
         "enospc": _oserror(errno.ENOSPC, "no space left on device")}


class FaultPlan:
    """Parsed, armed rules; ``check()`` is the seam entry point."""

    def __init__(self, spec: str) -> None:
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
        if len(parts) == 3 and parts[2] != "once":
            raise FaultSpecError(f"rule {raw!r}: the trigger is absent or 'once'")
        return FaultRule(seam, kind, once=len(parts) == 3)

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
