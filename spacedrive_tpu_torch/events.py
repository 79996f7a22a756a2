"""Core event bus (trimmed).

Counterpart of ``spacedrive_tpu/events.py`` (``CoreEvent`` :23,
``EventBus.on`` / ``off`` / ``emit`` / ``emit_kind`` :99-126): typed events
fanned out to synchronous in-process hooks. The search engine hooks it to
bump its freshness watermark on ``db.commit``; jobs emit ``db.commit`` when
they end. The subscriber queues (API subscriptions) are not ported.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Any, Callable

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class CoreEvent:
    """A broadcast event: ``kind`` names it (``db.commit``, ...),
    ``library_id`` scopes it."""

    kind: str
    payload: Any = None
    library_id: str | None = None


class EventBus:
    """Multi-producer fan-out to synchronous hooks."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._hooks: list[Callable[[CoreEvent], None]] = []

    def on(self, hook: Callable[[CoreEvent], None]) -> None:
        """Register a hook; it runs on the emitting thread."""
        with self._lock:
            self._hooks.append(hook)

    def off(self, hook: Callable[[CoreEvent], None]) -> None:
        """Remove a hook registered with :meth:`on`."""
        with self._lock:
            try:
                self._hooks.remove(hook)
            except ValueError:
                pass

    def emit(self, event: CoreEvent) -> None:
        with self._lock:
            hooks = list(self._hooks)
        for hook in hooks:
            try:
                hook(event)
            except Exception:  # a broken listener must never stall the emitter
                logger.exception("event hook failed for %s", event.kind)

    def emit_kind(self, kind: str, payload: Any = None, library_id: str | None = None) -> None:
        self.emit(CoreEvent(kind=kind, payload=payload, library_id=library_id))
