"""Core event bus (trimmed).

Counterpart of ``spacedrive_tpu/events.py`` (``CoreEvent`` :23,
``Subscription`` :38, ``EventBus`` :88-127): typed events fanned out to
synchronous in-process hooks and to bounded subscriber queues. The search
engine hooks it to bump its freshness watermark (a hook runs on the
emitting thread, before any queue is fed); jobs emit ``db.commit`` when
they end. The API subscriptions (``jobs.progress``,
``invalidation.listen``, ...) read :class:`Subscription` queues: a slow
subscriber drops its oldest events rather than block the emitter.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
from typing import Any, Callable, Iterator

logger = logging.getLogger(__name__)

#: events a subscriber's queue holds before it drops its oldest
SUBSCRIBER_CAPACITY = 1024


@dataclasses.dataclass(frozen=True)
class CoreEvent:
    """A broadcast event: ``kind`` names it (``db.commit``, ...),
    ``library_id`` scopes it."""

    kind: str
    payload: Any = None
    library_id: str | None = None


class Subscription:
    """One subscriber's bounded queue. Iterate to receive; ``close()`` to
    drop it (an iterator blocked on it then ends)."""

    def __init__(self, bus: "EventBus", capacity: int) -> None:
        self._bus = bus
        self._q: queue.Queue[CoreEvent | None] = queue.Queue(maxsize=capacity)
        self.closed = False
        #: set by ``api.routers._util.filtered_subscription``: transports
        #: forward only the events it accepts
        self.filter: Callable[[CoreEvent], bool] | None = None

    def _offer(self, event: CoreEvent) -> None:
        while True:
            try:
                self._q.put_nowait(event)
                return
            except queue.Full:
                try:  # lossy: drop the oldest
                    self._q.get_nowait()
                except queue.Empty:
                    pass

    def get(self, timeout: float | None = None) -> CoreEvent | None:
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def __iter__(self) -> Iterator[CoreEvent]:
        while not self.closed:
            event = self._q.get()
            if event is None:
                return
            yield event

    def close(self) -> None:
        self.closed = True
        self._bus._unsubscribe(self)
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass


class EventBus:
    """Multi-producer fan-out to synchronous hooks and lossy bounded
    subscriber queues."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._subs: list[Subscription] = []
        self._hooks: list[Callable[[CoreEvent], None]] = []

    def subscribe(self) -> Subscription:
        sub = Subscription(self, SUBSCRIBER_CAPACITY)
        with self._lock:
            self._subs.append(sub)
        return sub

    def _unsubscribe(self, sub: Subscription) -> None:
        with self._lock:
            if sub in self._subs:
                self._subs.remove(sub)

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
            subs = list(self._subs)
            hooks = list(self._hooks)
        for hook in hooks:
            try:
                hook(event)
            except Exception:  # a broken listener must never stall the emitter
                logger.exception("event hook failed for %s", event.kind)
        for sub in subs:
            sub._offer(event)

    def emit_kind(self, kind: str, payload: Any = None, library_id: str | None = None) -> None:
        self.emit(CoreEvent(kind=kind, payload=payload, library_id=library_id))
