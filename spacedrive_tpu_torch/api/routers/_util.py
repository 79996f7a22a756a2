"""Shared helpers of the router modules (``spacedrive_tpu/api/routers/_util.py``)."""

from __future__ import annotations

from typing import Any, Callable


def filtered_subscription(node, kinds: set[str], library_id: str | None = None,
                          predicate: Callable[[Any], bool] | None = None):
    """A bus subscription with a filter the transports apply before they
    forward an event: its kind among ``kinds``, its library ``library_id``
    (or none), and ``predicate``."""
    sub = node.events.subscribe()

    def _filter(ev) -> bool:
        if kinds and ev.kind not in kinds:
            return False
        if library_id is not None and ev.library_id not in (None, library_id):
            return False
        return predicate(ev) if predicate else True

    sub.filter = _filter
    return sub
