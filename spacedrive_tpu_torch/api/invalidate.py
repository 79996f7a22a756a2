"""Invalidation-key registry and mount-time validation.

Counterpart of ``spacedrive_tpu/api/invalidate.py``: domain code calls
:func:`invalidate_query` (or emits the raw event and lists its key in
``USED_KEYS``), and :func:`validate` checks at mount that every such key
names a registered query. ``USED_KEYS`` is the reference's set.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

if TYPE_CHECKING:
    from ..library import Library
    from .router import Router

#: keys emitted by raw ``library.emit("invalidate_query", ...)`` calls
USED_KEYS: set[str] = {
    "search.paths",
    "search.objects",
    "locations.list",
    "tags.list",
    "tags.getForObject",
    "preferences.get",
    "jobs.reports",
    "notifications.get",
    "libraries.list",
    "search.duplicates",
}

_RUNTIME_KEYS: set[str] = set()


def invalidate_query(library: "Library", key: str, arg: Any = None) -> None:
    """Emit an invalidation event; records the key for mount validation."""
    _RUNTIME_KEYS.add(key)
    library.emit("invalidate_query", {"key": key, "arg": arg})


class InvalidationError(Exception):
    pass


def validate(router: "Router") -> None:
    """Every declared or used invalidation key must name a registered
    query."""
    from .router import QUERY

    queries = {p.key for p in router.procedures.values() if p.kind == QUERY}
    bad = sorted(k for k in (USED_KEYS | _RUNTIME_KEYS) if k not in queries)
    if bad:
        raise InvalidationError(f"invalidation keys with no matching query procedure: {bad}")
