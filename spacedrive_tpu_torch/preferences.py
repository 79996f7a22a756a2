"""Library preferences: a nested tree kept as dotted-key ``preference`` rows.

Counterpart of ``spacedrive_tpu/preferences.py``: a partial update touches
only the keys it names, a ``None`` leaf deletes its key. Preference rows
sync by their key (``SYNC = Shared(id="key")``): with sync emitting, an
update logs each key's value update or delete in its transaction.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

from .models import Preference
from .sync.manager import emitter

if TYPE_CHECKING:
    from .library import Library


def _flatten(tree: dict[str, Any], prefix: str = "") -> dict[str, Any]:
    out: dict[str, Any] = {}
    for key, value in tree.items():
        if "." in key:
            raise ValueError(f"preference keys may not contain dots: {key!r}")
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(value, dict) and value and all(isinstance(k, str) for k in value):
            out.update(_flatten(value, path))
        else:
            out[path] = value
    return out


def _unflatten(rows: dict[str, Any]) -> dict[str, Any]:
    tree: dict[str, Any] = {}
    for path, value in rows.items():
        node = tree
        parts = path.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
            if not isinstance(node, dict):
                break
        else:
            node[parts[-1]] = value
    return tree


def update_preferences(library: "Library", tree: dict[str, Any]) -> None:
    """Merge a (partial) preference tree; ``None`` leaves delete keys."""
    flat = _flatten(tree)
    db = library.db
    sync = emitter(library)
    ops = []
    with db.transaction():
        for key, value in flat.items():
            if value is None:
                db.delete(Preference, {"key": key})
                if sync is not None:
                    ops.append(sync.shared_delete(Preference, key))
            else:
                db.upsert(Preference, {"key": key}, {"value": value}, {"value": value})
                if sync is not None:
                    ops.append(sync.shared_update(Preference, key, "value", value))
        if ops:
            sync.log_ops(ops)
    if ops:
        sync.created()
    library.emit("invalidate_query", {"key": "preferences.get"})


def get_preferences(library: "Library") -> dict[str, Any]:
    return _unflatten({r["key"]: r["value"] for r in library.db.find(Preference)})
