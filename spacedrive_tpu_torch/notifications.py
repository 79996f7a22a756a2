"""Notifications: node-level (kept in the node config) and library-level
(``notification`` rows), pushed over the event bus as ``notification``.

Counterpart of ``spacedrive_tpu/notifications.py``: each notification gets
an id of its source (the next integer of the node's list, the row id of the
library's table); dismiss removes one, dismissAll clears them all; the
``notifications.listen`` subscription receives the pushes.
"""

from __future__ import annotations

import datetime as dt
from typing import TYPE_CHECKING, Any

from .models import Notification, utc_now

if TYPE_CHECKING:
    from .library import Library
    from .node import Node


def emit_node_notification(node: "Node", data: dict[str, Any],
                           expires_at: str | None = None) -> dict[str, Any]:
    notifications = list(node.config.get().get("notifications", []))
    next_id = max((n["id"] for n in notifications), default=0) + 1
    record = {"id": next_id, "data": data, "read": False, "expires_at": expires_at}
    notifications.append(record)
    node.config.write(notifications=notifications)
    node.emit("notification", {"source": "node", **record})
    return record


def emit_library_notification(library: "Library", data: dict[str, Any],
                              expires_at=None) -> dict[str, Any]:
    nid = library.db.insert(Notification, {"data": data, "read": False,
                                           "expires_at": expires_at})
    record = {"id": nid, "data": data, "read": False, "expires_at": expires_at}
    library.emit("notification", {"source": "library", "library_id": library.id, **record})
    return record


def get_notifications(node: "Node") -> list[dict[str, Any]]:
    """Every node and library notification that has not expired; each
    library's newest first."""
    out = [{"source": "node", **n} for n in node.config.get().get("notifications", [])]
    for library in node.libraries.list():
        for row in library.db.find(Notification, order_by="id DESC"):
            out.append({"source": "library", "library_id": library.id, **row})
    now = utc_now()
    return [n for n in out if not n.get("expires_at") or _as_dt(n["expires_at"]) > now]


def dismiss_notification(node: "Node", source: str, notification_id: int,
                         library_id: str | None = None) -> None:
    if source == "node":
        node.config.write(notifications=[
            n for n in node.config.get().get("notifications", [])
            if n["id"] != notification_id])
    else:
        node.libraries.get(library_id).db.delete(Notification, {"id": notification_id})


def dismiss_all(node: "Node") -> None:
    node.config.write(notifications=[])
    for library in node.libraries.list():
        library.db.execute("DELETE FROM notification")


def _as_dt(value):
    return dt.datetime.fromisoformat(value) if isinstance(value, str) else value
