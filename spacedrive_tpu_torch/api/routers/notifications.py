"""notifications.* procedures (``spacedrive_tpu/api/routers/notifications.py``):
get, dismiss, dismissAll, the listen subscription and the test helpers."""

from __future__ import annotations

from ...notifications import (dismiss_all, dismiss_notification, emit_library_notification,
                              emit_node_notification, get_notifications)
from ._util import filtered_subscription


def mount(router) -> None:
    @router.query("notifications.get")
    def get(node, _arg):
        return get_notifications(node)

    @router.mutation("notifications.dismiss")
    def dismiss(node, arg):
        dismiss_notification(node, arg["source"], arg["id"], library_id=arg.get("library_id"))
        return None

    @router.mutation("notifications.dismissAll")
    def dismiss_all_(node, _arg):
        dismiss_all(node)
        return None

    @router.subscription("notifications.listen")
    def listen(node, _arg):
        return filtered_subscription(node, {"notification"})

    @router.mutation("notifications.test")
    def test(node, _arg):
        return emit_node_notification(node, {"title": "Test", "content": "Test notification"})

    @router.library_mutation("notifications.testLibrary")
    def test_library(node, library, _arg):
        return emit_library_notification(library, {"title": "Test", "content": "Library test"})
