"""sync.* procedures (``spacedrive_tpu/api/routers/sync.py``): the raw op
log feed, the ``sync.newMessage`` subscription and the node's ingest
status."""

from __future__ import annotations

from ._util import filtered_subscription


def mount(router) -> None:
    @router.library_query("sync.messages")
    def messages(node, library, arg):
        """Raw op-log feed for the sync debug page."""
        arg = arg or {}
        ops, has_more = library.sync.get_ops(arg.get("clocks"), int(arg.get("count", 100)))
        return {"ops": ops, "has_more": has_more}

    @router.library_subscription("sync.newMessage")
    def new_message(node, library, _arg):
        return filtered_subscription(node, {"sync.newMessage"}, library.id)

    @router.query("sync.fleetStatus")
    def fleet_status(node, _arg):
        """The node-wide ingest admission budget and, per loaded library,
        its ingest-lane pool when one is active."""
        libraries = {}
        for library in node.libraries.list():
            pool = library.__dict__.get("_ingest_lanes")
            if pool is not None:
                libraries[library.id] = pool.status()
        return {"budget": node.ingest_budget.status(), "libraries": libraries}
