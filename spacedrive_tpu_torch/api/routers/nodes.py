"""nodes.* procedures (``spacedrive_tpu/api/routers/nodes.py``): edit,
listLocations."""

from __future__ import annotations

from ...models import Location


def mount(router) -> None:
    @router.mutation("nodes.edit")
    def edit(node, arg):
        if arg.get("name"):
            node.config.write(name=arg["name"])
        return None

    @router.library_query("nodes.listLocations", pool=True, replica=False)
    def list_locations(node, library, _arg):
        return library.db.find(Location, order_by="name")
