"""libraries.* procedures (``spacedrive_tpu/api/routers/libraries.py``):
list (with each library's own instance id and pub_id), statistics,
create, edit, delete."""

from __future__ import annotations

from ...statistics import compute_statistics
from ..invalidate import invalidate_query


def mount(router) -> None:
    @router.query("libraries.list")
    def list_libraries(node, _arg):
        return [{"id": lib.id, "name": lib.name, "description": lib.description,
                 "instance_id": lib.instance_id,
                 "instance_pub_id": (lib.instance() or {}).get("pub_id")}
                for lib in node.libraries.list()]

    @router.library_query("libraries.statistics", pool=True, replica=False)
    def statistics(node, library, _arg):
        """Recomputed on query; a pure read over the library database and
        the node's data dir. ``replica=False``: the disk figures are this
        node's, so a peer's replica never answers it."""
        row = dict(compute_statistics(library.db, node.data_dir))
        row.pop("date_captured", None)
        return row

    @router.mutation("libraries.create")
    def create(node, arg):
        lib = node.libraries.create(arg["name"], arg.get("description", ""))
        invalidate_query(lib, "libraries.list")
        return {"id": lib.id, "name": lib.name}

    @router.mutation("libraries.edit")
    def edit(node, arg):
        node.libraries.edit(arg["id"], name=arg.get("name"),
                            description=arg.get("description"))
        return None

    @router.mutation("libraries.delete")
    def delete(node, library_id: str):
        node.libraries.delete(library_id)
        return None
