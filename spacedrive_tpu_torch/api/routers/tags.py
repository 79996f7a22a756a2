"""tags.* procedures (``spacedrive_tpu/api/routers/tags.py``): list, get,
getForObject, getWithObjects, create, assign, update, delete."""

from __future__ import annotations

from ...models import Tag
from ...objects.tags import (assign_tag, create_tag, delete_tag, objects_for_tag,
                             tags_for_object, update_tag)
from ..router import ApiError


def mount(router) -> None:
    @router.library_query("tags.list", pool=True, replica=False)
    def list_tags(node, library, _arg):
        return library.db.find(Tag, order_by="name")

    @router.library_query("tags.get", pool=True, replica=False)
    def get(node, library, tag_id: int):
        row = library.db.find_one(Tag, {"id": tag_id})
        if row is None:
            raise ApiError("tag not found", code=404)
        return row

    @router.library_query("tags.getForObject", pool=True, replica=False)
    def get_for_object(node, library, object_id: int):
        return tags_for_object(library, object_id)

    @router.library_query("tags.getWithObjects", pool=True, replica=False)
    def get_with_objects(node, library, tag_id: int):
        return {"tag": library.db.find_one(Tag, {"id": tag_id}),
                "objects": objects_for_tag(library, tag_id)}

    @router.library_mutation("tags.create")
    def create(node, library, arg):
        return create_tag(library, arg["name"], arg.get("color"))

    @router.library_mutation("tags.assign")
    def assign(node, library, arg):
        assign_tag(library, arg["tag_id"], arg["object_ids"],
                   unassign=arg.get("unassign", False))
        return None

    @router.library_mutation("tags.update")
    def update(node, library, arg):
        update_tag(library, arg["id"], name=arg.get("name"), color=arg.get("color"))
        return None

    @router.library_mutation("tags.delete")
    def delete(node, library, tag_id: int):
        delete_tag(library, tag_id)
        return None
