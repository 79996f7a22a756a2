"""Tags: CRUD and their assignment to objects (the ``tag_on_object`` link).

Counterpart of ``spacedrive_tpu/objects/tags.py``. Every mutation emits
the reference's ``invalidate_query`` event; the CRDT operations it also
logs when sync is on are not ported (the port's libraries have no sync).
:data:`CATEGORIES` is the overview's seeded category list, which the
``categories.list`` procedure counts objects in.
"""

from __future__ import annotations

import uuid
from typing import TYPE_CHECKING, Any

from ..models import Object, Tag, TagOnObject, utc_now

if TYPE_CHECKING:
    from ..library import Library

CATEGORIES = [
    "Recents", "Favorites", "Photos", "Videos", "Movies", "Music",
    "Documents", "Downloads", "Encrypted", "Projects", "Applications",
    "Archives", "Databases", "Games", "Books", "Contacts", "Trash",
]


def create_tag(library: "Library", name: str, color: str | None = None) -> dict[str, Any]:
    pub_id = str(uuid.uuid4())
    library.db.insert(Tag, {"pub_id": pub_id, "name": name, "color": color,
                            "date_created": utc_now(), "date_modified": utc_now()})
    library.emit("invalidate_query", {"key": "tags.list"})
    return library.db.find_one(Tag, {"pub_id": pub_id})


def update_tag(library: "Library", tag_id: int, name: str | None = None,
               color: str | None = None) -> None:
    values: dict[str, Any] = {"date_modified": utc_now()}
    if name is not None:
        values["name"] = name
    if color is not None:
        values["color"] = color
    library.db.update(Tag, {"id": tag_id}, values)
    library.emit("invalidate_query", {"key": "tags.list"})


def delete_tag(library: "Library", tag_id: int) -> None:
    if library.db.find_one(Tag, {"id": tag_id}) is None:
        return
    library.db.delete(TagOnObject, {"tag_id": tag_id})
    library.db.delete(Tag, {"id": tag_id})
    library.emit("invalidate_query", {"key": "tags.list"})


def assign_tag(library: "Library", tag_id: int, object_ids: list[int],
               unassign: bool = False) -> None:
    """tags.assign: link (or unlink) a tag on objects; ids of objects that
    do not exist are skipped."""
    db = library.db
    if db.find_one(Tag, {"id": tag_id}) is None:
        raise ValueError(f"tag {tag_id} not found")
    for oid in object_ids:
        if db.find_one(Object, {"id": oid}) is None:
            continue
        if unassign:
            db.delete(TagOnObject, {"tag_id": tag_id, "object_id": oid})
        else:
            db.insert(TagOnObject, {"tag_id": tag_id, "object_id": oid}, or_ignore=True)
    library.emit("invalidate_query", {"key": "tags.getForObject"})


def tags_for_object(library: "Library", object_id: int) -> list[dict[str, Any]]:
    return [Tag.decode_row(r) for r in library.db.query(
        "SELECT t.* FROM tag t JOIN tag_on_object j ON j.tag_id = t.id "
        "WHERE j.object_id = ? ORDER BY t.name", [object_id])]


def objects_for_tag(library: "Library", tag_id: int) -> list[dict[str, Any]]:
    return [Object.decode_row(r) for r in library.db.query(
        "SELECT o.* FROM object o JOIN tag_on_object j ON j.object_id = o.id "
        "WHERE j.tag_id = ? ORDER BY o.id", [tag_id])]
