"""Tags: CRUD and their assignment to objects (the ``tag_on_object`` link).

Counterpart of ``spacedrive_tpu/objects/tags.py``. Every mutation emits
the reference's ``invalidate_query`` event, and with sync emitting logs the
reference's CRDT operations (tags are the canonical Shared and Relation
models): a tag's create, its updated fields, its delete, and a link's
create or delete by the tag's and the object's pub_ids. The port logs them
in the transaction of the write (the reference logs them after it), and a
tag's create carries its ``date_modified`` too (the reference's leaves it
out, so a peer's row had none).
:data:`CATEGORIES` is the overview's seeded category list, which the
``categories.list`` procedure counts objects in.
"""

from __future__ import annotations

import uuid
from typing import TYPE_CHECKING, Any

from ..models import Object, Tag, TagOnObject, utc_now
from ..sync.manager import emitter

if TYPE_CHECKING:
    from ..library import Library

CATEGORIES = [
    "Recents", "Favorites", "Photos", "Videos", "Movies", "Music",
    "Documents", "Downloads", "Encrypted", "Projects", "Applications",
    "Archives", "Databases", "Games", "Books", "Contacts", "Trash",
]


def _iso(value: Any) -> Any:
    return value.isoformat() if hasattr(value, "isoformat") else value


def create_tag(library: "Library", name: str, color: str | None = None) -> dict[str, Any]:
    pub_id = str(uuid.uuid4())
    row = {"pub_id": pub_id, "name": name, "color": color,
           "date_created": utc_now(), "date_modified": utc_now()}
    sync = emitter(library)
    ops = [] if sync is None else [sync.shared_create(Tag, pub_id, {
        "name": name, "color": color, "date_created": _iso(row["date_created"]),
        "date_modified": _iso(row["date_modified"])})]
    library.sync.write_ops(ops, lambda db: db.insert(Tag, row))
    library.emit("invalidate_query", {"key": "tags.list"})
    return library.db.find_one(Tag, {"pub_id": pub_id})


def update_tag(library: "Library", tag_id: int, name: str | None = None,
               color: str | None = None) -> None:
    values: dict[str, Any] = {"date_modified": utc_now()}
    if name is not None:
        values["name"] = name
    if color is not None:
        values["color"] = color
    row = library.db.find_one(Tag, {"id": tag_id})
    sync = emitter(library)
    ops = [] if sync is None or row is None else [
        sync.shared_update(Tag, row["pub_id"], k, _iso(v)) for k, v in values.items()]
    library.sync.write_ops(ops, lambda db: db.update(Tag, {"id": tag_id}, values))
    library.emit("invalidate_query", {"key": "tags.list"})


def delete_tag(library: "Library", tag_id: int) -> None:
    row = library.db.find_one(Tag, {"id": tag_id})
    if row is None:
        return
    sync = emitter(library)
    ops = [] if sync is None else [sync.shared_delete(Tag, row["pub_id"])]

    def write(db) -> None:
        db.delete(TagOnObject, {"tag_id": tag_id})
        db.delete(Tag, {"id": tag_id})

    library.sync.write_ops(ops, write)
    library.emit("invalidate_query", {"key": "tags.list"})


def assign_tag(library: "Library", tag_id: int, object_ids: list[int],
               unassign: bool = False) -> None:
    """tags.assign: link (or unlink) a tag on objects; ids of objects that
    do not exist are skipped."""
    db = library.db
    tag = db.find_one(Tag, {"id": tag_id})
    if tag is None:
        raise ValueError(f"tag {tag_id} not found")
    sync = emitter(library)
    ops = []
    with db.transaction():
        for oid in object_ids:
            obj = db.find_one(Object, {"id": oid})
            if obj is None:
                continue
            if unassign:
                db.delete(TagOnObject, {"tag_id": tag_id, "object_id": oid})
                if sync is not None:
                    ops.append(sync.relation_delete(TagOnObject, tag["pub_id"], obj["pub_id"]))
            else:
                db.insert(TagOnObject, {"tag_id": tag_id, "object_id": oid}, or_ignore=True)
                if sync is not None:
                    ops.append(sync.relation_create(TagOnObject, tag["pub_id"], obj["pub_id"]))
        if ops:
            sync.log_ops(ops)
    if ops:
        sync.created()
    library.emit("invalidate_query", {"key": "tags.getForObject"})


def tags_for_object(library: "Library", object_id: int) -> list[dict[str, Any]]:
    return [Tag.decode_row(r) for r in library.db.query(
        "SELECT t.* FROM tag t JOIN tag_on_object j ON j.tag_id = t.id "
        "WHERE j.object_id = ? ORDER BY t.name", [object_id])]


def objects_for_tag(library: "Library", tag_id: int) -> list[dict[str, Any]]:
    return [Object.decode_row(r) for r in library.db.query(
        "SELECT o.* FROM object o JOIN tag_on_object j ON j.object_id = o.id "
        "WHERE j.tag_id = ? ORDER BY o.id", [tag_id])]
