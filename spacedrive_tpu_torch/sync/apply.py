"""Operation application, driven by the models' ``SYNC`` annotations.

A copy of ``spacedrive_tpu/sync/apply.py``: one generic applier covers every
synced model. Foreign-key fields arrive as ``ref(table, pub_id)`` markers
(:mod:`.crdt`) and resolve to local integer ids; a ref whose target row does
not exist yet resolves to None for a nullable field (it back-fills when a
later update rewrites the field) and raises for a required one. A create is
the rowcount upsert (``insert_ignore``, then ``update``); a create that
neither inserts nor updates was blocked by another record's unique key and
raises :class:`ApplyError`, so the op is logged without effect.
"""

from __future__ import annotations

import logging
from typing import Any

from ..models import MODEL_REGISTRY
from ..models.base import Database, Model, Relation, Shared
from .crdt import CREATE, DELETE, UPDATE_PREFIX, RelationOp, SharedOp, is_ref

logger = logging.getLogger(__name__)


class ApplyError(Exception):
    pass


def model_for(table: str) -> type[Model]:
    try:
        return MODEL_REGISTRY[table]
    except KeyError:
        raise ApplyError(f"unknown synced model {table!r}") from None


def resolve_value(db: Database, value: Any) -> Any:
    if not is_ref(value):
        return value
    table, pub_id = value["__ref__"]
    target = model_for(table)
    sync = target.SYNC
    key = sync.id if isinstance(sync, Shared) else "pub_id"
    # the id alone: no row to decode (one of these a foreign key an op)
    rows = db.query(f'SELECT id FROM {target.TABLE} WHERE "{key}" = ? LIMIT 1', [pub_id])
    return rows[0]["id"] if rows else None


def apply_shared(db: Database, op: SharedOp) -> None:
    model = model_for(op.model)
    sync = model.SYNC
    if not isinstance(sync, Shared):
        raise ApplyError(f"{op.model} is not a Shared model")
    where = {sync.id: op.record_id}

    if op.kind == CREATE:
        fields = {k: resolve_value(db, v) for k, v in (op.data or {}).items()}
        # rowcount-based upsert: one statement in the common (new record)
        # case instead of find_one + insert. OR IGNORE swallows conflicts on
        # ANY unique constraint, so when neither the insert nor the update
        # lands the create was blocked by a foreign unique (e.g. a local
        # file_path row with the same (location, path) but another pub_id) —
        # surface that as ApplyError so the op is logged without effect and
        # the divergence stays visible, as the plain-INSERT path did.
        if not db.insert_ignore(model, {**where, **fields}):
            updated = db.update(model, where, fields) if fields else None
            if updated == 0 or (updated is None
                                and db.find_one(model, where) is None):
                raise ApplyError(
                    f"create for {op.model} {op.record_id!r} blocked by a "
                    "unique constraint on another record")
    elif op.kind == DELETE:
        db.delete(model, where)
    elif op.kind.startswith(UPDATE_PREFIX):
        field = op.kind[len(UPDATE_PREFIX):]
        if field not in model.FIELDS:
            raise ApplyError(f"{op.model} has no field {field!r}")
        value = resolve_value(db, op.data)
        if db.update(model, where, {field: value}) == 0:
            # update for a record we never saw: materialize it (the reference
            # applies ops idempotently; order across instances isn't
            # guaranteed)
            if not db.insert_ignore(model, {**where, field: value}):
                raise ApplyError(
                    f"update for {op.model} {op.record_id!r} blocked by a "
                    "unique constraint on another record")
    else:
        raise ApplyError(f"unknown shared op kind {op.kind!r}")


def apply_relation(db: Database, op: RelationOp) -> None:
    model = model_for(op.relation)
    sync = model.SYNC
    if not isinstance(sync, Relation):
        raise ApplyError(f"{op.relation} is not a Relation model")

    item_model = model_for(sync.item)
    group_model = model_for(sync.group)
    item = db.find_one(item_model, {_shared_key(item_model): op.item_id})
    group = db.find_one(group_model, {_shared_key(group_model): op.group_id})
    if item is None or group is None:
        # link precedes its endpoints; the reference drops these too (the
        # endpoint's own Create op re-links via a later relation op replay)
        logger.warning("relation %s op %s: missing endpoint (item=%s group=%s)",
                       op.relation, op.kind, op.item_id, op.group_id)
        return
    where = {f"{sync.item}_id": item["id"], f"{sync.group}_id": group["id"]}

    if op.kind == CREATE:
        fields = {k: resolve_value(db, v) for k, v in (op.data or {}).items()}
        if db.find_one(model, where) is None:
            db.insert(model, {**where, **fields})
        elif fields:
            db.update(model, where, fields)
    elif op.kind == DELETE:
        db.delete(model, where)
    elif op.kind.startswith(UPDATE_PREFIX):
        field = op.kind[len(UPDATE_PREFIX):]
        db.upsert(model, where, {field: resolve_value(db, op.data)},
                  {field: resolve_value(db, op.data)})
    else:
        raise ApplyError(f"unknown relation op kind {op.kind!r}")


def _shared_key(model: type[Model]) -> str:
    return model.SYNC.id if isinstance(model.SYNC, Shared) else "pub_id"
