"""CRDT operation types and their wire format.

A copy of ``spacedrive_tpu/sync/crdt.py``: per-record shared operations
(create, a per-field last-write-wins update, delete) and many-many relation
operations, each stamped with (instance pub_id, HLC timestamp, op uuid). The
wire format is plain JSON-safe dicts, the same as the JAX package's, so a
library of either package ingests the other's operations; the model layer's
``SYNC`` annotations drive their application (:mod:`.apply`).

Foreign keys never cross the wire as local integer ids: the factories emit
``ref(model, pub_id)`` markers that the applier resolves against the local
database.
"""

from __future__ import annotations

import dataclasses
import uuid
from typing import Any

# op kinds as stored in the op-log `kind` column
CREATE = "c"
DELETE = "d"
UPDATE_PREFIX = "u:"  # "u:<field>"


def ref(table: str, pub_id: Any) -> dict[str, Any]:
    """FK value marker: resolved to the local row id at apply time."""
    return {"__ref__": [table, pub_id]}


def is_ref(value: Any) -> bool:
    return isinstance(value, dict) and "__ref__" in value


@dataclasses.dataclass
class SharedOp:
    """Record-level op on a ``SYNC = Shared(id=...)`` model."""

    model: str               # table name
    record_id: Any           # the Shared.id field value (usually pub_id)
    kind: str                # CREATE | DELETE | "u:<field>"
    data: Any                # CREATE: {field: value}; UPDATE: value; DELETE: None


@dataclasses.dataclass
class RelationOp:
    """Link-table op on a ``SYNC = Relation(item, group)`` model."""

    relation: str            # link table name
    item_id: Any             # item-side pub_id
    group_id: Any            # group-side pub_id
    kind: str                # CREATE | DELETE | "u:<field>"
    data: Any


@dataclasses.dataclass
class CRDTOperation:
    instance: str            # origin instance pub_id
    timestamp: int           # HLC NTP64
    id: str                  # op uuid
    typ: SharedOp | RelationOp

    def to_wire(self) -> dict[str, Any]:
        # hand-rolled (not dataclasses.asdict): asdict deep-copies the data
        # payload and dominates the sender side of big pull windows; wire
        # dicts are treated as read-only by every consumer
        t = self.typ
        if isinstance(t, SharedOp):
            body = {"model": t.model, "record_id": t.record_id,
                    "kind": t.kind, "data": t.data, "_t": "shared"}
        else:
            body = {"relation": t.relation, "item_id": t.item_id,
                    "group_id": t.group_id, "kind": t.kind, "data": t.data,
                    "_t": "relation"}
        return {"instance": self.instance, "timestamp": self.timestamp,
                "id": self.id, "typ": body}

    @classmethod
    def from_wire(cls, wire: dict[str, Any]) -> "CRDTOperation":
        """Strict decode: ops arrive from remote peers, so every structural
        assumption the ingest path relies on (string ids, int timestamp,
        known tag, exact field set) is enforced here — a malformed op must
        fail *at decode*, where ingest can skip it, not deep inside a DB
        statement."""
        if not isinstance(wire, dict) or not isinstance(wire.get("typ"), dict):
            raise ValueError("op is not a tagged dict")
        body = dict(wire["typ"])
        tag = body.pop("_t", None)
        typ: SharedOp | RelationOp
        if tag == "shared":
            typ = SharedOp(**body)
            if not isinstance(typ.model, str):
                raise ValueError("shared op model must be a string")
        elif tag == "relation":
            typ = RelationOp(**body)
            if not isinstance(typ.relation, str):
                raise ValueError("relation op relation must be a string")
        else:
            raise ValueError(f"unknown op tag {tag!r}")
        if not isinstance(typ.kind, str) or not (
                typ.kind in (CREATE, DELETE) or typ.kind.startswith(UPDATE_PREFIX)):
            raise ValueError(f"unknown op kind {typ.kind!r}")
        op = cls(instance=wire["instance"], timestamp=wire["timestamp"],
                 id=wire["id"], typ=typ)
        if not isinstance(op.instance, str) or not isinstance(op.id, str) \
                or not isinstance(op.timestamp, int) \
                or isinstance(op.timestamp, bool):
            raise ValueError("op envelope fields have wrong types")
        return op


def new_op(instance: str, timestamp: int, typ: SharedOp | RelationOp) -> CRDTOperation:
    return CRDTOperation(instance=instance, timestamp=timestamp,
                         id=str(uuid.uuid4()), typ=typ)
