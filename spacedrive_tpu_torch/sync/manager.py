"""Sync manager: atomic operation emission and ordered operation serving.

A copy of ``spacedrive_tpu/sync/manager.py``, one per library
(``library.sync``):

- ``write_ops(ops, fn)`` runs the domain mutation and appends the CRDT ops
  to the op log in ONE SQLite transaction, then broadcasts
  ``SyncMessage.CREATED`` (and the ``sync.newMessage`` library event). When
  ``emit_messages`` is off the mutation runs bare, with no log rows: the
  node's ``syncEmitMessages`` feature flag sets it
  (:meth:`..library.Libraries._attach_services`). A ``log_ops`` that raises
  inside a write's transaction rolls the write back with it.
- ``get_ops(clocks, count)`` serves the operations newer than the caller's
  per-instance HLC clocks, both log tables merged in timestamp order.
- the factories (``shared_create`` and the rest) stamp (instance pub_id,
  HLC now, uuid); ``shared_create_many`` turns model rows into create
  operations, local foreign keys into ``ref`` markers.

:func:`emitter` is what every emit site asks: the library's manager when it
emits, else None.
"""

from __future__ import annotations

import logging
import threading
from typing import TYPE_CHECKING, Any, Callable

from ..models import Instance
from .crdt import (CREATE, DELETE, UPDATE_PREFIX, CRDTOperation, RelationOp,
                   SharedOp, new_op)
from .hlc import HLC

if TYPE_CHECKING:
    from ..library import Library

logger = logging.getLogger(__name__)


class SyncMessage:
    CREATED = "created"     # this instance logged new ops
    INGESTED = "ingested"   # remote ops were applied here


def emitter(library: "Library") -> "SyncManager | None":
    """The library's sync manager when it logs operations, else None."""
    sync = getattr(library, "sync", None)
    return sync if sync is not None and sync.emit_messages else None


class SyncManager:
    def __init__(self, library: "Library") -> None:
        self.library = library
        self.emit_messages = False  # BackendFeature.SYNC_EMIT_MESSAGES gates this
        self.clock = HLC(self._stored_clock_floor())
        self._subscribers: list[Callable[[str], None]] = []
        self._lock = threading.Lock()
        self._instance_ids: dict[str, int] = {}
        #: held by a pull round of :class:`.ingest.Actor` from its first
        #: pull to its last apply. The orphan remover takes it too, so it
        #: never sees an ingested object whose links are still in flight
        #: (a round may apply an object's create and its files' links in
        #: two sessions, or in a lane and the second wave)
        self.ingest_round = threading.Lock()

    # -- identity -----------------------------------------------------------
    @property
    def instance_pub_id(self) -> str:
        # memoized: the library's own instance pub_id is immutable, and the
        # ingest loop consults this once per op
        cached = self.__dict__.get("_own_pub_id")
        if cached is not None:
            return cached
        row = self.library.instance()
        if row is None:
            raise RuntimeError("library has no instance row")
        self.__dict__["_own_pub_id"] = row["pub_id"]
        return row["pub_id"]

    def _instance_db_id(self, pub_id: str) -> int:
        # memoized: log_ops resolves this per op and instance rows are
        # append-only (never re-keyed), so the mapping cannot go stale
        cached = self._instance_ids.get(pub_id)
        if cached is not None:
            return cached
        row = self.library.db.find_one(Instance, {"pub_id": pub_id})
        if row is None:
            raise RuntimeError(f"unknown instance {pub_id}")
        self._instance_ids[pub_id] = row["id"]
        return row["id"]

    def _stored_clock_floor(self) -> int:
        """Resume the HLC past everything already logged (restart safety)."""
        try:
            row = self.library.db.query(
                "SELECT max(m) AS m FROM (SELECT max(timestamp) m FROM shared_operation "
                "UNION ALL SELECT max(timestamp) m FROM relation_operation)")
            return row[0]["m"] or 0
        except Exception:
            return 0

    # -- subscriptions ------------------------------------------------------
    def subscribe(self, fn: Callable[[str], None]) -> None:
        """fn(SyncMessage.*) — NLM push-notify + UI sync.newMessage feed."""
        with self._lock:
            self._subscribers.append(fn)

    def _broadcast(self, message: str) -> None:
        with self._lock:
            subs = list(self._subscribers)
        for fn in subs:
            try:
                fn(message)
            except Exception:
                logger.exception("sync subscriber failed")
        self.library.emit("sync.newMessage", {"kind": message})

    # -- op factories (factory.rs) -----------------------------------------
    @staticmethod
    def _table(model: Any) -> str:
        return getattr(model, "TABLE", model)

    def shared_create(self, model: Any, record_id: Any,
                      fields: dict[str, Any] | None = None) -> CRDTOperation:
        return new_op(self.instance_pub_id, self.clock.now(),
                      SharedOp(self._table(model), record_id, CREATE, fields or {}))

    def shared_update(self, model: Any, record_id: Any, field: str,
                      value: Any) -> CRDTOperation:
        return new_op(self.instance_pub_id, self.clock.now(),
                      SharedOp(self._table(model), record_id, UPDATE_PREFIX + field, value))

    def shared_delete(self, model: Any, record_id: Any) -> CRDTOperation:
        return new_op(self.instance_pub_id, self.clock.now(),
                      SharedOp(self._table(model), record_id, DELETE, None))

    def relation_create(self, relation: Any, item_id: Any, group_id: Any,
                        fields: dict[str, Any] | None = None) -> CRDTOperation:
        return new_op(self.instance_pub_id, self.clock.now(),
                      RelationOp(self._table(relation), item_id, group_id,
                                 CREATE, fields or {}))

    def relation_update(self, relation: Any, item_id: Any, group_id: Any,
                        field: str, value: Any) -> CRDTOperation:
        return new_op(self.instance_pub_id, self.clock.now(),
                      RelationOp(self._table(relation), item_id, group_id,
                                 UPDATE_PREFIX + field, value))

    def relation_delete(self, relation: Any, item_id: Any, group_id: Any) -> CRDTOperation:
        return new_op(self.instance_pub_id, self.clock.now(),
                      RelationOp(self._table(relation), item_id, group_id, DELETE, None))

    def created(self) -> None:
        """Post-commit notification hook for call sites that logged ops inside
        their own transaction: the broadcast waits for the outermost COMMIT
        (``Database.after_commit``). A block joined to an outer transaction,
        as identify's page is to its commit group, is not durable when it
        ends, and a peer's pull on a CREATED sent then would miss its ops
        (the reference broadcasts at once: the last group of a scan is then
        never pushed until the library's next commit)."""
        self.library.db.after_commit(lambda: self._broadcast(SyncMessage.CREATED))

    def shared_create_many(self, model: Any, rows: list[dict[str, Any]],
                           log: bool = True) -> list[CRDTOperation]:
        """Bulk create-ops from model rows (the indexer save path). Local
        integer FKs to synced models are rewritten as ``ref`` markers via the
        target's sync id; local-only fields (id, SYNC_SKIP) are dropped;
        datetimes become ISO strings (wire is JSON-safe)."""
        import datetime as _dt

        from ..models import MODEL_REGISTRY
        from .crdt import ref

        spec = model.SYNC
        db = self.library.db
        ref_cache: dict[tuple[str, Any], Any] = {}
        skip = set(getattr(model, "SYNC_SKIP", ())) | {"id", spec.id}
        ops: list[CRDTOperation] = []
        for row in rows:
            fields: dict[str, Any] = {}
            for name, f in model.FIELDS.items():
                if name in skip or name not in row or row[name] is None:
                    continue
                v = row[name]
                if f.references:
                    table = f.references.split(".")[0]
                    target = MODEL_REGISTRY.get(table)
                    # FK crosses the wire as the target's sync id / pub_id
                    # (even @local models like instance have replicated
                    # pub_ids via pairing); targets without one are dropped
                    tkey = (target.SYNC.id if target is not None and target.SYNC
                            else "pub_id" if target is not None and "pub_id" in target.FIELDS
                            else None)
                    if target is None or tkey is None:
                        continue
                    key = (table, v)
                    if key not in ref_cache:
                        trow = db.find_one(target, {"id": v})
                        ref_cache[key] = trow[tkey] if trow else None
                    if ref_cache[key] is None:
                        continue
                    v = ref(table, ref_cache[key])
                if isinstance(v, _dt.datetime):
                    v = v.isoformat()
                fields[name] = v
            ops.append(self.shared_create(model, row[spec.id], fields))
        if log:
            self.log_ops(ops)
        return ops

    # -- write path ---------------------------------------------------------
    def write_ops(self, ops: list[CRDTOperation],
                  fn: Callable[[Any], Any] | None = None) -> Any:
        """Atomically run ``fn(db)`` and append ``ops`` to the op-log; no-op
        logging (mutation only) when emit_messages is off."""
        db = self.library.db
        result = None
        with db.transaction():
            if fn is not None:
                result = fn(db)
            if self.emit_messages and ops:
                self.log_ops(ops)
        if self.emit_messages and ops:
            self.created()
        return result

    def log_ops(self, ops: list[CRDTOperation]) -> None:
        import json as _json

        db = self.library.db
        shared_rows: list[tuple] = []
        relation_rows: list[tuple] = []
        for op in ops:
            inst = self._instance_db_id(op.instance)
            t = op.typ
            data = (None if t.data is None
                    else _json.dumps(t.data, sort_keys=True))
            if isinstance(t, SharedOp):
                shared_rows.append((op.id, op.timestamp, t.model,
                                    str(t.record_id), t.kind, data, inst))
            else:
                relation_rows.append((op.id, op.timestamp, t.relation,
                                      str(t.item_id), str(t.group_id),
                                      t.kind, data, inst))
        # one pre-encoded executemany per table: the ingest fast path logs
        # whole pull windows at once
        if shared_rows:
            db.executemany(
                "INSERT OR IGNORE INTO shared_operation "
                "(id, timestamp, model, record_id, kind, data, instance_id) "
                "VALUES (?, ?, ?, ?, ?, ?, ?)", shared_rows)
        if relation_rows:
            db.executemany(
                "INSERT OR IGNORE INTO relation_operation "
                "(id, timestamp, relation, item_id, group_id, kind, data, "
                "instance_id) VALUES (?, ?, ?, ?, ?, ?, ?, ?)", relation_rows)

    # -- read path ----------------------------------------------------------
    def timestamps(self) -> dict[str, int]:
        """Per-origin-instance applied-clock map (GetOpsArgs.clocks). For our
        own instance: everything we logged; for peers: instance.timestamp as
        persisted by ingest (ingest.rs:136-159)."""
        out: dict[str, int] = {}
        for row in self.library.db.find(Instance):
            if row["id"] == self.library.instance_id:
                out[row["pub_id"]] = self.clock.last
            else:
                out[row["pub_id"]] = row["timestamp"] or 0
        return out

    def require_watermark(self) -> dict[str, int]:
        """Per-publisher floors a replica must cover to serve THIS node's
        reads (the reference's replica tier reads it; the port's comes
        with the reader pool). Built from the op-LOG, not
        :meth:`timestamps`, for two reasons:

        - our own entry there is ``clock.last``, and the HLC merges
          forward on every ingested remote op — a node that mostly
          consumes runs its clock ahead of any op a peer could ever
          replicate, so the raw clock map reads as permanently
          uncoverable (NOT_ELIGIBLE forever) even at full convergence;
        - peer entries there are ``instance.timestamp``, which lane-mode
          ingest persists only at the dispatcher's deferred cross-lane
          merge — mid-window they UNDERSTATE what is already
          materialized, and an understated require admits stale pages.

        Ops are logged in the same transaction that materializes them, so
        ``max(timestamp)`` per origin instance over both log tables is
        exactly the applied floor — and exactly the sup of what a replica
        can pull from us, coupling eligibility to byte-equal state.
        ``instance.timestamp`` is max-merged in for floors whose log
        entries a future compaction might drop."""
        db = self.library.db
        out: dict[str, int] = {}
        id_to_pub: dict[Any, str] = {}
        for row in db.find(Instance):
            id_to_pub[row["id"]] = row["pub_id"]
            mine = row["id"] == self.library.instance_id
            out[row["pub_id"]] = 0 if mine else (row["timestamp"] or 0)
        for table in ("shared_operation", "relation_operation"):
            for r in db.query(
                    f"SELECT instance_id, max(timestamp) AS t FROM {table} "
                    "GROUP BY instance_id"):
                pub = id_to_pub.get(r["instance_id"])
                if pub is not None and (r["t"] or 0) > out.get(pub, 0):
                    out[pub] = r["t"]
        return out

    def ops_pending(self, clocks: dict[str, int] | None = None) -> int:
        """How many logged ops are strictly newer (per origin instance)
        than ``clocks`` — the sender-side backlog, from which a receiver
        reads its convergence lag without a second round trip. One COUNT
        per instance per table, each an indexed
        range SEARCH on (instance_id, timestamp) — a CASE-over-instance_id
        form would degrade to a full index scan of the whole op-log on
        every served window."""
        clocks = clocks or {}
        db = self.library.db
        total = 0
        for r in db.find(Instance):
            floor = clocks.get(r["pub_id"], 0)
            for table in ("shared_operation", "relation_operation"):
                total += db.query(
                    f"SELECT count(*) AS c FROM {table} "
                    "WHERE instance_id = ? AND timestamp > ?",
                    [r["id"], floor])[0]["c"]
        return total

    def get_ops(self, clocks: dict[str, int] | None = None,
                count: int = 100) -> tuple[list[dict[str, Any]], bool]:
        """Ops strictly newer (per origin instance) than ``clocks``, merged
        across both log tables in timestamp order. Returns (wire_ops,
        has_more).

        The per-instance floor, ordering, and LIMIT run in SQL (each table
        contributes at most count+1 rows per round), so a full sync is
        O(count log count) per round instead of loading the whole op-log.

        Relayed ops (origin != our instance) are served only up to the
        floor WE have durably persisted for their origin: lane-mode
        ingest commits each lane's shard before the dispatcher's
        cross-lane floor merge, so the raw log can briefly hold a later
        op from an origin while an earlier one is still in another
        lane's transaction — a puller that read past the merge point
        would advance its scalar clock over the hole and never fetch the
        backfilled op. Serial ingest persists floors in the same
        transaction that logs the window, so the cap is invisible there;
        our own authored ops are append-ordered and need no cap."""
        clocks = clocks or {}
        db = self.library.db
        inst_rows = db.find(Instance)
        inst_pub: dict[int, str] = {r["id"]: r["pub_id"] for r in inst_rows}

        # timestamp > (per-instance clock floor, 0 for unknown instances)
        case_parts: list[str] = []
        case_params: list[Any] = []
        cap_parts: list[str] = []
        cap_params: list[Any] = []
        for r in inst_rows:
            floor = clocks.get(r["pub_id"], 0)
            if floor:
                case_parts.append("WHEN ? THEN ?")
                case_params.extend([r["id"], floor])
            if r["id"] != self.library.instance_id:
                cap_parts.append("WHEN ? THEN ?")
                cap_params.extend([r["id"], r["timestamp"] or 0])
        floor_sql = (f"CASE instance_id {' '.join(case_parts)} ELSE 0 END"
                     if case_parts else "0")
        no_cap = (1 << 63) - 1
        cap_sql = (f"CASE instance_id {' '.join(cap_parts)} "
                   f"ELSE {no_cap} END" if cap_parts else str(no_cap))

        import json as _json

        def fetch(table: str) -> list:
            return db.query(
                f"SELECT * FROM {table} WHERE timestamp > {floor_sql} "
                f"AND timestamp <= {cap_sql} "
                f"ORDER BY timestamp, id LIMIT ?",
                case_params + cap_params + [count + 1])

        # wire dicts built straight from the rows (no dataclass round-trip:
        # this is the sender-side hot loop of big pull windows)
        def _data(v: Any) -> Any:
            return _json.loads(v) if isinstance(v, str) else v

        ops: list[dict[str, Any]] = []
        for r in fetch("shared_operation"):
            ops.append({
                "instance": inst_pub[r["instance_id"]],
                "timestamp": r["timestamp"], "id": r["id"],
                "typ": {"model": r["model"], "record_id": r["record_id"],
                        "kind": r["kind"], "data": _data(r["data"]),
                        "_t": "shared"}})
        for r in fetch("relation_operation"):
            ops.append({
                "instance": inst_pub[r["instance_id"]],
                "timestamp": r["timestamp"], "id": r["id"],
                "typ": {"relation": r["relation"], "item_id": r["item_id"],
                        "group_id": r["group_id"], "kind": r["kind"],
                        "data": _data(r["data"]), "_t": "relation"}})
        ops.sort(key=lambda o: (o["timestamp"], o["id"]))
        has_more = len(ops) > count
        return ops[:count], has_more
