"""Declarative SQLite model layer (trimmed).

Counterpart of ``spacedrive_tpu/models/base.py``: models declare their
fields once, and the declaration drives the CREATE TABLE DDL and value
encoding. The port keeps the single-writer ``Database`` with the row API the
scan uses (``query``, ``find``/``find_one``, ``insert``, ``insert_many``,
``update``, ``executemany``, ``delete``, ``transaction``), the row-change
journal the search engine refreshes from (:class:`RowJournal`, attached with
:meth:`Database.attach_row_journal`) and the WAL reader connection
(``models/base.py`` :361-367, ``_reader`` :479-497, ``query`` :499-545): a
``query`` from the thread that owns the open transaction runs on the writer
and sees its own uncommitted rows; every other thread reads the last
committed snapshot through a ``PRAGMA query_only=ON`` reader with its own
lock, so the scan pipeline's prefetch never waits behind a group commit.

The sync annotations are the reference's (:79-110): a model's ``SYNC`` is
``None`` (local only), :class:`Shared` (record-level last-write-wins
replication keyed by a sync id) or :class:`Relation` (a many-many link
replicated by its two endpoints), and ``SYNC_SKIP`` names the fields that
never cross the wire; every model registers in :data:`MODEL_REGISTRY` by
table, which the CRDT applier (:mod:`..sync.apply`) resolves op targets
through. The applier writes through :meth:`Database.insert_ignore` and the
rowcount of :meth:`Database.update`, both of which note their rows in the
journal, so the search engine sees ingested rows. The transaction's busy
retry is not ported; the ``commit`` fault seam is (:class:`_Txn`).

``Database(path, models, readonly=True)`` is the reader pool's per-process
bootstrap (reference :316-330): one connection opened ``mode=ro`` with
``PRAGMA query_only=ON``, no writer, no DDL (the node's process owns the
schema), every SELECT a fresh WAL snapshot; ``execute``, ``executemany``
and ``transaction`` raise on it (reference :442, :467, :550).

Telemetry (reference :499-545): a read that finds the reader's lock held
observes its wait in ``sd_db_reader_wait_seconds``, and under a request
trace that asks for them (``record_db_spans``, set by
:func:`..telemetry.requests.observed`) every read off the reader is a
``db.query`` span, so a slow request's tree shows its SQL.
:meth:`Database.snapshot` runs several SELECTs in one read transaction,
one committed snapshot for all of them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime as _dt
import json
import re
import sqlite3
import threading
import time
import urllib.parse
from pathlib import Path
from typing import Any, Callable, ClassVar, Iterable

from .. import faults, telemetry
from ..telemetry import spans as _tspans

#: reader contention, observed only for a contended acquisition (the
#: uncontended path pays one non-blocking try-acquire)
_READER_WAIT = telemetry.histogram(
    "sd_db_reader_wait_seconds",
    "time reads spent waiting for the WAL reader connection lock "
    "(contended acquisitions only — reader/writer contention under "
    "serving load)")


@dataclasses.dataclass(frozen=True)
class Field:
    type: str  # INTEGER | TEXT | REAL | BOOLEAN | DATETIME | JSON | BYTES
    primary_key: bool = False
    nullable: bool = True
    unique: bool = False
    default: Any = None
    references: str | None = None  # "table.column"
    on_delete: str = "CASCADE"
    autoincrement: bool = False

    SQL_TYPES: ClassVar[dict[str, str]] = {
        "INTEGER": "INTEGER",
        "TEXT": "TEXT",
        "REAL": "REAL",
        "BYTES": "BLOB",
        "BOOLEAN": "INTEGER",
        "DATETIME": "TEXT",
        "JSON": "TEXT",
    }


@dataclasses.dataclass(frozen=True)
class Shared:
    """Record-level last-write-wins replication (``/// @shared(id: ...)``)."""

    id: str = "pub_id"


@dataclasses.dataclass(frozen=True)
class Relation:
    """Many-many link replication (``/// @relation(item, group)``)."""

    item: str
    group: str


MODEL_REGISTRY: dict[str, type["Model"]] = {}


class Model:
    """Base class. Subclasses set TABLE, FIELDS, optional UNIQUES/INDEXES/SYNC."""

    TABLE: ClassVar[str]
    FIELDS: ClassVar[dict[str, Field]]
    UNIQUES: ClassVar[tuple[tuple[str, ...], ...]] = ()
    INDEXES: ClassVar[tuple[tuple[str, ...], ...]] = ()
    SYNC: ClassVar[Shared | Relation | None] = None
    #: fields never replicated, even on shared models (local ids)
    SYNC_SKIP: ClassVar[tuple[str, ...]] = ("id",)

    def __init_subclass__(cls, **kw: Any) -> None:
        super().__init_subclass__(**kw)
        if hasattr(cls, "TABLE"):
            MODEL_REGISTRY[cls.TABLE] = cls

    @classmethod
    def ddl(cls) -> list[str]:
        cols = []
        for name, f in cls.FIELDS.items():
            parts = [f'"{name}"', Field.SQL_TYPES[f.type]]
            if f.primary_key:
                parts.append("PRIMARY KEY")
                if f.autoincrement:
                    parts.append("AUTOINCREMENT")
            if not f.nullable and not f.primary_key:
                parts.append("NOT NULL")
            if f.unique:
                parts.append("UNIQUE")
            if f.default is not None:
                parts.append(f"DEFAULT {json.dumps(f.default)}")
            if f.references:
                table, col = f.references.split(".")
                parts.append(f"REFERENCES {table}({col}) ON DELETE {f.on_delete}")
            cols.append(" ".join(parts))
        for unique in cls.UNIQUES:
            cols.append("UNIQUE (" + ", ".join(f'"{c}"' for c in unique) + ")")
        stmts = [f"CREATE TABLE IF NOT EXISTS {cls.TABLE} ({', '.join(cols)})"]
        for idx in cls.INDEXES:
            # an entry with a space carries SQL modifiers and passes unquoted
            quoted = ", ".join(f'"{c}"' if " " not in c else c for c in idx)
            name = "_".join("_".join(c.lower().split()) for c in idx)
            stmts.append(f"CREATE INDEX IF NOT EXISTS idx_{cls.TABLE}_{name} "
                         f"ON {cls.TABLE} ({quoted})")
        return stmts

    @classmethod
    def encode(cls, name: str, value: Any) -> Any:
        f = cls.FIELDS[name]
        if value is None:
            return None
        if f.type == "BOOLEAN":
            return int(bool(value))
        if f.type == "DATETIME" and isinstance(value, _dt.datetime):
            return value.astimezone(_dt.timezone.utc).isoformat()
        if f.type == "JSON":
            return json.dumps(value, sort_keys=True)
        return value

    @classmethod
    def decode(cls, name: str, value: Any) -> Any:
        f = cls.FIELDS.get(name)
        if value is None or f is None:
            return value
        if f.type == "BOOLEAN":
            return bool(value)
        if f.type == "DATETIME":
            return _dt.datetime.fromisoformat(value) if isinstance(value, str) else value
        if f.type == "JSON":
            return json.loads(value) if isinstance(value, str) else value
        return value

    @classmethod
    def decode_row(cls, row: sqlite3.Row) -> dict[str, Any]:
        return {k: cls.decode(k, row[k]) for k in row.keys()}


def utc_now() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


# --------------------------------------------------------------------------
# row-change journal (the search engine's incremental-refresh feed)
# --------------------------------------------------------------------------


class RowJournal:
    """Per-table changed-row accounting on a Database (counterpart of
    ``spacedrive_tpu/models/base.py`` :202).

    The search engine (``search/engine.py``) refreshes its columnar index
    incrementally: appends ride an ``id > max_id`` scan, everything else
    needs to know WHICH rows changed. Every model-helper write (insert /
    update / delete) notes the touched row's ``id`` or ``pub_id`` here; raw
    SQL writes that bypass the helpers are caught by a table-name sniff in
    :meth:`Database.execute` / :meth:`Database.executemany` and degrade that
    table to a **flood** (the consumer does a full rebuild) — over-noting is
    always safe, silent under-noting would serve stale rows.

    Notes made inside an open transaction are buffered per thread and
    published when the outermost transaction closes: the consumer reads the
    last COMMITTED state, so a note must never be drainable before its rows
    are visible (a drained-then-invisible note would be lost to the next
    refresh). Publishing on rollback too is deliberate — a re-select of an
    unchanged row is idempotent.

    Bounded: past ``CAP`` noted rows per table the journal floods that table
    instead of growing.
    """

    CAP = 8192
    _WRITE_VERB = re.compile(r"^\s*(insert|update|delete|replace)\b", re.I)

    def __init__(self, tables: Iterable[str],
                 flood_on_delete: Iterable[str] = ()) -> None:
        self.tables = frozenset(tables)
        #: tables whose DELETEs flood instead of noting the row: an FK
        #: cascade (``ON DELETE SET NULL`` on file_path.object_id) mutates
        #: OTHER tracked rows the statement never names
        self.flood_on_delete = frozenset(flood_on_delete)
        self._lock = threading.Lock()
        self._ids: dict[str, set[int]] = {t: set() for t in self.tables}
        self._pub_ids: dict[str, set[str]] = {t: set() for t in self.tables}
        self._flood: set[str] = set()
        #: thread ident -> notes buffered inside that thread's open txn
        self._pending: dict[int, list[tuple[str, str, Any]]] = {}

    def _apply_locked(self, table: str, key: str, value: Any) -> None:
        if key == "flood" or value is None:
            self._flood.add(table)
        elif key == "id":
            bucket = self._ids[table]
            bucket.add(int(value))
            if len(bucket) > self.CAP:
                self._flood.add(table)
        elif key == "pub_id":
            bucket = self._pub_ids[table]
            bucket.add(str(value))
            if len(bucket) > self.CAP:
                self._flood.add(table)

    def publish_one(self, table: str, key: str, value: Any) -> None:
        with self._lock:
            self._apply_locked(table, key, value)

    def buffer(self, ident: int, table: str, key: str, value: Any) -> None:
        with self._lock:
            self._pending.setdefault(ident, []).append((table, key, value))

    def publish_thread(self, ident: int) -> None:
        """Outermost-transaction close: the thread's buffered notes become
        drainable (the rows are now committed — or rolled back, which a
        re-select absorbs)."""
        with self._lock:
            for table, key, value in self._pending.pop(ident, ()):
                self._apply_locked(table, key, value)

    def sniff(self, sql: str) -> str | None:
        """Raw-write detection: the tracked table a bypassing write names,
        or None."""
        if not self._WRITE_VERB.match(sql):
            return None
        head = sql[:256].lower()
        for table in self.tables:
            if re.search(rf"\b{table}\b", head):
                return table
        return None

    def drain(self) -> dict[str, Any]:
        """Atomically take the published notes (buffered ones stay)."""
        with self._lock:
            out = {
                "ids": {t: s for t, s in self._ids.items() if s},
                "pub_ids": {t: s for t, s in self._pub_ids.items() if s},
                "flood": set(self._flood),
            }
            self._ids = {t: set() for t in self.tables}
            self._pub_ids = {t: set() for t in self.tables}
            self._flood = set()
        return out


class Database:
    """One SQLite library database: one writer connection behind one lock
    (SQLite's WAL single-writer discipline, as in the JAX package), and a
    lazily opened read-only connection for the threads that do not own the
    open transaction."""

    def __init__(self, path: str | Path, models: Iterable[type[Model]],
                 readonly: bool = False) -> None:
        self.path = str(path)
        self.readonly = readonly
        if readonly:
            self.models = list(models)
            self._lock = threading.RLock()
            self._txn_depth = 0
            self._txn_thread = None
            self._after_commit = []
            self._journal = None
            self._conn = sqlite3.connect(
                f"file:{urllib.parse.quote(self.path)}?mode=ro", uri=True,
                check_same_thread=False)
            self._conn.row_factory = sqlite3.Row
            # a write attempt raises instead of contending the node's writer
            self._conn.execute("PRAGMA query_only=ON")
            self._read_conn = self._conn
            self._read_lock = threading.Lock()
            self._closed = False
            return
        if self.path != ":memory:":
            Path(self.path).parent.mkdir(parents=True, exist_ok=True)
        self.models = list(models)
        self._lock = threading.RLock()
        self._txn_depth = 0
        #: thread that owns the open transaction (its notes are buffered)
        self._txn_thread: int | None = None
        #: callbacks to run once the open transaction commits
        self._after_commit: list = []
        #: row-change journal (attached by the search engine; None = the
        #: write path pays nothing)
        self._journal: RowJournal | None = None
        # autocommit mode; transactions are explicit (see transaction())
        self._conn = sqlite3.connect(self.path, check_same_thread=False,
                                     isolation_level=None)
        self._conn.row_factory = sqlite3.Row
        # the WAL reader (lazy): SELECTs from threads outside the write
        # transaction; ":memory:" gets none, since a second :memory:
        # connection would be a different database
        self._read_conn: sqlite3.Connection | None = None
        self._read_lock = threading.Lock()
        self._closed = False
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA foreign_keys=ON")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        with self._lock:
            for model in self.models:
                for stmt in model.ddl():
                    self._conn.execute(stmt)

    def close(self) -> None:
        with self._read_lock:
            self._closed = True
            if self._read_conn is not None and self._read_conn is not self._conn:
                self._read_conn.close()
            self._read_conn = None
        with self._lock:
            self._conn.close()

    # -- row-change journal (search-engine refresh feed) ---------------------
    def attach_row_journal(self, tables: Iterable[str],
                           flood_on_delete: Iterable[str] = ()) -> RowJournal:
        """Idempotent per table set; the single consumer drains it."""
        journal = self._journal
        if journal is None or journal.tables != frozenset(tables):
            journal = RowJournal(tables, flood_on_delete=flood_on_delete)
            self._journal = journal
        return journal

    def _journal_note(self, table: str, key: str, value: Any) -> None:
        """Txn-aware note routing: inside an open transaction the note is
        buffered until the OUTERMOST close publishes it — a drainable note
        must never precede its rows' visibility."""
        journal = self._journal
        if journal is None or table not in journal.tables:
            return
        if self._txn_depth and self._txn_thread == threading.get_ident():
            journal.buffer(threading.get_ident(), table, key, value)
        else:
            journal.publish_one(table, key, value)

    def _journal_sniff(self, sql: str) -> None:
        journal = self._journal
        if journal is not None:
            table = journal.sniff(sql)
            if table is not None:
                self._journal_note(table, "flood", None)

    def _journal_where(self, table: str, where: dict[str, Any]) -> None:
        """Note an update/delete by its where-key: a unique row key notes
        that row exactly; anything else floods the table."""
        if self._journal is None or table not in self._journal.tables:
            return
        if where.get("id") is not None:
            self._journal_note(table, "id", where["id"])
        elif where.get("pub_id") is not None:
            self._journal_note(table, "pub_id", where["pub_id"])
        else:
            self._journal_note(table, "flood", None)

    def _refuse_write(self) -> None:
        if self.readonly:
            raise sqlite3.ProgrammingError("read-only database handle (reader pool)")

    def execute(self, sql: str, params: tuple | list = (), *,
                _noted: bool = False) -> sqlite3.Cursor:
        self._refuse_write()
        with self._lock:
            cur = self._conn.execute(sql, params)
            if not _noted:
                # after the statement: an autocommit write is visible now,
                # and a write inside a transaction buffers until it closes
                self._journal_sniff(sql)
        return cur

    def executemany(self, sql: str, seq: list[tuple], *, _noted: bool = False) -> None:
        with self.transaction():  # joins an open transaction
            self._conn.executemany(sql, seq)
            if not _noted:
                self._journal_sniff(sql)

    def _reader(self) -> sqlite3.Connection | None:
        """The WAL reader connection (None for :memory:), opened after the
        DDL ran on the writer. A closed Database raises as the writer
        would, instead of opening a new connection."""
        if self._closed:
            raise sqlite3.ProgrammingError("Cannot operate on a closed database.")
        if self.path == ":memory:":
            return None
        if self._read_conn is None:
            conn = sqlite3.connect(self.path, check_same_thread=False)
            conn.row_factory = sqlite3.Row
            # the reader must never become a second writer
            conn.execute("PRAGMA query_only=ON")
            self._read_conn = conn
        return self._read_conn

    def query(self, sql: str, params: tuple | list = ()) -> list[sqlite3.Row]:
        # the thread that owns the open transaction reads through the
        # writer and sees its own uncommitted rows; any other thread reads
        # the last committed snapshot off the reader without waiting on the
        # writer lock. Only the owner sets _txn_thread to its own id, so an
        # unlocked peek that races routes a non-owner to the reader, where
        # it belongs.
        if self._txn_depth and self._txn_thread == threading.get_ident():
            with self._lock:
                rows = self._conn.execute(sql, params).fetchall()
                # a write routed through query() is sniffed like
                # execute()'s, or the row journal would under-note it
                self._journal_sniff(sql)
            return rows
        # request traces opt into per-SELECT spans; job traces never do
        trace = _tspans.current_trace()
        sp = (trace.span("db.query", sql=sql[:120])
              if trace is not None and getattr(trace, "record_db_spans", False) else None)
        try:
            if sp is not None:
                sp.__enter__()
            self._acquire_reader_lock(sp)
            try:
                reader = self._reader()
                if reader is not None:
                    return reader.execute(sql, params).fetchall()
            finally:
                self._read_lock.release()
            with self._lock:
                rows = self._conn.execute(sql, params).fetchall()
                self._journal_sniff(sql)
            return rows
        finally:
            if sp is not None:
                sp.__exit__(None, None, None)

    def _acquire_reader_lock(self, sp=None) -> None:
        if self._read_lock.acquire(blocking=False):
            return
        t0 = time.perf_counter()
        self._read_lock.acquire()
        wait_s = time.perf_counter() - t0
        _READER_WAIT.observe(wait_s)
        if sp is not None:
            sp.set(reader_wait_s=round(wait_s, 6))

    @contextlib.contextmanager
    def snapshot(self):
        """Yield a ``query(sql, params)`` whose SELECTs all read one
        committed snapshot (one read transaction on the reader), so rows
        and counts read in separate statements agree with each other. The
        reader's lock is held throughout; the transaction's owner, or a
        ``:memory:`` database, reads through the writer instead."""
        if self._txn_depth and self._txn_thread == threading.get_ident():
            yield self.query
            return
        self._acquire_reader_lock()
        try:
            reader = self._reader()
            if reader is None:
                with self._lock:
                    yield lambda sql, params=(): self._conn.execute(sql, params).fetchall()
                return
            reader.execute("BEGIN")
            try:
                yield lambda sql, params=(): reader.execute(sql, params).fetchall()
            finally:
                reader.execute("COMMIT")
        finally:
            self._read_lock.release()

    def transaction(self) -> "_Txn":
        """Atomic multi-statement write; nested uses join the outer one."""
        self._refuse_write()
        return _Txn(self)

    def after_commit(self, fn: Callable[[], Any]) -> None:
        """Run ``fn`` once what this thread wrote is visible to every other
        connection: now outside a transaction, else after the outermost
        COMMIT (never after a ROLLBACK). A write joined to an outer
        transaction, as under the pipeline's group commit, is not durable
        when its own block ends."""
        if self._txn_depth and self._txn_thread == threading.get_ident():
            self._after_commit.append(fn)
        else:
            fn()

    @staticmethod
    def _where_sql(model: type[Model], where: dict[str, Any]) -> tuple[str, list[Any]]:
        """None values compare with IS NULL (``col = NULL`` matches nothing)."""
        parts: list[str] = []
        params: list[Any] = []
        for c, v in where.items():
            if v is None:
                parts.append(f'"{c}" IS NULL')
            else:
                parts.append(f'"{c}" = ?')
                params.append(model.encode(c, v))
        return " AND ".join(parts), params

    @staticmethod
    def _insert_sql(model: type[Model], cols: list[str], or_ignore: bool) -> str:
        collist = ", ".join(f'"{c}"' for c in cols)
        marks = ", ".join("?" for _ in cols)
        return (f"INSERT {'OR IGNORE ' if or_ignore else ''}INTO {model.TABLE} "
                f"({collist}) VALUES ({marks})")

    def insert(self, model: type[Model], row: dict[str, Any], or_ignore: bool = False) -> int:
        cols = [c for c in row if c in model.FIELDS]
        cur = self.execute(self._insert_sql(model, cols, or_ignore),
                           [model.encode(c, row[c]) for c in cols], _noted=True)
        if cur.rowcount > 0:
            self._journal_note(model.TABLE, "id", cur.lastrowid)
        return cur.lastrowid

    def insert_ignore(self, model: type[Model], row: dict[str, Any]) -> bool:
        """INSERT OR IGNORE; True iff a row was inserted (the one-statement
        half of the applier's rowcount upsert)."""
        cols = [c for c in row if c in model.FIELDS]
        cur = self.execute(self._insert_sql(model, cols, True),
                           [model.encode(c, row[c]) for c in cols], _noted=True)
        inserted = cur.rowcount > 0
        if inserted:
            self._journal_note(model.TABLE, "id", cur.lastrowid)
        return inserted

    def insert_many(self, model: type[Model], rows: list[dict[str, Any]],
                    or_ignore: bool = False) -> int:
        if not rows:
            return 0
        cols = [c for c in rows[0] if c in model.FIELDS]
        self.executemany(self._insert_sql(model, cols, or_ignore),
                         [tuple(model.encode(c, r.get(c)) for c in cols) for r in rows],
                         _noted=True)
        # fresh AUTOINCREMENT ids ride the consumer's id > max_id append
        # scan; only explicit-id rows need notes
        if "id" in cols:
            for r in rows:
                self._journal_note(model.TABLE, "id", r.get("id"))
        return len(rows)

    def update(self, model: type[Model], where: dict[str, Any],
               values: dict[str, Any]) -> int:
        if not values:
            return 0
        set_sql = ", ".join(f'"{c}" = ?' for c in values)
        where_sql, where_params = self._where_sql(model, where)
        params = [model.encode(c, v) for c, v in values.items()] + where_params
        with self._lock:
            cur = self.execute(f"UPDATE {model.TABLE} SET {set_sql} WHERE {where_sql}",
                               params, _noted=True)
            self._journal_where(model.TABLE, where)
        return cur.rowcount

    def delete(self, model: type[Model], where: dict[str, Any]) -> int:
        where_sql, params = self._where_sql(model, where)
        with self._lock:
            cur = self.execute(f"DELETE FROM {model.TABLE} WHERE {where_sql}", params,
                               _noted=True)
            journal = self._journal
            if journal is not None and model.TABLE in journal.flood_on_delete:
                self._journal_note(model.TABLE, "flood", None)
            else:
                self._journal_where(model.TABLE, where)
        return cur.rowcount

    def find(self, model: type[Model], where: dict[str, Any] | None = None,
             order_by: str | None = None, limit: int | None = None) -> list[dict[str, Any]]:
        sql = f"SELECT * FROM {model.TABLE}"
        params: list[Any] = []
        if where:
            where_sql, params = self._where_sql(model, where)
            sql += f" WHERE {where_sql}"
        if order_by:
            sql += f" ORDER BY {order_by}"
        if limit is not None:
            sql += " LIMIT ?"
            params.append(limit)
        return [model.decode_row(r) for r in self.query(sql, params)]

    def find_one(self, model: type[Model], where: dict[str, Any]) -> dict[str, Any] | None:
        rows = self.find(model, where, limit=1)
        return rows[0] if rows else None

    def upsert(self, model: type[Model], where: dict[str, Any], create: dict[str, Any],
               update: dict[str, Any]) -> None:
        """Insert ``where | create`` unless a row matches ``where``, else
        update that row with ``update`` (the reference's ``upsert``)."""
        with self._lock:
            if self.find_one(model, where) is None:
                self.insert(model, {**where, **create})
            else:
                self.update(model, where, update)


class _Txn:
    """Re-entrant transaction scope: the outermost use BEGINs and COMMITs (or
    ROLLs BACK on an exception); nested uses join it. Holds the connection
    lock for its whole extent, so other threads' writes wait. The ``commit``
    fault seam is hit before the BEGIN and before the COMMIT."""

    def __init__(self, db: Database) -> None:
        self.db = db

    def __enter__(self) -> Database:
        self.db._lock.acquire()
        try:
            if self.db._txn_depth == 0:
                faults.inject("commit", key="begin")
                self.db._conn.execute("BEGIN IMMEDIATE")
                self.db._txn_thread = threading.get_ident()
            self.db._txn_depth += 1
        except BaseException:
            self.db._lock.release()
            raise
        return self.db

    def __exit__(self, exc_type, *_: Any) -> None:
        committed: list = []
        try:
            self.db._txn_depth -= 1
            if self.db._txn_depth == 0:
                self.db._txn_thread = None
                callbacks, self.db._after_commit = self.db._after_commit, []
                try:
                    if exc_type is None:
                        try:
                            faults.inject("commit", key="commit")
                        except BaseException:
                            self.db._conn.execute("ROLLBACK")
                            raise
                    self.db._conn.execute("COMMIT" if exc_type is None else "ROLLBACK")
                    if exc_type is None:
                        committed = callbacks
                finally:
                    # buffered row-journal notes become drainable only now
                    # (commit OR rollback: the rows are visible or unchanged
                    # — either way a re-select is truthful)
                    journal = self.db._journal
                    if journal is not None:
                        journal.publish_thread(threading.get_ident())
        finally:
            self.db._lock.release()
        for fn in committed:
            fn()
