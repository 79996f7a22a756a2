"""Declarative SQLite model layer (trimmed).

Counterpart of ``spacedrive_tpu/models/base.py``: models declare their
fields once, and the declaration drives the CREATE TABLE DDL and value
encoding. The port keeps the single-writer ``Database`` with the row API the
scan uses (``query``, ``find``/``find_one``, ``insert``, ``insert_many``,
``update``, ``executemany``, ``delete``, ``transaction``); the row-change
journal, the reader connection, sync annotations and retry seams are not
ported — the scan runs its jobs one at a time on one connection.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import json
import sqlite3
import threading
from pathlib import Path
from typing import Any, ClassVar, Iterable


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


class Model:
    """Base class. Subclasses set TABLE, FIELDS, optional UNIQUES/INDEXES."""

    TABLE: ClassVar[str]
    FIELDS: ClassVar[dict[str, Field]]
    UNIQUES: ClassVar[tuple[tuple[str, ...], ...]] = ()
    INDEXES: ClassVar[tuple[tuple[str, ...], ...]] = ()

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


class Database:
    """One SQLite library database behind one connection and one lock
    (SQLite's WAL single-writer discipline, as in the JAX package)."""

    def __init__(self, path: str | Path, models: Iterable[type[Model]]) -> None:
        self.path = str(path)
        if self.path != ":memory:":
            Path(self.path).parent.mkdir(parents=True, exist_ok=True)
        self.models = list(models)
        self._lock = threading.RLock()
        self._txn_depth = 0
        # autocommit mode; transactions are explicit (see transaction())
        self._conn = sqlite3.connect(self.path, check_same_thread=False,
                                     isolation_level=None)
        self._conn.row_factory = sqlite3.Row
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA foreign_keys=ON")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        with self._lock:
            for model in self.models:
                for stmt in model.ddl():
                    self._conn.execute(stmt)

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    def execute(self, sql: str, params: tuple | list = ()) -> sqlite3.Cursor:
        with self._lock:
            return self._conn.execute(sql, params)

    def executemany(self, sql: str, seq: list[tuple]) -> None:
        with self.transaction():  # joins an open transaction
            self._conn.executemany(sql, seq)

    def query(self, sql: str, params: tuple | list = ()) -> list[sqlite3.Row]:
        with self._lock:
            return self._conn.execute(sql, params).fetchall()

    def transaction(self) -> "_Txn":
        """Atomic multi-statement write; nested uses join the outer one."""
        return _Txn(self)

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
                           [model.encode(c, row[c]) for c in cols])
        return cur.lastrowid

    def insert_many(self, model: type[Model], rows: list[dict[str, Any]],
                    or_ignore: bool = False) -> int:
        if not rows:
            return 0
        cols = [c for c in rows[0] if c in model.FIELDS]
        self.executemany(self._insert_sql(model, cols, or_ignore),
                         [tuple(model.encode(c, r.get(c)) for c in cols) for r in rows])
        return len(rows)

    def update(self, model: type[Model], where: dict[str, Any],
               values: dict[str, Any]) -> int:
        if not values:
            return 0
        set_sql = ", ".join(f'"{c}" = ?' for c in values)
        where_sql, where_params = self._where_sql(model, where)
        params = [model.encode(c, v) for c, v in values.items()] + where_params
        return self.execute(f"UPDATE {model.TABLE} SET {set_sql} WHERE {where_sql}",
                            params).rowcount

    def delete(self, model: type[Model], where: dict[str, Any]) -> int:
        where_sql, params = self._where_sql(model, where)
        return self.execute(f"DELETE FROM {model.TABLE} WHERE {where_sql}", params).rowcount

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


class _Txn:
    """Re-entrant transaction scope: the outermost use BEGINs and COMMITs (or
    ROLLs BACK on an exception); nested uses join it. Holds the connection
    lock for its whole extent, so other threads' writes wait."""

    def __init__(self, db: Database) -> None:
        self.db = db

    def __enter__(self) -> Database:
        self.db._lock.acquire()
        try:
            if self.db._txn_depth == 0:
                self.db._conn.execute("BEGIN IMMEDIATE")
            self.db._txn_depth += 1
        except BaseException:
            self.db._lock.release()
            raise
        return self.db

    def __exit__(self, exc_type, *_: Any) -> None:
        try:
            self.db._txn_depth -= 1
            if self.db._txn_depth == 0:
                self.db._conn.execute("COMMIT" if exc_type is None else "ROLLBACK")
        finally:
            self.db._lock.release()
