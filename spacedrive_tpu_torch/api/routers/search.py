"""search.paths and search.pathsCount: filterable, ordered, cursor-paginated
``file_path`` search; search.nearDuplicates: the persisted MinHash groups.

Counterpart of ``spacedrive_tpu/api/routers/search.py`` (``_path_filters``
:33, ``_ids_clause`` :93, ``_order_parts`` :111, ``_cursor_sql`` :120,
``paths`` :129, ``paths_count`` :191, ``near_duplicates`` :305), with the
SQL verbatim. The handlers
are plain functions ``(node, library, arg)``: the rspc router, the reader
pool and the replica tier are not ported. With the search engine armed
(``node.search_engine``), the device index scores the filter predicates and
the SQL below hydrates the matching ids, so the answer is byte-identical to
the SQL path; an error of the engine propagates.
"""

from __future__ import annotations

from typing import Any

from ...models import FilePath
from .. import ApiError

_PATH_ORDERS = {"name", "size_in_bytes", "date_created", "date_modified"}


def _path_filters(arg: dict[str, Any]) -> tuple[str, list[Any], bool]:
    """(where-sql, params, needs_object_join) — the flag is True when any
    predicate references the ``o`` alias, so COUNT-shaped callers can drop
    the LEFT JOIN without duplicating filter knowledge here."""
    where, params = ["1=1"], []
    if arg.get("location_id") is not None:
        where.append("fp.location_id = ?")
        params.append(arg["location_id"])
    if arg.get("search"):
        where.append("fp.name LIKE ?")
        params.append(f"%{arg['search']}%")
    if arg.get("extensions"):
        marks = ",".join("?" for _ in arg["extensions"])
        where.append(f"fp.extension IN ({marks})")
        params.extend(e.lstrip(".").lower() for e in arg["extensions"])
    if arg.get("kinds"):
        marks = ",".join("?" for _ in arg["kinds"])
        where.append(f"o.kind IN ({marks})")
        params.extend(arg["kinds"])
    if arg.get("tags"):
        marks = ",".join("?" for _ in arg["tags"])
        where.append(f"fp.object_id IN (SELECT object_id FROM tag_on_object "
                     f"WHERE tag_id IN ({marks}))")
        params.extend(arg["tags"])
    if arg.get("favorite") is not None:
        where.append("o.favorite = ?")
        params.append(int(arg["favorite"]))
    if not arg.get("include_hidden"):
        where.append("(fp.hidden IS NULL OR fp.hidden = 0)")
    if arg.get("materialized_path"):
        where.append("fp.materialized_path = ?")
        params.append(arg["materialized_path"])
    if arg.get("date_range"):
        # [lo, hi], either side None; TEXT comparison under BINARY
        # collation (ISO-8601 with 'T' — lexicographic == chronological)
        lo, hi = arg["date_range"]
        if lo is not None:
            where.append("fp.date_created >= ?")
            params.append(lo)
        if hi is not None:
            where.append("fp.date_created <= ?")
            params.append(hi)
    if arg.get("size_range"):
        lo, hi = arg["size_range"]
        if lo is not None:
            where.append("fp.size_in_bytes >= ?")
            params.append(lo)
        if hi is not None:
            where.append("fp.size_in_bytes <= ?")
            params.append(hi)
    needs_object = any("o." in clause for clause in where)
    return " AND ".join(where), params, needs_object


def _ids_clause(ids) -> str:
    """The hydration WHERE for an engine-provided candidate set: the ids are
    our own int64 row ids, inlined (a 20k-id IN list stays far under
    SQLite's statement limits)."""
    if len(ids) == 0:
        return "0=1"
    return f"fp.id IN ({','.join(str(int(i)) for i in ids)})"


#: NULL-safe order expressions (keyset cursors need total order)
_COALESCED = {
    "name": "COALESCE(fp.name, '')",
    "size_in_bytes": "COALESCE(fp.size_in_bytes, -1)",
    "date_created": "COALESCE(fp.date_created, '')",
    "date_modified": "COALESCE(fp.date_modified, '')",
}


def _order_parts(arg: dict[str, Any]) -> tuple[str, str, bool]:
    field = arg.get("order_by") or "name"
    if field not in _PATH_ORDERS:
        field = "name"
    desc = bool(arg.get("order_desc"))
    expr = _COALESCED[field]
    return expr, f"{expr} {'DESC' if desc else 'ASC'}, fp.id ASC", desc


def _cursor_sql(expr: str, desc: bool) -> str:
    """Keyset condition over (order value, id) — a bare id cursor would be
    incoherent under non-id orderings."""
    cmp = "<" if desc else ">"
    return f"({expr} {cmp} ? OR ({expr} = ? AND fp.id > ?))"


def paths(node, library, arg) -> dict[str, Any]:
    """search.paths: cursor-paginated file_path search with object join."""
    arg = arg or {}
    where, params, _needs_o = _path_filters(arg)  # paths always joins
    take = min(int(arg.get("take", 100)), 500)
    expr, order_sql, desc = _order_parts(arg)
    cursor = arg.get("cursor")
    if arg.get("dirs_first"):
        # folders lead (the explorer's browse order); offset-mode only — the
        # keyset cursor doesn't encode the two-level order
        if cursor is not None:
            raise ApiError("dirs_first cannot combine with a cursor")
        order_sql = f"fp.is_dir DESC, {order_sql}"
    # the device index scores the FILTER predicates and returns the exact
    # matching id set; the SELECT below then reproduces ORDER BY / LIMIT /
    # cursor semantics byte for byte over `fp.id IN (...)`. None = serve SQL
    # (engine off, index stale, ineligible predicate, oversized set).
    engine = node.search_engine
    cand = engine.candidate_ids(library, arg) if engine is not None else None
    if cand is not None:
        where, params = _ids_clause(cand), []
    cursor_sql = ""
    if cursor is not None:
        value, last_id = cursor
        cursor_sql = f"AND {_cursor_sql(expr, desc)}"
        params = params + [value, value, last_id]
    # `skip`: offset pagination for the explorer's windowed grid
    offset_sql = ""
    if cursor is None and arg.get("skip"):
        offset_sql = " OFFSET ?"
    rows = library.db.query(
        f"SELECT fp.*, o.pub_id AS object_pub_id, o.kind AS object_kind, "
        f"o.favorite AS favorite, o.note AS note, {expr} AS _order_val "
        f"FROM file_path fp LEFT JOIN object o ON fp.object_id = o.id "
        f"WHERE {where} {cursor_sql} ORDER BY {order_sql} LIMIT ?"
        f"{offset_sql}",
        params + [take + 1] + ([int(arg["skip"])] if offset_sql else []))
    items = []
    for r in rows[:take]:
        d = dict(FilePath.decode_row(r) | {
            "object_pub_id": r["object_pub_id"],
            "object_kind": r["object_kind"],
            "favorite": bool(r["favorite"]), "note": r["note"],
        })
        d.pop("_order_val", None)
        items.append(d)
    next_cursor = None
    if len(rows) > take and items:
        next_cursor = [rows[take - 1]["_order_val"], items[-1]["id"]]
    return {"items": items, "cursor": next_cursor}


def paths_count(node, library, arg) -> int:
    """search.pathsCount: a mask sum on the device index when the engine can
    answer, else COUNT(*) over the same filters."""
    engine = node.search_engine
    if engine is not None:
        n = engine.count(library, arg or {})
        if n is not None:
            return n
    where, params, needs_object = _path_filters(arg or {})
    # without o.* predicates the COUNT runs index-only over the
    # (location_id, hidden) covering index; the join is on object's PK, so
    # it can never duplicate rows either way
    join = ("LEFT JOIN object o ON fp.object_id = o.id "
            if needs_object else "")
    return library.db.query(
        f"SELECT COUNT(*) n FROM file_path fp {join}WHERE {where}",
        params)[0]["n"]


def near_duplicates(node, library, arg) -> dict[str, Any]:
    """``search.nearDuplicates``: MinHash similarity groups, served from the
    persisted ``near_duplicate`` pairs the chained dedup job wrote (database
    reads only; reference ``search.py:305``)."""
    from ...objects.dedup import persisted_near_duplicate_groups

    arg = arg or {}
    return persisted_near_duplicate_groups(
        library.db, location_id=arg.get("location_id"),
        limit=int(arg.get("take", arg.get("limit", 1000))))
