"""Sync helpers of the port's tests, without jax: the on-card tests and
``chip_smoke.py`` import it too.

``synced_rows`` is the convergence comparison: every row of the synced
tables (location, file_path, object, tag, tag_on_object, preference) keyed
by its sync id, without its local ``id``, each foreign key given as the
pub_id it points at. ``op_log`` is the op-log comparison: a multiset of
the library's logged operations with the op ids, HLC timestamps and
instances dropped, every pub_id replaced by what its row is (a file's
path, an object's files, a tag's or a location's name: ``pub_keys``), and
every date replaced by ``<date>``.
"""

import collections
import json
import re

UUID = re.compile(r"^[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}$")

#: the synced tables the convergence comparison reads
SYNCED_TABLES = ("location", "file_path", "object", "tag", "tag_on_object", "preference")


def _pub_of(db, table: str) -> dict:
    return {r["id"]: r["pub_id"] for r in db.query(f"SELECT id, pub_id FROM {table}")}


def synced_rows(db, skip: frozenset = frozenset()) -> dict:
    """``{(table, sync id): row}``; ``skip`` holds (table, column) pairs
    left out."""
    pubs = {t: _pub_of(db, t) for t in ("instance", "location", "object", "tag")}
    fks = {"location": {"instance_id": "instance"},
           "file_path": {"location_id": "location", "object_id": "object"},
           "tag_on_object": {"tag_id": "tag", "object_id": "object"}}
    out = {}
    for table in SYNCED_TABLES:
        for r in db.query(f"SELECT * FROM {table}"):
            row = {k: r[k] for k in r.keys() if k != "id" and (table, k) not in skip}
            for col, target in fks.get(table, {}).items():
                if col in row:
                    row[col] = pubs[target].get(row[col])
            if table == "tag_on_object":
                key = (row["tag_id"], row["object_id"])
            else:
                key = row["key"] if table == "preference" else row["pub_id"]
            out[(table, key)] = row
    return out


def pub_keys(db) -> dict:
    """pub_id -> what its row is, from the rows as they stand."""
    keys: dict = {}
    files_of: dict = collections.defaultdict(list)
    for r in db.query("SELECT pub_id, materialized_path, name, extension, object_id "
                      "FROM file_path"):
        keys[r["pub_id"]] = ("file_path", r["materialized_path"], r["name"], r["extension"])
        if r["object_id"] is not None:
            files_of[r["object_id"]].append(keys[r["pub_id"]][1:])
    for r in db.query("SELECT id, pub_id FROM object"):
        keys[r["pub_id"]] = ("object",) + tuple(sorted(files_of.get(r["id"], [])))
    for table in ("location", "tag"):
        for r in db.query(f"SELECT pub_id, name FROM {table}"):
            keys[r["pub_id"]] = (table, r["name"])
    for r in db.query("SELECT pub_id FROM instance"):
        keys[r["pub_id"]] = ("instance",)
    return keys


def _norm(value, keys: dict, roots: tuple, drop: tuple, field: str = ""):
    if field.startswith("date_") and value is not None:
        return "<date>"
    if isinstance(value, dict):
        if "__ref__" in value:
            table, pub = value["__ref__"]
            return ["ref", table, _key(pub, keys)]
        return {k: _norm(v, keys, roots, drop, k) for k, v in value.items() if k not in drop}
    if isinstance(value, list):
        return [_norm(v, keys, roots, drop) for v in value]
    if isinstance(value, str):
        for i, root in enumerate(roots):
            value = value.replace(str(root), f"<root{i}>")
    return value


def _key(pub, keys: dict):
    if pub in keys:
        return list(keys[pub])
    return "<unknown>" if isinstance(pub, str) and UUID.match(pub) else pub


def op_log(db, keys: dict, roots: tuple = (), drop: tuple = ()) -> collections.Counter:
    """The library's op log as a multiset (see the module docstring);
    ``roots`` are paths replaced by ``<rootN>``, ``drop`` data keys left
    out."""
    out: collections.Counter = collections.Counter()
    for r in db.query("SELECT model, record_id, kind, data FROM shared_operation"):
        data = json.loads(r["data"]) if r["data"] is not None else None
        field = r["kind"][2:] if r["kind"].startswith("u:") else ""
        out[json.dumps(["shared", r["model"], _key(r["record_id"], keys), r["kind"],
                        _norm(data, keys, roots, drop, field)], sort_keys=True)] += 1
    for r in db.query("SELECT relation, item_id, group_id, kind, data FROM relation_operation"):
        data = json.loads(r["data"]) if r["data"] is not None else None
        out[json.dumps(["relation", r["relation"], _key(r["item_id"], keys),
                        _key(r["group_id"], keys), r["kind"],
                        _norm(data, keys, roots, drop)], sort_keys=True)] += 1
    return out


def pair_libraries(lib_a, lib_b) -> None:
    """Cross-register the two libraries' instances, as the reference's
    two-instance tests do by hand."""
    lib_a.add_remote_instance(lib_b.instance())
    lib_b.add_remote_instance(lib_a.instance())


def sync_ops(lib) -> int:
    """Operations this library's own instance logged."""
    return sum(lib.db.query(f"SELECT COUNT(*) AS n FROM {t} WHERE instance_id = ?",
                            [lib.instance_id])[0]["n"]
               for t in ("shared_operation", "relation_operation"))
