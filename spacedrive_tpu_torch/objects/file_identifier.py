"""FileIdentifierJob: assign cas_ids and dedup files into objects.

Counterpart of ``spacedrive_tpu/objects/file_identifier.py`` in its
sequential step loop (``execute_step`` :199-208): each step pages the next
``BATCH_SIZE`` orphan file_paths (id > cursor), gathers their sampled cas
messages, hashes them on the node's device, and commits — cas_id updates,
links to existing objects sharing a cas_id, one new object per new cas_id
and per empty file, and (with ``SD_CHUNK_MANIFESTS=1``) chunk manifests —
in one transaction.

Unlike the JAX job there is no CPU re-dispatch of a failed hash batch: on
the card a kernel failure raises and fails the job.
"""

from __future__ import annotations

import logging
import time
import uuid
from typing import Any

from ..jobs import EarlyFinish, JobContext, JobError, StatefulJob, StepResult
from ..models import Location, Object, utc_now
from . import manifest as chunk_manifest
from .cas import read_sampled_batch
from .magic import HEADER_LEN, resolve_kind

logger = logging.getLogger(__name__)

#: files per step = device batch size
BATCH_SIZE = 1024


def _orphan_where(location_id: int, sub_path: str | None) -> tuple[str, list]:
    sql = 'object_id IS NULL AND is_dir = 0 AND location_id = ? AND name != ""'
    params: list[Any] = [location_id]
    if sub_path:
        sql += " AND materialized_path LIKE ?"
        params.append(f"/{sub_path.strip('/')}/%")
    return sql, params


def abs_path(location_path: str, row: dict) -> str:
    name = row["name"] or ""
    ext = row["extension"] or ""
    full = f"{name}.{ext}" if ext and not row["is_dir"] else name
    return f"{location_path}{row['materialized_path']}{full}"


class FileIdentifierJob(StatefulJob):
    NAME = "file_identifier"

    def init(self, ctx: JobContext):
        db = ctx.library.db
        location_id = self.init_args["location_id"]
        location = db.find_one(Location, {"id": location_id})
        if location is None:
            raise JobError(f"location {location_id} not found")
        where, params = _orphan_where(location_id, self.init_args.get("sub_path"))
        count = db.query(f"SELECT COUNT(*) AS n FROM file_path WHERE {where}", params)[0]["n"]
        if count == 0:
            raise EarlyFinish("Found no orphan file paths to process")
        logger.info("Found %d orphan file paths", count)
        steps = [{"kind": "identify"} for _ in range(-(-count // BATCH_SIZE))]
        data = {"location_id": location_id, "location_path": location["path"],
                "cursor": 0, "sub_path": self.init_args.get("sub_path")}
        return data, steps, {"total_orphan_paths": count, "created_objects": 0,
                             "linked_objects": 0, "hash_time": 0.0,
                             "quarantined_files": 0, "chunked_files": 0,
                             "chunk_quarantined": 0}

    def execute_step(self, ctx: JobContext, data: dict, step: dict,
                     step_number: int) -> StepResult:
        batch = self.page(ctx, data)
        if batch is None:
            return StepResult()
        return self.commit(ctx, data, self.process(ctx, batch))

    # -- stage 1: page (DB reads + file I/O only) ----------------------------
    def page(self, ctx: JobContext, data: dict) -> dict | None:
        db = ctx.library.db
        where, params = _orphan_where(data["location_id"], data.get("sub_path"))
        rows = [dict(r) for r in db.query(
            f"SELECT id, pub_id, name, extension, materialized_path, is_dir, "
            f"size_in_bytes, date_created FROM file_path "
            f"WHERE {where} AND id > ? ORDER BY id LIMIT ?",
            params + [data["cursor"], BATCH_SIZE])]
        if not rows:
            return None
        hashable = [r for r in rows if (r["size_in_bytes"] or 0) > 0]
        empty = [r for r in rows if (r["size_in_bytes"] or 0) <= 0]
        location_path = data["location_path"]
        paths = [abs_path(location_path, r) for r in hashable]
        t0 = time.perf_counter()
        messages = read_sampled_batch(paths, [r["size_in_bytes"] for r in hashable])
        if chunk_manifest.manifests_enabled():
            chunk_manifest.pipeline_chunk_gather(paths, hashable, messages)
        # the cas message is size_le_8 ‖ header ‖ …: its head is the file's
        # first bytes, so magic-byte kind resolution needs no second read
        for row, msg in zip(hashable, messages):
            row["_kind_head"] = None if isinstance(msg, Exception) else bytes(msg[8:8 + HEADER_LEN])
        for row in empty:
            row["_kind_head"] = b""
        return {"cursor": rows[-1]["id"], "hashable": hashable, "empty": empty,
                "messages": messages, "gather_s": time.perf_counter() - t0}

    # -- stage 2: process (device compute) -----------------------------------
    def process(self, ctx: JobContext, batch: dict) -> dict:
        t0 = time.perf_counter()
        batch["cas_results"] = ctx.node.hasher.hash_gathered(batch["messages"])
        batch["messages"] = None
        if chunk_manifest.manifests_enabled():
            chunk_manifest.pipeline_chunk_process(batch["hashable"], ctx.node.device)
        batch["hash_s"] = time.perf_counter() - t0
        return batch

    # -- stage 3: commit (the only stage that writes) ------------------------
    def commit(self, ctx: JobContext, data: dict, batch: dict) -> StepResult:
        db = ctx.library.db
        location_path = data["location_path"]
        hashable, empty = batch["hashable"], batch["empty"]
        errors: list[str] = []
        identified: list[tuple[dict, str]] = []
        for row, cas in zip(hashable, batch["cas_results"]):
            if isinstance(cas, Exception):
                # vanished/unreadable files are skipped as soft errors; the
                # next scan retries them as still-orphan paths
                errors.append(f"quarantined {abs_path(location_path, row)}: {cas!r}")
            else:
                identified.append((row, cas))
        quarantined = len(hashable) - len(identified)
        chunk_errors: list[str] = []
        if chunk_manifest.manifests_enabled():
            chunk_errors = chunk_manifest.quarantine_errors(hashable, location_path)
            errors.extend(chunk_errors)

        with db.transaction():
            # 1. write cas_ids
            db.executemany("UPDATE file_path SET cas_id = ? WHERE id = ?",
                           [(cas, row["id"]) for row, cas in identified])

            # 2. link to existing objects owning these cas_ids
            cas_ids = sorted({cas for _, cas in identified})
            existing: dict[str, int] = {}
            for start in range(0, len(cas_ids), 500):
                chunk = cas_ids[start : start + 500]
                marks = ",".join("?" for _ in chunk)
                for r in db.query(
                        f"SELECT fp.cas_id AS cas_id, o.id AS oid "
                        f"FROM file_path fp JOIN object o ON fp.object_id = o.id "
                        f"WHERE fp.cas_id IN ({marks})", chunk):
                    existing.setdefault(r["cas_id"], r["oid"])
            link_rows: list[tuple[int, int]] = []  # (object_id, file_path_id)
            need_object: dict[str, list[dict]] = {}
            for row, cas in identified:
                if cas in existing:
                    link_rows.append((existing[cas], row["id"]))
                else:
                    need_object.setdefault(cas, []).append(row)
            linked = len(link_rows)

            # 3. one object per unique new cas_id, plus one per empty file
            creations = ([(members[0], members) for members in need_object.values()]
                         + [(row, [row]) for row in empty])
            if creations:
                obj_rows = [self._object_row(rep, location_path) for rep, _ in creations]
                db.insert_many(Object, obj_rows)
                oid_of: dict[str, int] = {}
                for start in range(0, len(obj_rows), 500):
                    chunk = obj_rows[start : start + 500]
                    marks = ",".join("?" * len(chunk))
                    for r in db.query(f"SELECT id, pub_id FROM object WHERE pub_id IN ({marks})",
                                      [c["pub_id"] for c in chunk]):
                        oid_of[r["pub_id"]] = r["id"]
                for obj, (_rep, members) in zip(obj_rows, creations):
                    for row in members:
                        link_rows.append((oid_of[obj["pub_id"]], row["id"]))
            db.executemany("UPDATE file_path SET object_id = ? WHERE id = ?", link_rows)

            # 4. chunk manifests, in the same transaction
            chunked = 0
            if chunk_manifest.manifests_enabled():
                oid_by_fp = {fp_id: oid for oid, fp_id in link_rows}
                items: list[tuple[int, list]] = []
                seen_oids: set[int] = set()
                for row, _cas in identified:
                    m = row.get("_chunk_manifest")
                    oid = oid_by_fp.get(row["id"])
                    if m is None or oid is None or oid in seen_oids:
                        continue  # within-batch cas duplicates: one copy wins
                    seen_oids.add(oid)
                    items.append((oid, m))
                chunked = chunk_manifest.commit_manifest_rows(db, items)
        # the cursor advances only after the transaction committed
        data["cursor"] = batch["cursor"]
        return StepResult(metadata={"created_objects": len(creations),
                                    "linked_objects": linked,
                                    "hash_time": batch["hash_s"],
                                    "gather_s": batch["gather_s"],
                                    "quarantined_files": quarantined,
                                    "chunked_files": chunked,
                                    "chunk_quarantined": len(chunk_errors)},
                          errors=errors)

    def _object_row(self, row: dict, location_path: str) -> dict:
        # magic-byte disambiguation for conflicting/unknown extensions; the
        # head bytes came with the gather
        kind = resolve_kind(row.get("extension"), abs_path(location_path, row),
                            bool(row.get("is_dir")), head=row.get("_kind_head"))
        return {"pub_id": str(uuid.uuid4()), "kind": kind,
                "date_created": row.get("date_created") or utc_now()}
