"""IndexerJob: walk a location and persist the file tree.

Counterpart of ``spacedrive_tpu/locations/indexer_job.py`` (which mirrors
core/src/location/indexer/indexer_job.rs): steps are Save(batch),
Update(batch), Remove(batch) and Walk(dir) continuations; BATCH_SIZE = 1000,
initial walk budget 50,000 entries. With sync emitting, each step logs its
operations in the transaction of its writes (reference :106-168): a save
the rows' creates, an update the changed fields of each row, a remove its
deletes. An update's operations name the row's own pub_id; the reference
names the fresh pub_id its walker made for the entry, which no row has.

An update whose row was matched by inode under another name and whose
content changed is another file that took a freed inode (a job that writes
one file and unlinks another, as the crypto jobs do, makes this common):
the port clears its ``integrity_checksum`` with its cas_id and object, so
the validator hashes the new file. The reference keeps the other file's
checksum, which the validator then never replaces; a file changed in place
under its own name keeps its checksum in both, so a revalidation reports it.
"""

from __future__ import annotations

import datetime as dt
import logging
import time
import uuid
from pathlib import Path
from typing import Any

from ..jobs import EarlyFinish, JobContext, JobError, StatefulJob, StepResult
from ..models import FilePath, Location, utc_now
from ..sync.manager import emitter
from .rules import CompiledRules, rules_for_location
from .walker import WalkedEntry, WalkResult, db_fetcher_for, walk

logger = logging.getLogger(__name__)

BATCH_SIZE = 1000
WALK_LIMIT = 50_000


def _ts_to_dt(ts: float) -> str:
    return dt.datetime.fromtimestamp(ts, dt.timezone.utc).isoformat()


def _entry_to_row(entry: WalkedEntry) -> dict[str, Any]:
    iso, meta = entry.iso, entry.metadata
    return {
        "pub_id": str(uuid.uuid4()),
        **iso.db_fields(),
        "inode": meta.inode,
        "device": meta.device,
        "size_in_bytes": meta.size_in_bytes,
        "hidden": meta.hidden,
        "date_created": _ts_to_dt(meta.created_at),
        "date_modified": _ts_to_dt(meta.modified_at),
        "date_indexed": utc_now().isoformat(),
    }


def _batches(rows: list, size: int) -> list[list]:
    return [rows[i : i + size] for i in range(0, len(rows), size)]


class IndexerJob(StatefulJob):
    NAME = "indexer"

    def _location(self, ctx: JobContext) -> dict[str, Any]:
        row = ctx.library.db.find_one(Location, {"id": self.init_args["location_id"]})
        if row is None:
            raise JobError(f"location {self.init_args['location_id']} not found")
        return row

    def _steps_from_walk(self, result: WalkResult) -> tuple[list[dict], dict]:
        steps: list[dict] = []
        for batch in _batches([_entry_to_row(e) for e in result.walked], BATCH_SIZE):
            steps.append({"kind": "save", "rows": batch})
        updates = [
            {**_entry_to_row(e), "row_id": e.row_id, "content_changed": e.content_changed,
             "renamed": e.renamed}
            for e in result.to_update
        ]
        for batch in _batches(updates, BATCH_SIZE):
            steps.append({"kind": "update", "rows": batch})
        if result.to_remove:
            steps.append({"kind": "remove", "ids": [r["id"] for r in result.to_remove]})
        for rel_dir in result.to_walk:
            steps.append({"kind": "walk", "dir": rel_dir})
        meta = {
            "total_paths": len(result.walked),
            "updated_paths": len(result.to_update),
            "removed_paths": len(result.to_remove),
            "indexer_errors": result.errors,
        }
        return steps, meta

    def finalize(self, ctx: JobContext, data: dict, run_metadata: dict):
        ctx.library.emit("invalidate_query", {"key": "search.paths"})
        return super().finalize(ctx, data, run_metadata)

    def init(self, ctx: JobContext):
        location = self._location(ctx)
        location_path = location["path"]
        if not location_path or not Path(location_path).is_dir():
            raise JobError(f"location path missing on disk: {location_path}")
        rules = CompiledRules(rules_for_location(ctx.library.db, location["id"]))
        t0 = time.perf_counter()
        result = walk(location["id"], location_path, rules,
                      db_fetcher_for(ctx.library.db, location["id"]),
                      sub_path=self.init_args.get("sub_path") or "", limit=WALK_LIMIT)
        steps, meta = self._steps_from_walk(result)
        meta["scan_read_time"] = time.perf_counter() - t0
        meta["db_write_time"] = 0.0
        if not steps:
            raise EarlyFinish("location already up to date")
        return {"location_id": location["id"], "location_path": location_path}, steps, meta

    def execute_step(self, ctx: JobContext, data: dict, step: dict,
                     step_number: int) -> StepResult:
        db = ctx.library.db
        kind = step["kind"]
        t0 = time.perf_counter()
        sync = emitter(ctx.library)
        ops: list = []
        if kind == "save":
            with db.transaction():
                # or_ignore: a row another scan already saved keeps its identity
                db.insert_many(FilePath, step["rows"], or_ignore=True)
                if sync is not None:
                    ops = sync.shared_create_many(FilePath, step["rows"])
            if ops:
                sync.created()
            return StepResult(metadata={"db_write_time": time.perf_counter() - t0,
                                        "saved_rows": len(step["rows"])})
        if kind == "update":
            with db.transaction():
                for row in step["rows"]:
                    values = {
                        # renames carry the new identity fields; updates by row id
                        "materialized_path": row["materialized_path"],
                        "name": row["name"], "extension": row["extension"],
                        "size_in_bytes": row["size_in_bytes"],
                        "inode": row["inode"], "device": row["device"],
                        "date_modified": row["date_modified"],
                        "hidden": row["hidden"],
                    }
                    if row.get("content_changed", True):
                        # content changed: clear identity so re-identify runs;
                        # a pure rename keeps its cas_id/object link
                        values["cas_id"] = None
                        values["object_id"] = None
                        if row.get("renamed"):
                            # another file took the inode (module docstring)
                            values["integrity_checksum"] = None
                    db.update(FilePath, {"id": row["row_id"]}, values)
                    if sync is not None:
                        pub_id = db.find_one(FilePath, {"id": row["row_id"]})["pub_id"]
                        for field in ("materialized_path", "name", "extension",
                                      "size_in_bytes", "date_modified", "cas_id"):
                            if field in values:
                                ops.append(sync.shared_update(FilePath, pub_id, field,
                                                              values[field]))
                if ops:
                    sync.log_ops(ops)
            if ops:
                sync.created()
            return StepResult(metadata={"db_write_time": time.perf_counter() - t0,
                                        "updated_rows": len(step["rows"])})
        if kind == "remove":
            with db.transaction():
                for fp_id in step["ids"]:
                    if sync is not None:
                        row = db.find_one(FilePath, {"id": fp_id})
                        if row is not None:
                            ops.append(sync.shared_delete(FilePath, row["pub_id"]))
                    db.delete(FilePath, {"id": fp_id})
                if ops:
                    sync.log_ops(ops)
            if ops:
                sync.created()
            return StepResult(metadata={"db_write_time": time.perf_counter() - t0})
        if kind == "walk":
            location = self._location(ctx)
            rules = CompiledRules(rules_for_location(db, location["id"]))
            result = walk(location["id"], data["location_path"], rules,
                          db_fetcher_for(db, location["id"]),
                          sub_path=step["dir"], limit=WALK_LIMIT, include_root=False)
            more_steps, meta = self._steps_from_walk(result)
            meta["scan_read_time"] = time.perf_counter() - t0
            return StepResult(more_steps=more_steps, metadata=meta)
        raise JobError(f"unknown indexer step kind: {kind}")
