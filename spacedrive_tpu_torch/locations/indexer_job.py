"""IndexerJob: walk a location and persist the file tree.

Counterpart of ``spacedrive_tpu/locations/indexer_job.py`` (which mirrors
core/src/location/indexer/indexer_job.rs): steps are Save(batch),
Update(batch), Remove(batch) and Walk(dir) continuations; BATCH_SIZE = 1000,
initial walk budget 50,000 entries. Sync op emission is not ported.
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
            {**_entry_to_row(e), "row_id": e.row_id, "content_changed": e.content_changed}
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
        if kind == "save":
            # or_ignore: a row another scan already saved keeps its identity
            db.insert_many(FilePath, step["rows"], or_ignore=True)
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
                    db.update(FilePath, {"id": row["row_id"]}, values)
            return StepResult(metadata={"db_write_time": time.perf_counter() - t0,
                                        "updated_rows": len(step["rows"])})
        if kind == "remove":
            with db.transaction():
                for fp_id in step["ids"]:
                    db.delete(FilePath, {"id": fp_id})
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
