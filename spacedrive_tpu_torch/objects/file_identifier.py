"""FileIdentifierJob: assign cas_ids and dedup files into objects.

Counterpart of ``spacedrive_tpu/objects/file_identifier.py``. Each step is
three stages: ``pipeline_page`` pages the next orphan file_paths (id >
cursor) and gathers their sampled cas messages (reads only, through the
native gather, as the reference's identifier imports
``read_sampled_batch_fast as read_sampled_batch``),
``pipeline_process`` hashes them with the location's hasher (the node's
device, or its mesh for a ``tpu-sharded`` location), and
``pipeline_commit`` writes, in one transaction, the cas_ids, links to
existing objects sharing a cas_id, one new object per new cas_id and per
empty file, and (with ``SD_CHUNK_MANIFESTS=1``) chunk manifests; with
sync emitting it logs, in the same transaction, each file's ``cas_id`` and
``object_id`` updates and each new object's create (reference :445-545;
the object's create carries the row's ``date_created``, where the
reference's carries the time of the commit, which no row has). The job
runs them on the streaming executor (:mod:`..pipeline`: sharded gather,
group commit, adaptive pages) unless ``SD_PIPELINE=0``, when
``execute_step`` runs the same three back to back: one implementation, two
schedules, the same rows.

After each committed batch the job hands the top-level directories of its
newly identified thumbnailable files to the locations actor, which spawns a
media-lane job for each (``_media_warm_start``, reference :544-596), so
thumbnails start while identify still hashes. The ``hash`` fault seam sits
before each hash dispatch.

:func:`shallow_identify` runs the same job inline, without a worker, for
the location watcher.

Unlike the JAX job there is no CPU re-dispatch of a failed hash batch
(reference :378-397): on the card a kernel failure raises in the dispatch
stage and fails the job, so ``sd_recovered_batches_total`` stays 0.

Telemetry: the gather runs in an ``identifier.gather`` span pinned to its
page (:func:`..pipeline.executor.page_span`; on the gather threads the
reference's opens under the slice's ``pipeline.gather`` instead), the hash
dispatch in an ``identifier.hash`` span, which closes after the digests
and the chunk flags reached the host; the report's ``gather_s`` and
``hash_time`` are their durations. ``sd_quarantined_files_total``,
``sd_scan_batch_size`` and, after an un-resumed pass, ``sd_scan_files_per_sec``
(files over the job trace's elapsed time).
"""

from __future__ import annotations

import logging
import os
import uuid
from typing import Any

from .. import faults, telemetry
from ..jobs import EarlyFinish, JobContext, JobError, StatefulJob, StepResult
from ..models import FilePath, Location, Object, utc_now
from ..sync.crdt import ref
from ..sync.manager import emitter
from . import manifest as chunk_manifest
from .cas import read_sampled_batch_fast as read_sampled_batch
from .hasher import get_hasher
from .magic import HEADER_LEN, resolve_kind

logger = logging.getLogger(__name__)

_QUARANTINED = telemetry.counter(
    "sd_quarantined_files_total",
    "per-item failures quarantined by the identifier")
_SCAN_RATE = telemetry.gauge(
    "sd_scan_files_per_sec",
    "files/s of the most recent completed identify pass")
_BATCH_GAUGE = telemetry.gauge(
    "sd_scan_batch_size",
    "files per scan page after adaptive sizing (the fixed BATCH_SIZE "
    "when adaptation is pinned off)")

#: files per step = device batch size
BATCH_SIZE = 1024

#: adaptive page-size clamps: pages shrink toward finer pipelining when the
#: hash stage dominates and grow to amortize per-page fixed costs when the
#: gather or the commit does
ADAPT_MIN_BATCH = 256
ADAPT_MAX_BATCH = 4096


def _env_batch_pin() -> int | None:
    """An explicit page size (``SD_SCAN_BATCH``): adaptation off, every
    page exactly this many files."""
    raw = os.environ.get("SD_SCAN_BATCH", "").strip()
    if raw:
        try:
            return max(1, int(raw))
        except ValueError:
            return None
    return None


def _adaptive_batching() -> bool:
    """Adaptive page sizing is live only at the stock configuration: a
    changed ``BATCH_SIZE`` (tests pin page boundaries), ``SD_SCAN_BATCH`` or
    ``SD_SCAN_ADAPT=0`` all mean fixed pages, whose boundaries then match
    the sequential schedule's exactly."""
    if BATCH_SIZE != 1024 or _env_batch_pin() is not None:
        return False
    return os.environ.get("SD_SCAN_ADAPT", "1").lower() not in ("0", "false", "off")


def _page_limit(scratch: dict) -> int:
    """Files in the next page. With adaptation live, sized from the
    executor's measured stage shares (``scratch['stage_shares']``, target:
    no stage above 60% of the pipeline wall): a dominant hash stage shrinks
    pages, a dominant gather or commit stage grows them, and a balanced
    pipeline drifts back toward ``BATCH_SIZE``. Only the prefetch (or
    split) thread touches ``scratch``."""
    pin = _env_batch_pin()
    if pin is not None:
        return pin
    if not _adaptive_batching():
        return BATCH_SIZE
    cur = int(scratch.get("batch_size") or BATCH_SIZE)
    shares = scratch.get("stage_shares")
    if shares:
        dominant = max(shares, key=shares.get)
        if shares[dominant] > 0.6:
            if dominant == "hash":
                cur = max(cur * 3 // 4, ADAPT_MIN_BATCH)
            else:
                cur = min(cur * 3 // 2, ADAPT_MAX_BATCH)
        else:
            cur += (BATCH_SIZE - cur) // 4
    scratch["batch_size"] = cur
    _BATCH_GAUGE.set(cur)
    return cur


def _orphan_where(location_id: int, sub_path: str | None) -> tuple[str, list]:
    sql = 'object_id IS NULL AND is_dir = 0 AND location_id = ? AND name != ""'
    params: list[Any] = [location_id]
    if sub_path:
        sql += " AND materialized_path LIKE ?"
        params.append(f"/{sub_path.strip('/')}/%")
    return sql, params


#: the columns a page reads (undecoded: date_created stays an ISO string)
_PAGE_COLUMNS = ("SELECT id, pub_id, name, extension, materialized_path, is_dir, "
                 "size_in_bytes, date_created FROM file_path")


def _iso(value) -> str:
    """A row's date as the wire carries it."""
    return value.isoformat() if hasattr(value, "isoformat") else value


def abs_path(location_path: str, row: dict) -> str:
    name = row["name"] or ""
    ext = row["extension"] or ""
    full = f"{name}.{ext}" if ext and not row["is_dir"] else name
    return f"{location_path}{row['materialized_path']}{full}"


class FileIdentifierJob(StatefulJob):
    NAME = "file_identifier"

    def finalize(self, ctx: JobContext, data: dict, run_metadata: dict):
        ctx.library.emit("invalidate_query", {"key": "search.paths"})
        ctx.library.emit("invalidate_query", {"key": "search.objects"})
        # files over the job trace's elapsed time, for an un-resumed pass
        # only: a resumed run's trace covers just its own part
        trace = getattr(ctx, "trace", None)
        total = run_metadata.get("total_orphan_paths") or 0
        worker = getattr(ctx, "_worker", None)
        resumed = worker is not None and getattr(worker.dyn_job, "was_resumed", False)
        if trace is not None and total and not resumed:
            elapsed = trace.elapsed_s()
            if elapsed > 0:
                _SCAN_RATE.set(round(total / elapsed, 1))
        return super().finalize(ctx, data, run_metadata)

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
        # steps from the effective page size: an SD_SCAN_BATCH pin below
        # the default would otherwise run out of steps with orphans left
        page = _env_batch_pin() or BATCH_SIZE
        steps = [{"kind": "identify"} for _ in range(-(-count // page))]
        data = {"location_id": location_id, "location_path": location["path"],
                "hasher": location.get("hasher"), "cursor": 0,
                "sub_path": self.init_args.get("sub_path"),
                "preview_media": location.get("generate_preview_media") is not False}
        return data, steps, {"total_orphan_paths": count, "created_objects": 0,
                             "linked_objects": 0, "hash_time": 0.0,
                             "quarantined_files": 0, "chunked_files": 0,
                             "chunk_quarantined": 0}

    def pipeline_spec(self):
        from ..pipeline import PipelineSpec

        return PipelineSpec(page=self.pipeline_page, process=self.pipeline_process,
                            commit=self.pipeline_commit, split=self.pipeline_page_split,
                            shard=self.pipeline_page_shard, merge=self.pipeline_page_merge,
                            adaptive=_adaptive_batching())

    def execute_step(self, ctx: JobContext, data: dict, step: dict,
                     step_number: int) -> StepResult:
        # the sequential schedule: the pipeline's stages back to back
        scratch = {"cursor": data["cursor"]}
        batch = self.pipeline_page(ctx, data, scratch)
        if batch is None:
            return StepResult()
        return self.pipeline_commit(ctx, data, self.pipeline_process(ctx, data, batch))

    # -- stage 1: page (DB reads + file I/O only) ----------------------------
    def pipeline_page(self, ctx: JobContext, data: dict, scratch: dict) -> dict | None:
        """The next page after the speculative cursor in ``scratch``: rows
        at id <= that cursor are untouched by later commits, so a page read
        ahead sees exactly the rows the sequential loop would."""
        db = ctx.library.db
        cursor = scratch.get("cursor", data["cursor"])
        where, params = _orphan_where(data["location_id"], data.get("sub_path"))
        rows = [dict(r) for r in db.query(
            f"{_PAGE_COLUMNS} WHERE {where} AND id > ? ORDER BY id LIMIT ?",
            params + [cursor, _page_limit(scratch)])]
        if not rows:
            return None
        scratch["cursor"] = rows[-1]["id"]
        hashable, empty, messages, gather_s = self._gather_rows(ctx, data, rows)
        return {"cursor": rows[-1]["id"], "hashable": hashable, "empty": empty,
                "messages": messages, "gather_s": gather_s}

    def _gather_rows(self, ctx: JobContext, data: dict,
                     rows: list[dict]) -> tuple[list, list, list, float]:
        """A page's (or a page slice's) rows → ``(hashable, empty, messages,
        gather_s)``: the size split, the cas gather, the manifest payload
        gather and the magic head. The whole-page and the sharded paths
        share it, so a merged page equals a sequential one."""
        hashable = [r for r in rows if (r["size_in_bytes"] or 0) > 0]
        empty = [r for r in rows if (r["size_in_bytes"] or 0) <= 0]
        paths = [abs_path(data["location_path"], r) for r in hashable]
        from ..pipeline.executor import page_span

        with telemetry.span(getattr(ctx, "trace", None), "identifier.gather",
                            parent=page_span(), files=len(hashable)) as gather_sp:
            messages = read_sampled_batch(paths, [r["size_in_bytes"] for r in hashable])
            gather_sp.set(bytes=sum(len(m) for m in messages
                                    if not isinstance(m, Exception)))
            if chunk_manifest.manifests_enabled():
                chunk_manifest.pipeline_chunk_gather(paths, hashable, messages)
        gather_s = gather_sp.duration_s
        # the cas message is size_le_8 ‖ header ‖ …: its head is the file's
        # first bytes, so magic-byte kind resolution needs no second read
        for row, msg in zip(hashable, messages):
            row["_kind_head"] = None if isinstance(msg, Exception) else bytes(msg[8:8 + HEADER_LEN])
        for row in empty:
            row["_kind_head"] = b""
        return hashable, empty, messages, gather_s

    # -- stage 1, sharded: split → parallel slices → merge --------------------
    def pipeline_page_split(self, ctx: JobContext, data: dict, scratch: dict) -> dict | None:
        """One id-only cursor read, cut into contiguous id ranges, one a
        gather shard. The slices' rows concatenate back into exactly the
        rows, in the order, of the unsharded read of the same window."""
        db = ctx.library.db
        cursor = scratch.get("cursor", data["cursor"])
        where, params = _orphan_where(data["location_id"], data.get("sub_path"))
        ids = [r["id"] for r in db.query(
            f"SELECT id FROM file_path WHERE {where} AND id > ? ORDER BY id LIMIT ?",
            params + [cursor, _page_limit(scratch)])]
        if not ids:
            return None
        scratch["cursor"] = ids[-1]
        shards = max(1, int(scratch.get("shards") or 1))
        per = -(-len(ids) // shards)
        parts = [{"lo": ids[lo], "hi": ids[min(lo + per, len(ids)) - 1]}
                 for lo in range(0, len(ids), per)]
        return {"cursor": ids[-1], "parts": parts}

    def pipeline_page_shard(self, ctx: JobContext, data: dict, part: dict) -> dict:
        """One slice's row read and gather; read-only, safe beside the
        other slices."""
        where, params = _orphan_where(data["location_id"], data.get("sub_path"))
        rows = [dict(r) for r in ctx.library.db.query(
            f"{_PAGE_COLUMNS} WHERE {where} AND id >= ? AND id <= ? ORDER BY id",
            params + [part["lo"], part["hi"]])]
        hashable, empty, messages, gather_s = self._gather_rows(ctx, data, rows)
        return {"hashable": hashable, "empty": empty, "messages": messages,
                "gather_s": gather_s}

    def pipeline_page_merge(self, ctx: JobContext, data: dict, header: dict,
                            results: list[dict]) -> dict:
        """The slices, in slice (= id) order, as the payload
        ``pipeline_page`` returns; ``gather_s`` is the longest slice's, the
        page's gather wall."""
        hashable: list = []
        empty: list = []
        messages: list = []
        for res in results:
            hashable.extend(res["hashable"])
            empty.extend(res["empty"])
            messages.extend(res["messages"])
        return {"cursor": header["cursor"], "hashable": hashable, "empty": empty,
                "messages": messages, "gather_s": max(r["gather_s"] for r in results)}

    # -- stage 2: process (device compute) -----------------------------------
    def pipeline_process(self, ctx: JobContext, data: dict, batch: dict) -> dict:
        """The cas hash and the manifest chunking on the node's device. On
        the card the kernels launch from this stage's thread, with the
        device passed explicitly; an error raises through."""
        hasher = get_hasher(data.get("hasher"), ctx.node)
        trace = getattr(ctx, "trace", None)
        # the span closes after the digests reached the host (hash_gathered
        # returns hex strings); the chunk stage has its own span
        with telemetry.span(trace, "identifier.hash",
                            files=len(batch["hashable"])) as hash_sp:
            faults.inject("hash")
            batch["cas_results"] = hasher.hash_gathered(batch["messages"])
        batch["hash_s"] = hash_sp.duration_s
        batch["messages"] = None  # the gathered bytes are dead weight now
        if chunk_manifest.manifests_enabled():
            chunk_manifest.pipeline_chunk_process(batch["hashable"], ctx.node.device,
                                                  trace=trace)
        return batch

    # -- stage 3: commit (the only stage that writes) ------------------------
    def pipeline_commit(self, ctx: JobContext, data: dict, batch: dict) -> StepResult:
        """Under group commit this transaction joins the group's, and its
        reads go through the writer on this thread: a later page of the
        group sees the objects an earlier page created, so copies of one
        file in two pages of a group share one object."""
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
        if quarantined:
            _QUARANTINED.inc(quarantined)
        chunk_errors: list[str] = []
        if chunk_manifest.manifests_enabled():
            chunk_errors = chunk_manifest.quarantine_errors(hashable, location_path)
            errors.extend(chunk_errors)

        sync = emitter(ctx.library)
        ops: list = []  # logged in the transaction of the writes they describe
        with db.transaction():
            # 1. write cas_ids
            db.executemany("UPDATE file_path SET cas_id = ? WHERE id = ?",
                           [(cas, row["id"]) for row, cas in identified])
            if sync is not None:
                ops += [sync.shared_update(FilePath, row["pub_id"], "cas_id", cas)
                        for row, cas in identified]

            # 2. link to existing objects owning these cas_ids
            cas_ids = sorted({cas for _, cas in identified})
            existing: dict[str, tuple[int, str]] = {}
            for start in range(0, len(cas_ids), 500):
                chunk = cas_ids[start : start + 500]
                marks = ",".join("?" for _ in chunk)
                for r in db.query(
                        f"SELECT fp.cas_id AS cas_id, o.id AS oid, o.pub_id AS opub "
                        f"FROM file_path fp JOIN object o ON fp.object_id = o.id "
                        f"WHERE fp.cas_id IN ({marks})", chunk):
                    existing.setdefault(r["cas_id"], (r["oid"], r["opub"]))
            link_rows: list[tuple[int, int]] = []  # (object_id, file_path_id)
            need_object: dict[str, list[dict]] = {}
            for row, cas in identified:
                if cas in existing:
                    oid, opub = existing[cas]
                    link_rows.append((oid, row["id"]))
                    if sync is not None:
                        ops.append(sync.shared_update(FilePath, row["pub_id"], "object_id",
                                                      ref(Object.TABLE, opub)))
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
                    if sync is not None:
                        ops.append(sync.shared_create(Object, obj["pub_id"], {
                            "kind": obj["kind"],
                            "date_created": _iso(obj["date_created"])}))
                    for row in members:
                        link_rows.append((oid_of[obj["pub_id"]], row["id"]))
                        if sync is not None:
                            ops.append(sync.shared_update(FilePath, row["pub_id"], "object_id",
                                                          ref(Object.TABLE, obj["pub_id"])))
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
            if ops:
                sync.log_ops(ops)
        # the cursor advances only after the transaction committed
        data["cursor"] = batch["cursor"]
        # best effort from here on: the batch is durable, and an exception
        # out of this call would make the committer retry it (and log every
        # operation of the batch again)
        try:
            if ops:
                sync.created()
            self._media_warm_start(ctx, data, identified)
            ctx.progress(message=f"identified {len(identified)} files ({len(creations)} new "
                                 f"objects, {linked} linked)")
        except Exception:
            logger.exception("post-commit media warm start failed (the batch is committed)")
        return StepResult(metadata={"created_objects": len(creations),
                                    "linked_objects": linked,
                                    "hash_time": batch["hash_s"],
                                    "gather_s": batch["gather_s"],
                                    "quarantined_files": quarantined,
                                    "chunked_files": chunked,
                                    "chunk_quarantined": len(chunk_errors)},
                          errors=errors)

    def _media_warm_start(self, ctx: JobContext, data: dict,
                          identified: list[tuple[dict, str]]) -> None:
        """Hand the top-level directories of the batch's thumbnailable files
        to the locations actor, which starts media-lane jobs on them while
        this job hashes the rest; the chain's whole-location media job
        takes up what they miss."""
        actor = getattr(ctx.node, "locations", None)
        if actor is None or not data.get("preview_media", True):
            return
        from .media.processor import thumbable_extensions

        exts = thumbable_extensions()
        prefixes = set()
        for row, _cas in identified:
            if (row.get("extension") or "").lower() in exts:
                mp = (row.get("materialized_path") or "/").strip("/")
                if mp:
                    prefixes.add(mp.split("/")[0])
        if prefixes:
            actor.media_warm_start(ctx.library, data["location_id"], prefixes)

    def _object_row(self, row: dict, location_path: str) -> dict:
        # magic-byte disambiguation for conflicting/unknown extensions; the
        # head bytes came with the gather
        kind = resolve_kind(row.get("extension"), abs_path(location_path, row),
                            bool(row.get("is_dir")), head=row.get("_kind_head"))
        return {"pub_id": str(uuid.uuid4()), "kind": kind,
                "date_created": row.get("date_created") or utc_now()}


class _ShallowContext:
    """What :class:`FileIdentifierJob` reads from its context when it runs
    without a worker: the library, the node (its device, hasher and
    locations actor), and no-op progress and command polls."""

    def __init__(self, library) -> None:
        self.library = library
        self.node = library.node

    def progress(self, *args, **kwargs) -> None:
        pass

    def check_commands(self, *args) -> None:
        pass


def shallow_identify(library, location_id: int) -> dict[str, Any]:
    """Identify the location's orphan rows inline on
    the calling thread, without a job: the job's ``init`` and its
    sequential steps, on the node's device. The location watcher runs it
    after each flush (reference ``file_identifier.py`` :642-665)."""
    job = FileIdentifierJob({"location_id": location_id})
    ctx = _ShallowContext(library)
    try:
        data, steps, meta = job.init(ctx)
    except EarlyFinish:
        return {"identified": 0}
    for i, step in enumerate(steps):
        job.execute_step(ctx, data, step, i)
    return {"identified": meta.get("total_orphan_paths", 0)}
