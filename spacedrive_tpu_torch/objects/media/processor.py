"""MediaProcessorJob: thumbnails and media metadata, chained after identify.

Counterpart of ``spacedrive_tpu/objects/media/processor.py`` (:38-186).
A step is 256 files, one device batch of the resize. The job runs on the
streaming pipeline (:mod:`...pipeline`) unless ``SD_PIPELINE=0``:
``pipeline_page`` reads the step's rows, ``pipeline_process`` decodes,
resizes on the node's device, encodes and reads EXIF (no database), and
``pipeline_commit`` upserts the ``media_data`` rows in one transaction and
emits a ``new_thumbnail`` event for each thumbnail. The job selects the
rows of every thumbnailable extension (images, HEIF images and videos, as
the reference's ``_thumbable_extensions`` :189); a file whose format has no
codec on this host (:func:`.thumbnail.can_generate_thumbnail`) gets no
thumbnail and no error, and its row only if the metadata extractor reads
it.

Two differences from the reference. Its ``tpuThumbnails`` feature gate is
not ported (the port has no feature flags): thumbnails always take the
batched route on the node's device. And a device failure fails the step
with its error: no file is then retried through PIL. A file whose host
decode or encode failed in the batch, and a video whose thumbnail failed,
is retried alone through :func:`.thumbnail.generate_thumbnail`, as in the
reference; :data:`SCALAR_RETRIES` counts those retries by extension, and a
retry that fails too is an error line.

The job runs in the media lane (``LANE``, :mod:`...jobs.manager`): beside
the default lane's scan chain, as the warm-start jobs the identify job
spawns for each identified prefix
(:meth:`...locations.manager.LocationsActor.media_warm_start`) do. A
thumbnail that exists already is not made again, but it still counts in
``thumbnails_created`` and gets a ``new_thumbnail`` event, as in the
reference.
"""

from __future__ import annotations

import logging
import time
from collections import Counter

from ...jobs import EarlyFinish, JobError, StatefulJob, StepResult
from ...models import FilePath, Location, MediaData
from ...ops._kernels import count
from ..file_identifier import abs_path
from .metadata import extract_media_data
from .thumbnail import (HEIF_EXTENSIONS, THUMBNAILABLE_IMAGE_EXTENSIONS,
                        THUMBNAILABLE_VIDEO_EXTENSIONS, can_generate_thumbnail,
                        generate_thumbnail, generate_thumbnails_batched)

logger = logging.getLogger(__name__)

BATCH_SIZE = 256

#: files retried alone after a host decode or encode failure, by extension
SCALAR_RETRIES: Counter = Counter()


class MediaProcessorJob(StatefulJob):
    NAME = "media_processor"
    LANE = "media"

    def init(self, ctx):
        db = ctx.library.db
        location_id = self.init_args["location_id"]
        location = db.find_one(Location, {"id": location_id})
        if location is None:
            raise JobError(f"location {location_id} not found")
        if location.get("generate_preview_media") is False:
            raise EarlyFinish("preview media disabled for location")

        exts = sorted(thumbable_extensions())
        marks = ",".join("?" for _ in exts)
        sub = self.init_args.get("sub_path")
        sub_sql, sub_params = ("", [])
        if sub:
            sub_sql = " AND materialized_path LIKE ?"
            sub_params = [f"/{sub.strip('/')}/%"]
        rows = db.query(
            f"SELECT id FROM file_path WHERE location_id = ? AND is_dir = 0 "
            f"AND cas_id IS NOT NULL AND lower(extension) IN ({marks}){sub_sql} "
            f"ORDER BY id",
            [location_id, *exts, *sub_params],
        )
        ids = [r["id"] for r in rows]
        if not ids:
            raise EarlyFinish("no media to process")
        steps = [{"kind": "media", "ids": ids[i : i + BATCH_SIZE]}
                 for i in range(0, len(ids), BATCH_SIZE)]
        data = {"location_id": location_id, "location_path": location["path"]}
        return data, steps, {"thumbnails_created": 0, "media_data_extracted": 0,
                             "media_time": 0.0}

    def pipeline_spec(self):
        from ...pipeline import PipelineSpec

        return PipelineSpec(page=self.pipeline_page, process=self.pipeline_process,
                            commit=self.pipeline_commit)

    def execute_step(self, ctx, data: dict, step: dict, step_number: int) -> StepResult:
        scratch = {"steps": [step], "step_index": 0}
        batch = self.pipeline_page(ctx, data, scratch)
        if batch is None:
            return StepResult()
        return self.pipeline_commit(ctx, data, self.pipeline_process(ctx, data, batch))

    # -- stage 1: prefetch (row reads only) ----------------------------------
    def pipeline_page(self, ctx, data: dict, scratch: dict) -> dict | None:
        i = scratch.get("step_index", 0)
        steps = scratch.get("steps") or []
        if i >= len(steps):
            return None
        scratch["step_index"] = i + 1
        db = ctx.library.db
        entries = []  # (row, path, ext)
        for fp_id in steps[i]["ids"]:
            row = db.find_one(FilePath, {"id": fp_id})
            if row is None or not row.get("cas_id"):
                continue
            entries.append((row, abs_path(data["location_path"], row),
                            (row.get("extension") or "").lower()))
        return {"entries": entries}

    # -- stage 2: dispatch (decode, resize on the device, encode, EXIF) ------
    def pipeline_process(self, ctx, data: dict, batch: dict) -> dict:
        node = ctx.node
        errors: list[str] = []
        entries = batch["entries"]
        t0 = time.perf_counter()
        # the step is the device batch; a failure of the device resize
        # raises here and fails the step
        made = generate_thumbnails_batched(
            [(path, row["cas_id"], ext) for row, path, ext in entries
             if can_generate_thumbnail(ext)], node.data_dir, node.device)
        thumbed: list[str] = []  # cas_ids with a thumbnail
        media_rows: list[tuple[int, dict]] = []  # (object_id, fields)
        for row, path, ext in entries:
            try:
                if can_generate_thumbnail(ext):
                    out = made.get(row["cas_id"])
                    if out is None:
                        # the batch left it out (host decode or encode
                        # failed): retry it alone, and record a failure
                        count(SCALAR_RETRIES, ext)
                        out = generate_thumbnail(path, node.data_dir, row["cas_id"], ext)
                        if out is None:
                            errors.append(f"{path}: thumbnail failed (batched + scalar retry)")
                    if out is not None:
                        thumbed.append(row["cas_id"])
                media = extract_media_data(path, ext)
                if media and row.get("object_id"):
                    media_rows.append((row["object_id"], media))
            except Exception as e:
                errors.append(f"{path}: {e!r}")
        return {"thumbed": thumbed, "media_rows": media_rows, "errors": errors,
                "media_time": time.perf_counter() - t0}

    # -- stage 3: commit (media_data upserts, then the events) ---------------
    def pipeline_commit(self, ctx, data: dict, batch: dict) -> StepResult:
        db = ctx.library.db
        # one transaction a batch, which joins the executor's group commit
        with db.transaction():
            for object_id, media in batch["media_rows"]:
                db.upsert(MediaData, {"object_id": object_id}, media, media)
        for cas_id in batch["thumbed"]:
            ctx.library.emit("new_thumbnail", {"cas_id": cas_id})
        return StepResult(metadata={"thumbnails_created": len(batch["thumbed"]),
                                    "media_data_extracted": len(batch["media_rows"]),
                                    "media_time": batch["media_time"]},
                          errors=batch["errors"])

    def finalize(self, ctx, data: dict, run_metadata: dict):
        ctx.library.emit("invalidate_query", {"key": "search.paths"})
        logger.info("media_processor finished: %s", run_metadata)
        return run_metadata


def thumbable_extensions() -> set[str]:
    return THUMBNAILABLE_IMAGE_EXTENSIONS | THUMBNAILABLE_VIDEO_EXTENSIONS | HEIF_EXTENSIONS
