"""ObjectValidatorJob: full-file BLAKE3 integrity checksums, on the card.

Counterpart of ``spacedrive_tpu/objects/validator.py``: for every file_path
of a location (or of a ``sub_path``) that has a cas_id and no
``integrity_checksum``, hash the whole file (not the sampled cas message)
and store the digest; with ``revalidate``, hash the files that have one too
and report each that changed as an ``integrity MISMATCH`` error (bit rot,
tampering), leaving its stored checksum as it was.

The reference hashes on the host (native mmap, 512-chunk windows and a merge
stack). The port hashes a step's files together on the node's device
(:func:`full_file_hashes`): windows of 2 MiB through both BLAKE3 kernels,
then the tree above them (``ops.blake3.blake3_long_hex``); the digests are
the same. Host and device memory are bounded by the staging buffers, not by
the files' sizes. Windows are read with ``os.preadv`` into the pinned
staging buffer from a few threads, and the interpreter lock is released
while a read waits. An unreadable file is an error line and the step goes
on, as in the reference; a failed kernel build or launch raises and fails
the job.
"""

from __future__ import annotations

import collections
import logging
import os
from typing import Any

from ..jobs import EarlyFinish, JobContext, JobError, StatefulJob, StepResult
from ..models import FilePath, Location
from ..ops import _kernels
from ..ops.blake3 import blake3_long_hex
from .file_identifier import abs_path

logger = logging.getLogger(__name__)

BATCH = 100

#: the long-message route's ``stats`` summed over every call (``read_s``,
#: ``h2d_s``, ``kernel_s``, ``bytes``, ``windows``, ``batches``, ``levels``)
#: and ``files``; :func:`reset_counts` zeroes them
STATS: collections.Counter = collections.Counter()


def reset_counts() -> None:
    STATS.clear()


class FileMessage:
    """A file as a source of the long-message route: opened once, its
    length from ``fstat``, read with ``os.preadv`` (no interpreter lock
    while it waits)."""

    def __init__(self, path) -> None:
        self.path = path
        self.fd = os.open(path, os.O_RDONLY)
        self.length = os.fstat(self.fd).st_size

    def read_into(self, offset: int, out: memoryview) -> None:
        got = 0
        while got < len(out):
            n = os.preadv(self.fd, [out[got:]], offset + got)
            if n == 0:
                raise OSError(f"{self.path}: the file ended at {offset + got} bytes, "
                              f"{self.length} expected")
            got += n

    def close(self) -> None:
        os.close(self.fd)


def full_file_hashes(paths: list, device=None, **kwargs) -> list:
    """Full-file BLAKE3 hex digests of ``paths`` on ``device`` (default the
    card); a file that cannot be opened or read comes back as its
    ``OSError``, in place. ``kwargs`` go to ``blake3_long_hex``; its
    ``stats`` are also summed into :data:`STATS`."""
    from .. import resolve_device

    dev = resolve_device(device)
    caller_stats = kwargs.pop("stats", None)
    sources: list = []
    try:
        for path in paths:
            try:
                sources.append(FileMessage(path))
            except OSError as e:
                sources.append(e)
        stats: dict = {}
        with _kernels.tagged("validator"):
            out = blake3_long_hex(sources, dev, stats=stats, **kwargs)
        STATS.update(stats)
        STATS["files"] += len(paths)
        if caller_stats is not None:
            caller_stats.update(stats)
        return out
    finally:
        for s in sources:
            if isinstance(s, FileMessage):
                s.close()


class ObjectValidatorJob(StatefulJob):
    """init_args: location_id, sub_path?, revalidate? (check existing sums)."""

    NAME = "object_validator"

    def init(self, ctx: JobContext):
        db = ctx.library.db
        location_id = self.init_args["location_id"]
        if db.find_one(Location, {"id": location_id}) is None:
            raise JobError(f"location {location_id} not found")
        revalidate = bool(self.init_args.get("revalidate"))
        where = "location_id = ? AND is_dir = 0 AND cas_id IS NOT NULL"
        params: list[Any] = [location_id]
        if not revalidate:
            where += " AND integrity_checksum IS NULL"
        if self.init_args.get("sub_path"):
            where += " AND materialized_path LIKE ?"
            params.append(f"/{self.init_args['sub_path'].strip('/')}/%")
        count = db.query(f"SELECT COUNT(*) n FROM file_path WHERE {where}", params)[0]["n"]
        if count == 0:
            raise EarlyFinish("no file paths to validate")
        steps = [{"kind": "validate"} for _ in range(-(-count // BATCH))]
        return ({"location_id": location_id, "where": where, "params": params,
                 "cursor": 0, "revalidate": revalidate},
                steps, {"validated": 0, "mismatched": 0})

    def execute_step(self, ctx: JobContext, data, step, step_number) -> StepResult:
        db = ctx.library.db
        rows = [FilePath.decode_row(r) for r in db.query(
            f"SELECT * FROM file_path WHERE {data['where']} AND id > ? "
            f"ORDER BY id LIMIT ?", data["params"] + [data["cursor"], BATCH])]
        if not rows:
            return StepResult()
        data["cursor"] = rows[-1]["id"]
        errors, validated, mismatched = [], 0, 0
        location = db.find_one(Location, {"id": data["location_id"]})
        if location is None:
            missing = JobError(f"location {data['location_id']} not found")
            checksums: list = [missing] * len(rows)
        else:
            checksums = full_file_hashes([abs_path(location["path"], r) for r in rows],
                                         ctx.node.device)
        with db.transaction():
            for row, checksum in zip(rows, checksums):
                if isinstance(checksum, Exception):
                    errors.append(f"validate {row['name']}: {checksum}")
                    continue
                if data["revalidate"] and row["integrity_checksum"]:
                    if row["integrity_checksum"] != checksum:
                        mismatched += 1
                        errors.append(
                            f"integrity MISMATCH {row['materialized_path']}{row['name']}: "
                            f"stored {row['integrity_checksum'][:16]}… != {checksum[:16]}…")
                        continue
                db.update(FilePath, {"id": row["id"]}, {"integrity_checksum": checksum})
                validated += 1
        return StepResult(metadata={"validated": validated, "mismatched": mismatched},
                          errors=errors)

    def finalize(self, ctx: JobContext, data, run_metadata):
        logger.info("validator finished: %s", run_metadata)
        return run_metadata
