"""Filesystem operation jobs: copy, cut (move), delete, erase, create.

Counterpart of ``spacedrive_tpu/objects/fs.py``. Each job is a
:class:`..jobs.StatefulJob` with JSON steps a file, so a shutdown mid-copy
resumes where it left off:

- :class:`FileCopierJob`: a step a file; a directory expands into its
  children's steps during the run; a name collision resolves to
  ``name (2).ext``.
- :class:`FileCutterJob`: a rename on one device, a copy and an unlink
  across devices; an existing destination is an error, never overwritten.
- :class:`FileDeleterJob`: removes files and directory trees and their rows.
- :class:`FileEraserJob`: overwrites each file with random bytes
  ``passes`` times, then unlinks it.
- :func:`create_file` / :func:`create_directory`: collision-safe creation.

The copier and the cutter end with a light rescan of the directories they
touched (the reference leans on the watcher, and a node without one needs
the rescan). :func:`_remove_rows` drops rows (with sync emitting, logging
their deletes in the same transaction, reference :286-306) and wakes the
library's orphan remover.
"""

from __future__ import annotations

import logging
import os
import secrets
import shutil
from pathlib import Path
from typing import Any

from ..jobs import EarlyFinish, JobContext, JobError, StatefulJob, StepResult
from ..models import FilePath, Location
from ..sync.manager import emitter

logger = logging.getLogger(__name__)

ERASE_BLOCK = 1 << 20  # 1 MiB overwrite blocks


def location_path_of(db, location_id: int) -> Path:
    row = db.find_one(Location, {"id": location_id})
    if row is None:
        raise JobError(f"location {location_id} not found")
    return Path(row["path"])


def file_path_abs(db, file_path_id: int) -> tuple[dict[str, Any], Path]:
    row = db.find_one(FilePath, {"id": file_path_id})
    if row is None:
        raise JobError(f"file_path {file_path_id} not found")
    root = location_path_of(db, row["location_id"])
    rel = (row["materialized_path"] or "/").lstrip("/")
    name = row["name"] + (f".{row['extension']}" if row["extension"] else "")
    return row, root / rel / name


def find_available_name(target: Path) -> Path:
    """'duplicate.txt' -> 'duplicate (2).txt', the first free one."""
    if not target.exists():
        return target
    stem, suffix = target.stem, target.suffix
    for i in range(2, 1000):
        candidate = target.with_name(f"{stem} ({i}){suffix}")
        if not candidate.exists():
            return candidate
    raise JobError(f"no available name for {target}")


def create_file(parent: Path, name: str, content: bytes = b"") -> Path:
    target = find_available_name(parent / name)
    with open(target, "xb") as fh:
        fh.write(content)
    return target


def create_directory(parent: Path, name: str) -> Path:
    target = find_available_name(parent / name)
    target.mkdir()
    return target


class _FsJob(StatefulJob):
    """Shared: the sources as rows and absolute paths, and the rescan."""

    def _sources(self, ctx: JobContext) -> list[tuple[dict[str, Any], Path]]:
        db = ctx.library.db
        return [file_path_abs(db, fp_id) for fp_id in self.init_args["sources"]]

    def _rescan(self, ctx: JobContext, location_id: int, dirs: set[str]) -> None:
        from ..locations import light_scan_location

        for sub in sorted(dirs):
            try:
                light_scan_location(ctx.library, location_id, sub)
            except Exception:
                logger.exception("post-op rescan failed for %r", sub)


class FileCopierJob(_FsJob):
    """init_args: sources (file_path ids), target_location_id, target_dir
    (location-relative, '' = the root)."""

    NAME = "file_copier"

    def init(self, ctx: JobContext):
        db = ctx.library.db
        target_root = location_path_of(db, self.init_args["target_location_id"])
        target_dir = target_root / self.init_args.get("target_dir", "").strip("/")
        if not target_dir.is_dir():
            raise JobError(f"target directory missing: {target_dir}")
        steps = [{"kind": "dir" if row["is_dir"] else "file",
                  "src": str(src), "dst": str(target_dir / src.name)}
                 for row, src in self._sources(ctx)]
        if not steps:
            raise EarlyFinish("nothing to copy")
        return ({"target_location_id": self.init_args["target_location_id"],
                 "target_dir": self.init_args.get("target_dir", "")},
                steps, {"copied": 0, "bytes": 0})

    def execute_step(self, ctx: JobContext, data, step, step_number) -> StepResult:
        src, dst = Path(step["src"]), Path(step["dst"])
        try:
            if step["kind"] == "dir":
                dst = find_available_name(dst)
                dst.mkdir()
                more = [{"kind": "dir" if entry.is_dir(follow_symlinks=False) else "file",
                         "src": entry.path, "dst": str(dst / entry.name)}
                        for entry in sorted(os.scandir(src), key=lambda e: e.name)]
                return StepResult(more_steps=more, metadata={"copied": 1})
            dst = find_available_name(dst)
            shutil.copy2(src, dst)
            return StepResult(metadata={"copied": 1, "bytes": src.stat().st_size})
        except OSError as e:
            return StepResult(errors=[f"copy {src}: {e}"])

    def finalize(self, ctx: JobContext, data, run_metadata):
        self._rescan(ctx, data["target_location_id"], {data["target_dir"]})
        ctx.library.emit("invalidate_query", {"key": "search.paths"})
        return run_metadata


class FileCutterJob(_FsJob):
    """Move: a rename where it can, else a copy and a delete."""

    NAME = "file_cutter"

    def init(self, ctx: JobContext):
        db = ctx.library.db
        target_root = location_path_of(db, self.init_args["target_location_id"])
        target_dir = target_root / self.init_args.get("target_dir", "").strip("/")
        if not target_dir.is_dir():
            raise JobError(f"target directory missing: {target_dir}")
        steps, source_dirs = [], set()
        for row, src in self._sources(ctx):
            steps.append({"src": str(src), "dst": str(target_dir / src.name)})
            source_dirs.add((row["location_id"], (row["materialized_path"] or "/").strip("/")))
        if not steps:
            raise EarlyFinish("nothing to move")
        return ({"target_location_id": self.init_args["target_location_id"],
                 "target_dir": self.init_args.get("target_dir", ""),
                 "source_dirs": sorted(source_dirs)},
                steps, {"moved": 0})

    def execute_step(self, ctx: JobContext, data, step, step_number) -> StepResult:
        src, dst = Path(step["src"]), Path(step["dst"])
        # a move onto itself does nothing; an existing destination is never
        # overwritten
        if src == dst:
            return StepResult(metadata={"moved": 0})
        if dst.exists():
            return StepResult(errors=[f"move {src}: would overwrite {dst}"])
        try:
            try:
                os.rename(src, dst)
            except OSError:
                if src.is_dir():
                    shutil.copytree(src, dst)
                    shutil.rmtree(src)
                else:
                    shutil.copy2(src, dst)
                    src.unlink()
            return StepResult(metadata={"moved": 1})
        except OSError as e:
            return StepResult(errors=[f"move {src}: {e}"])

    def finalize(self, ctx: JobContext, data, run_metadata):
        for loc_id, sub in data["source_dirs"]:
            self._rescan(ctx, loc_id, {sub})
        self._rescan(ctx, data["target_location_id"], {data["target_dir"]})
        ctx.library.emit("invalidate_query", {"key": "search.paths"})
        return run_metadata


class FileDeleterJob(_FsJob):
    NAME = "file_deleter"

    def init(self, ctx: JobContext):
        steps = [{"file_path_id": fp} for fp in self.init_args["sources"]]
        if not steps:
            raise EarlyFinish("nothing to delete")
        return {}, steps, {"deleted": 0}

    def execute_step(self, ctx: JobContext, data, step, step_number) -> StepResult:
        try:
            row, path = file_path_abs(ctx.library.db, step["file_path_id"])
        except JobError:
            return StepResult(metadata={"deleted": 0})  # the row is already gone
        try:
            if row["is_dir"]:
                shutil.rmtree(path, ignore_errors=False)
            else:
                path.unlink(missing_ok=True)
        except OSError as e:
            return StepResult(errors=[f"delete {path}: {e}"])
        _remove_rows(ctx.library, row)
        return StepResult(metadata={"deleted": 1})

    def finalize(self, ctx: JobContext, data, run_metadata):
        ctx.library.emit("invalidate_query", {"key": "search.paths"})
        return run_metadata


class FileEraserJob(_FsJob):
    """Overwrite, then delete. init_args: sources, passes (default 2)."""

    NAME = "file_eraser"

    def init(self, ctx: JobContext):
        steps = []
        for row, src in self._sources(ctx):
            if row["is_dir"]:
                # every file of the tree, then the tree itself
                for dirpath, _dirnames, filenames in os.walk(src):
                    for fname in filenames:
                        steps.append({"path": str(Path(dirpath) / fname), "file_path_id": None})
                steps.append({"rmtree": str(src), "file_path_id": row["id"]})
            else:
                steps.append({"path": str(src), "file_path_id": row["id"]})
        if not steps:
            raise EarlyFinish("nothing to erase")
        return {"passes": int(self.init_args.get("passes", 2))}, steps, {"erased": 0}

    def execute_step(self, ctx: JobContext, data, step, step_number) -> StepResult:
        db = ctx.library.db
        if "rmtree" in step:
            try:
                shutil.rmtree(step["rmtree"], ignore_errors=True)
            except OSError as e:
                return StepResult(errors=[f"rmtree {step['rmtree']}: {e}"])
            row = db.find_one(FilePath, {"id": step["file_path_id"]})
            if row:
                _remove_rows(ctx.library, row)
            return StepResult(metadata={"erased": 1})
        path = Path(step["path"])
        try:
            size = path.stat().st_size
            with open(path, "r+b", buffering=0) as fh:
                for _ in range(data["passes"]):
                    fh.seek(0)
                    remaining = size
                    while remaining > 0:
                        n = min(ERASE_BLOCK, remaining)
                        fh.write(secrets.token_bytes(n))
                        remaining -= n
                    fh.flush()
                    os.fsync(fh.fileno())
            path.unlink()
        except OSError as e:
            return StepResult(errors=[f"erase {path}: {e}"])
        if step["file_path_id"] is not None:
            row = db.find_one(FilePath, {"id": step["file_path_id"]})
            if row:
                _remove_rows(ctx.library, row)
        return StepResult(metadata={"erased": 1})

    def finalize(self, ctx: JobContext, data, run_metadata):
        ctx.library.emit("invalidate_query", {"key": "search.paths"})
        return run_metadata


def _remove_rows(library, row: dict[str, Any]) -> None:
    """Drop the file_path row (and a directory's subtree) in one
    transaction, with its sync deletes, then wake the orphan remover: the
    paths may have been their objects' last."""
    db = library.db
    rows = [row]
    if row["is_dir"]:
        prefix = f"{(row['materialized_path'] or '/')}{row['name']}/"
        rows += [r for r in db.find(FilePath, {"location_id": row["location_id"]})
                 if (r["materialized_path"] or "").startswith(prefix)]
    sync = emitter(library)
    with db.transaction():
        for r in rows:
            db.delete(FilePath, {"id": r["id"]})
        if sync is not None:
            sync.log_ops([sync.shared_delete(FilePath, r["pub_id"]) for r in rows])
    if sync is not None:
        sync.created()
    remover = getattr(library, "orphan_remover", None)
    if remover is not None:
        remover.invoke()
