"""Filesystem walker: rules-filtered, DB-diffing, budgeted BFS.

Copy of spacedrive_tpu/locations/walker.py (without the single-directory
walk), which mirrors the semantics of core/src/location/indexer/walk.rs —
iterative walk applying rules per entry (:116-186), keep-walking
continuation for dirs beyond the budget (:187-240), and existing-path
diffing on (inode, device) + mtime >1ms delta (:355-372).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from collections import deque
from pathlib import Path
from typing import Any, Callable

from .paths import FilePathMetadata, IsolatedFilePathData
from .rules import CompiledRules

logger = logging.getLogger(__name__)

#: mtime delta below which a file is considered unchanged (walk.rs:361 uses 1ms)
MTIME_EPSILON_S = 0.001


@dataclasses.dataclass(frozen=True)
class WalkedEntry:
    iso: IsolatedFilePathData
    metadata: FilePathMetadata
    #: for updates: the matched DB row id, and whether content (not just the
    #: name — renames keep their cas_id/object) changed
    row_id: int | None = None
    content_changed: bool = True

    @property
    def rel_path(self) -> str:
        return self.iso.relative_path()


@dataclasses.dataclass
class WalkResult:
    walked: list[WalkedEntry]          # new entries to save
    to_update: list[WalkedEntry]       # existing entries whose metadata changed
    to_walk: list[str]                 # rel dir paths beyond the budget
    to_remove: list[dict[str, Any]]    # db rows no longer on disk
    errors: list[str]


DbFetcher = Callable[[str], list[dict[str, Any]]]
"""rel dir path -> existing file_path rows whose materialized_path is that dir
(the ``file_paths_db_fetcher_fn!`` seam, walk.rs)."""


def resolve_sub_path(root: Path, sub_path: str) -> Path:
    """Join + containment check: a sub_path may not escape the location root
    (the reference validates sub-paths via ensure_sub_path_is_in_location
    before walking). Raises ValueError with a clear message otherwise."""
    if not sub_path:
        return root
    start = (root / sub_path).resolve()
    if start != root.resolve() and root.resolve() not in start.parents:
        raise ValueError(f"sub_path {sub_path!r} escapes location root {root}")
    return start


def walk(
    location_id: int,
    location_path: str | Path,
    rules: CompiledRules,
    db_fetcher: DbFetcher | None = None,
    sub_path: str = "",
    limit: int = 50_000,
    include_root: bool = True,
) -> WalkResult:
    """BFS from ``location_path/sub_path``; stops enqueuing new directories
    into the in-walk queue once ``limit`` entries have been produced, returning
    the remainder as ``to_walk`` continuation dirs (indexer_job.rs:183-198)."""
    root = Path(location_path)
    start = resolve_sub_path(root, sub_path)
    result = WalkResult([], [], [], [], [])

    if include_root and not sub_path:
        try:
            st = start.stat()
            result.walked.append(WalkedEntry(
                IsolatedFilePathData(location_id, "/", "", "", True),
                FilePathMetadata.from_stat(start, st),
            ))
        except OSError as e:
            result.errors.append(f"stat location root: {e}")
            return result

    # queue holds (absolute dir, location-relative dir) STRINGS — pathlib
    # object churn was ~60% of walk time at 20k entries (profiled), so the
    # hot loop below is pure string ops
    start_rel = start.relative_to(root).as_posix()
    queue: deque[tuple[str, str]] = deque(
        [(str(start), "" if start_rel == "." else start_rel)])
    produced = 0
    while queue:
        dir_path, rel_dir = queue.popleft()

        existing: dict[tuple[int, int], dict[str, Any]] = {}
        by_name: dict[str, dict[str, Any]] = {}
        if db_fetcher is not None:
            for row in db_fetcher(rel_dir):
                if row.get("inode") is not None:
                    existing[(row["inode"], row["device"])] = row
                name = (row.get("name") or "")
                ext = row.get("extension") or ""
                by_name[f"{name}.{ext}" if ext and not row.get("is_dir") else name] = row
        seen_names: set[str] = set()

        try:
            entries = sorted(os.scandir(dir_path), key=lambda e: e.name)
        except OSError as e:
            result.errors.append(f"scandir {rel_dir or '/'}: {e}")
            continue

        for entry in entries:
            rel_path = f"{rel_dir}/{entry.name}" if rel_dir else entry.name
            try:
                is_dir = entry.is_dir(follow_symlinks=False)
                if entry.is_symlink():
                    seen_names.add(entry.name)  # present on disk, just skipped
                    continue  # reference skips symlinks in the indexer walk
                if not rules.allows_path(rel_path, is_dir, abs_path=entry.path):
                    continue
                if is_dir and not rules.allows_dir_by_children(entry.path):
                    continue
                st = entry.stat(follow_symlinks=False)
            except OSError as e:
                result.errors.append(f"stat {rel_path}: {e}")
                # transient failure must NOT delete the row in the sweep below
                seen_names.add(entry.name)
                continue

            iso = IsolatedFilePathData.from_parts(
                location_id, rel_dir, entry.name, is_dir)
            meta = FilePathMetadata.from_stat(entry.name, st)
            seen_names.add(iso.full_name)

            row = existing.get((st.st_ino, st.st_dev))
            if row is None and db_fetcher is not None:
                row = by_name.get(iso.full_name)
            if row is not None:
                old_name = _full_name_of(row)
                renamed = old_name != iso.full_name
                if renamed:
                    seen_names.add(old_name)  # rename, not a removal
                content_changed = (
                    abs(meta.modified_at - _mtime_of(row)) > MTIME_EPSILON_S
                    or (row.get("size_in_bytes") or 0) != meta.size_in_bytes
                )
                if renamed or content_changed or row.get("inode") != meta.inode:
                    result.to_update.append(WalkedEntry(
                        iso, meta, row_id=row["id"], content_changed=content_changed))
            else:
                result.walked.append(WalkedEntry(iso, meta))
                produced += 1

            if is_dir:
                if produced < limit:
                    queue.append((entry.path, rel_path))
                else:
                    result.to_walk.append(rel_path)

        # rows in DB under this dir but no longer on disk (or now rule-rejected)
        for name, row in by_name.items():
            if name and name not in seen_names:
                result.to_remove.append(row)

    return result


def db_fetcher_for(db, location_id: int) -> DbFetcher:
    """The standard rel-dir → file_path-rows fetcher (file_paths_db_fetcher_fn!
    seam) shared by the indexer job and shallow rescans."""
    from ..models import FilePath

    def fetch(rel_dir: str) -> list[dict[str, Any]]:
        mp = "/" + (rel_dir + "/" if rel_dir else "")
        return db.find(FilePath, {"location_id": location_id, "materialized_path": mp})

    return fetch


def _full_name_of(row: dict[str, Any]) -> str:
    name = row.get("name") or ""
    ext = row.get("extension") or ""
    return f"{name}.{ext}" if ext and not row.get("is_dir") else name


def _mtime_of(row: dict[str, Any]) -> float:
    value = row.get("date_modified")
    if value is None:
        return 0.0
    if isinstance(value, (int, float)):
        return float(value)
    return value.timestamp()
