"""Locations: create, delete, scan and quick-rescan one; the metadata sidecar.

Counterpart of ``spacedrive_tpu/locations/__init__.py`` (``create_location``
:34, ``delete_location`` :84, ``scan_location`` :99, ``light_scan_location``
:123, the ``.spacedrive`` sidecar :156-195). The port's scan chains, as the
reference's does, the indexer, the file identifier, the media processor
(image thumbnails resized on the node's device, and image metadata) unless
the location's ``generate_preview_media`` is False, and, on full scans, the
MinHash near-duplicate detector (DedupDetectorJob). The location's
``hasher`` column picks the identify job's hasher
(``objects.hasher.get_hasher``): ``"tpu-sharded"`` hashes over the node's
device mesh, any other name on the node's device, whose type it records
when the caller names none. The ``.spacedrive`` sidecar in a location's
root binds the directory to ``{library id: location id}`` for relink. With
sync emitting, ``create_location`` logs the new row's create operation in
the transaction that inserts it (reference :74-77).
"""

from __future__ import annotations

import json
import logging
import uuid
from pathlib import Path
from typing import TYPE_CHECKING, Any

from ..models import FilePath, IndexerRule, IndexerRulesInLocation, Location, utc_now
from ..sync.manager import emitter
from .rules import SYSTEM_RULES, seed_rules

if TYPE_CHECKING:
    from ..library import Library

logger = logging.getLogger(__name__)

METADATA_FILE = ".spacedrive"


class LocationError(Exception):
    pass


def create_location(library: "Library", path: str | Path, name: str | None = None,
                    indexer_rule_names: list[str] | None = None,
                    hasher: str | None = None, dry_run: bool = False) -> dict[str, Any]:
    """Validate the path, write the metadata sidecar, insert the row, link
    the default indexer rules (or the named ones). ``hasher`` None records
    the node's device type. Does not scan: call :func:`scan_location`."""
    path = Path(path).resolve()
    if not path.is_dir():
        raise LocationError(f"not a directory: {path}")
    db = library.db
    for row in db.find(Location):
        existing = Path(row["path"] or "/nonexistent")
        if existing == path:
            raise LocationError(f"location already exists at {path}")
        if existing in path.parents or path in existing.parents:
            raise LocationError(f"nested locations are not allowed ({path} vs {existing})")
    if dry_run:
        return {"path": str(path), "name": name or path.name}
    seed_rules(db)
    sync = emitter(library)
    with db.transaction():
        location_id = db.insert(Location, {
            "pub_id": str(uuid.uuid4()),
            "name": name or path.name,
            "path": str(path),
            "date_created": utc_now(),
            "instance_id": library.instance_id,
            "hasher": hasher or library.node.device.type,
        })
        if sync is not None:
            sync.shared_create_many(Location, [db.find_one(Location, {"id": location_id})])
    if sync is not None:
        sync.created()
    wanted = indexer_rule_names if indexer_rule_names is not None else [
        spec.name for spec in SYSTEM_RULES if spec.default]
    for rule_name in wanted:
        rule = db.find_one(IndexerRule, {"name": rule_name})
        if rule:
            db.insert(IndexerRulesInLocation,
                      {"location_id": location_id, "indexer_rule_id": rule["id"]},
                      or_ignore=True)
    _write_metadata(path, library.id, location_id)
    library.node.locations.add(library, location_id)
    library.emit("invalidate_query", {"key": "locations.list"})
    return db.find_one(Location, {"id": location_id})


def delete_location(library: "Library", location_id: int) -> None:
    """Drop the location, its rule links and its file_paths, and this
    library's entry of its sidecar."""
    db = library.db
    row = db.find_one(Location, {"id": location_id})
    if row is None:
        raise LocationError(f"location {location_id} not found")
    library.node.locations.remove(library, location_id)
    db.delete(IndexerRulesInLocation, {"location_id": location_id})
    db.delete(FilePath, {"location_id": location_id})
    db.delete(Location, {"id": location_id})
    if row["path"]:
        _remove_metadata_entry(Path(row["path"]), library.id)
    library.emit("invalidate_query", {"key": "locations.list"})


def scan_location(library: "Library", location_id: int,
                  sub_path: str | None = None) -> str:
    """Spawn IndexerJob → FileIdentifierJob → MediaProcessorJob (unless the
    location's ``generate_preview_media`` is False), then DedupDetectorJob
    on a full scan (a sub-path rescan skips it, as in the reference);
    returns the head job id."""
    from ..objects.dedup import DedupDetectorJob
    from ..objects.file_identifier import FileIdentifierJob
    from ..objects.media.processor import MediaProcessorJob
    from .indexer_job import IndexerJob

    row = library.db.find_one(Location, {"id": location_id})
    if row is None:
        raise LocationError(f"location {location_id} not found")
    args: dict[str, Any] = {"location_id": location_id}
    if sub_path:
        args["sub_path"] = sub_path
    jobs = [IndexerJob(args), FileIdentifierJob(dict(args))]
    if row.get("generate_preview_media") is not False:
        jobs.append(MediaProcessorJob(dict(args)))
    if not sub_path:
        jobs.append(DedupDetectorJob({"location_id": location_id}))
    return library.node.jobs.spawn(library, jobs, action="scan_location")


def light_scan_location(library: "Library", location_id: int,
                        sub_path: str = "") -> dict[str, int]:
    """Shallow rescan of one directory, inline and without a job: new
    entries are saved, changed ones updated (a content change clears the
    cas_id and object), vanished ones removed."""
    from .indexer_job import _entry_to_row
    from .rules import CompiledRules, rules_for_location
    from .walker import db_fetcher_for, walk_single_dir

    db = library.db
    row = db.find_one(Location, {"id": location_id})
    if row is None:
        raise LocationError(f"location {location_id} not found")
    rules = CompiledRules(rules_for_location(db, location_id))
    result = walk_single_dir(location_id, row["path"], rules, sub_path,
                             db_fetcher_for(db, location_id))
    db.insert_many(FilePath, [_entry_to_row(e) for e in result.walked], or_ignore=True)
    for entry in result.to_update:
        r = _entry_to_row(entry)
        values = {"materialized_path": r["materialized_path"], "name": r["name"],
                  "extension": r["extension"], "size_in_bytes": r["size_in_bytes"],
                  "inode": r["inode"], "device": r["device"],
                  "date_modified": r["date_modified"]}
        if entry.content_changed:
            values["cas_id"] = None
            values["object_id"] = None
            if entry.renamed:
                # another file took the inode (indexer_job's docstring)
                values["integrity_checksum"] = None
        db.update(FilePath, {"id": entry.row_id}, values)
    for gone in result.to_remove:
        db.delete(FilePath, {"id": gone["id"]})
    library.emit("invalidate_query", {"key": "search.paths"})
    return {"saved": len(result.walked), "updated": len(result.to_update),
            "removed": len(result.to_remove)}


def _write_metadata(path: Path, library_id: str, location_id: int) -> None:
    meta_path = path / METADATA_FILE
    data = read_metadata(path) or {}
    data.setdefault("libraries", {})[library_id] = location_id
    try:
        meta_path.write_text(json.dumps(data, indent=2))
    except OSError as e:
        logger.warning("could not write %s: %s", meta_path, e)


def _remove_metadata_entry(path: Path, library_id: str) -> None:
    """Drop only this library's entry; other libraries keep theirs."""
    meta_path = path / METADATA_FILE
    data = read_metadata(path)
    if data is None:
        return
    data.get("libraries", {}).pop(library_id, None)
    try:
        if data.get("libraries"):
            meta_path.write_text(json.dumps(data, indent=2))
        else:
            meta_path.unlink(missing_ok=True)
    except OSError as e:
        logger.warning("could not update %s: %s", meta_path, e)


def read_metadata(path: str | Path) -> dict[str, Any] | None:
    """The sidecar of a directory: which library's location it is."""
    meta_path = Path(path) / METADATA_FILE
    if not meta_path.exists():
        return None
    try:
        return json.loads(meta_path.read_text())
    except (OSError, json.JSONDecodeError):
        return None
