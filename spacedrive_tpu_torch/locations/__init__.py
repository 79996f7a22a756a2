"""Locations: create one and scan it.

Counterpart of ``spacedrive_tpu/locations/__init__.py`` (``create_location``
:34, ``scan_location`` :99). The port's scan chains, as the reference's
does, the indexer, the file identifier, the media processor (image
thumbnails resized on the node's device, and image metadata) unless the
location's ``generate_preview_media`` is False, and, on full scans, the
MinHash near-duplicate detector (DedupDetectorJob). The location's
``hasher`` column picks the identify job's hasher
(``objects.hasher.get_hasher``): ``"tpu-sharded"`` hashes over the node's
device mesh, any other name on the node's device, which is what it records
by default.
"""

from __future__ import annotations

import uuid
from pathlib import Path
from typing import TYPE_CHECKING, Any

from ..models import IndexerRule, IndexerRulesInLocation, Location, utc_now
from .rules import SYSTEM_RULES, seed_rules

if TYPE_CHECKING:
    from ..library import Library


class LocationError(Exception):
    pass


def create_location(library: "Library", path: str | Path, name: str | None = None,
                    indexer_rule_names: list[str] | None = None,
                    hasher: str | None = None) -> dict[str, Any]:
    """Validate the path, insert the row, link the default indexer rules
    (or the named ones). ``hasher`` None records the node's device type.
    Does not scan: call :func:`scan_location`."""
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
    seed_rules(db)
    location_id = db.insert(Location, {
        "pub_id": str(uuid.uuid4()),
        "name": name or path.name,
        "path": str(path),
        "date_created": utc_now(),
        "hasher": hasher or library.node.device.type,
    })
    wanted = indexer_rule_names if indexer_rule_names is not None else [
        spec.name for spec in SYSTEM_RULES if spec.default]
    for rule_name in wanted:
        rule = db.find_one(IndexerRule, {"name": rule_name})
        if rule:
            db.insert(IndexerRulesInLocation,
                      {"location_id": location_id, "indexer_rule_id": rule["id"]},
                      or_ignore=True)
    library.node.locations.add(library, location_id)
    return db.find_one(Location, {"id": location_id})


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
