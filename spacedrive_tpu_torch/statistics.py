"""Library statistics (the ``libraries.statistics`` procedure).

Counterpart of ``spacedrive_tpu/statistics.py``: counts from the library
database, capacity from the volume the data dir lives on
(:func:`..volumes.volume_for_path`), byte counters as TEXT as the
reference's schema stores them. :func:`compute_statistics` is a pure reader
over ``(db, data_dir)``; :func:`update_statistics` also writes the snapshot
row, which a backup takes before it archives the database.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import TYPE_CHECKING, Any

from .models import Statistics, utc_now
from .volumes import volume_for_path

if TYPE_CHECKING:
    from .library import Library


def compute_statistics(db, data_dir: str | Path) -> dict[str, Any]:
    """Read-only statistics over a library database and the node's data
    dir."""
    total_objects = db.query("SELECT COUNT(*) n FROM object")[0]["n"]
    totals = db.query(
        "SELECT COALESCE(SUM(size_in_bytes),0) s FROM file_path WHERE is_dir=0")[0]["s"]
    unique = db.query(
        "SELECT COALESCE(SUM(sz),0) s FROM (SELECT MIN(size_in_bytes) sz "
        "FROM file_path WHERE cas_id IS NOT NULL GROUP BY cas_id)")[0]["s"]
    try:
        db_size = os.path.getsize(db.path)
    except OSError:
        db_size = 0
    vol = volume_for_path(str(data_dir)) or {}
    return {
        "date_captured": utc_now(),
        "total_object_count": total_objects,
        "library_db_size": str(db_size),
        "total_bytes_used": str(totals),
        "total_unique_bytes": str(unique),
        "total_bytes_capacity": str(vol.get("total_capacity", 0)),
        "total_bytes_free": str(vol.get("available_capacity", 0)),
        "preview_media_bytes": str(_thumb_dir_size(data_dir)),
    }


def update_statistics(library: "Library") -> dict[str, Any]:
    """Compute the statistics and persist them as the snapshot row (the
    first row updated, else one inserted)."""
    db = library.db
    row = compute_statistics(db, library.node.data_dir)
    existing = db.find(Statistics, limit=1)
    if existing:
        db.update(Statistics, {"id": existing[0]["id"]}, row)
        row["id"] = existing[0]["id"]
    else:
        row["id"] = db.insert(Statistics, row)
    return row


def _thumb_dir_size(data_dir: str | Path) -> int:
    total = 0
    for dirpath, _dirs, files in os.walk(Path(data_dir) / "thumbnails"):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(dirpath, f))
            except OSError:
                pass
    return total
