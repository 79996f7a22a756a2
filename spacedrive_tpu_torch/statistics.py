"""Library statistics (the ``libraries.statistics`` procedure).

Counterpart of ``spacedrive_tpu/statistics.py``: counts from the library
database, capacity from the volume the data dir lives on, byte counters as
TEXT as the reference's schema stores them. :func:`compute_statistics` is a
pure reader over ``(db, data_dir)``; the ``statistics`` table is in the
schema, but the reference's only writer of its snapshot row (the backup
job) is not ported. The volume lookup is a trimmed copy of
``spacedrive_tpu/volumes.py`` (``get_volumes`` :40, ``volume_for_path``
:84): the longest mounted prefix of the path among the real filesystems
in ``/proc/mounts``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any

from .models import utc_now

_PSEUDO_FS = {
    "proc", "sysfs", "devtmpfs", "devpts", "tmpfs", "cgroup", "cgroup2",
    "securityfs", "pstore", "efivarfs", "bpf", "debugfs", "tracefs",
    "fusectl", "configfs", "ramfs", "autofs", "mqueue", "hugetlbfs",
    "binfmt_misc", "overlay", "squashfs", "nsfs", "rpc_pipefs", "fuse.lxcfs",
}


def _capacity(mount_point: str) -> tuple[int, int] | None:
    try:
        st = os.statvfs(mount_point)
    except OSError:
        return None
    return st.f_blocks * st.f_frsize, st.f_bavail * st.f_frsize


def volume_for_path(path: str | Path) -> dict[str, Any] | None:
    """``{"mount_point", "total_capacity", "available_capacity"}`` of the
    longest mounted prefix of ``path`` (``/`` where no mount is listed)."""
    path = str(Path(path).resolve())
    mounts: list[str] = []
    try:
        with open("/proc/mounts") as fh:
            for line in fh:
                parts = line.split()
                if len(parts) >= 3 and parts[2] not in _PSEUDO_FS and parts[0].startswith("/"):
                    mounts.append(parts[1].replace("\\040", " "))
    except OSError:
        pass
    best = None
    for mp in mounts or ["/"]:
        if path == mp or path.startswith(mp.rstrip("/") + "/") or mp == "/":
            cap = _capacity(mp)
            if cap is not None and (best is None or len(mp) > len(best["mount_point"])):
                best = {"mount_point": mp, "total_capacity": cap[0],
                        "available_capacity": cap[1]}
    return best


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


def _thumb_dir_size(data_dir: str | Path) -> int:
    total = 0
    for dirpath, _dirs, files in os.walk(Path(data_dir) / "thumbnails"):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(dirpath, f))
            except OSError:
                pass
    return total
