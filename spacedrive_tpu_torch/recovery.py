"""The boot gate on a library's database, and its repair ladder.

Counterpart of ``spacedrive_tpu/recovery.py``. The library's SQLite file is
the one artifact a scan writes and cannot make again, so
:meth:`.library.Libraries._open` runs :func:`ensure_library_integrity`
before the model layer opens it:

1. a non-empty ``-wal`` left by a dead process is counted (opening the
   database replays it: SQLite's own crash recovery);
2. ``PRAGMA quick_check`` on a throwaway connection;
3. on corruption, the file (and its WAL and SHM) moves to
   ``libraries/quarantine/``, then the newest valid backup of the library
   (:mod:`.backups`) is restored; with none, the library starts with a
   fresh empty database. Either way the node boots, and a node
   notification (``library_db_repaired``) says what happened.

Telemetry, as the reference's: ``sd_boot_integrity_checks_total{outcome}``,
``sd_boot_integrity_wal_recovered_total``,
``sd_boot_integrity_check_seconds``, ``sd_recovery_repairs_total{action}``
and ``sd_recovery_cold_resumed_jobs_total``, with the events
``db.quick_check_failed`` and ``db.restored_from_backup``; the plain
counters below keep the same counts. ``is_disk_full`` and
``note_disk_full`` (``sd_recovery_disk_full_total``) live in :mod:`.retry`.
"""

from __future__ import annotations

import collections
import logging
import os
import sqlite3
import time
from pathlib import Path
from typing import Any

from . import telemetry

logger = logging.getLogger(__name__)

_BOOT_CHECKS = telemetry.counter(
    "sd_boot_integrity_checks_total",
    "boot-time library DB integrity checks by outcome",
    labels=("outcome",))
_WAL_RECOVERED = telemetry.counter(
    "sd_boot_integrity_wal_recovered_total",
    "boots that found (and replayed) a non-empty WAL sidecar")
_CHECK_SECONDS = telemetry.histogram(
    "sd_boot_integrity_check_seconds",
    "latency of one boot-time quick_check pass")
_REPAIRS = telemetry.counter(
    "sd_recovery_repairs_total",
    "repair-ladder actions taken on a corrupt library DB",
    labels=("action",))
_COLD_RESUMED = telemetry.counter(
    "sd_recovery_cold_resumed_jobs_total",
    "interrupted jobs revived from their checkpoints at boot")

#: boot checks by outcome (``ok`` | ``corrupt``)
BOOT_CHECKS: collections.Counter = collections.Counter()
#: repair actions (``quarantine`` | ``restore_backup`` | ``fresh_db``)
REPAIRS: collections.Counter = collections.Counter()
#: ``wal_recovered`` boots and ``cold_resumed`` jobs
RECOVERED: collections.Counter = collections.Counter()


def reset_counts() -> None:
    BOOT_CHECKS.clear()
    REPAIRS.clear()
    RECOVERED.clear()


def note_cold_resumed(count: int = 1) -> None:
    """Jobs that a dead process left running, revived at boot."""
    if count > 0:
        RECOVERED["cold_resumed"] += count
        _COLD_RESUMED.inc(count)


def quick_check_file(db_path: str | Path) -> list[str]:
    """``PRAGMA quick_check`` on a throwaway connection; ``[]`` = sound. A
    file that does not open as a database is one problem row."""
    try:
        conn = sqlite3.connect(db_path, timeout=10.0)
        try:
            rows = conn.execute("PRAGMA quick_check").fetchall()
        finally:
            conn.close()
    except sqlite3.Error as e:
        return [f"unopenable: {e}"]
    problems = [r[0] for r in rows]
    return [] if problems == ["ok"] else problems


def _quarantine(libraries_dir: Path, lib_id: str) -> Path | None:
    """Move the damaged database (and its sidecars) into
    ``libraries/quarantine/``; returns where the database went."""
    qdir = libraries_dir / "quarantine"
    qdir.mkdir(parents=True, exist_ok=True)
    stamp = time.strftime("%Y%m%d-%H%M%S")
    moved: Path | None = None
    for suffix in (".db", ".db-wal", ".db-shm"):
        src = libraries_dir / f"{lib_id}{suffix}"
        if not src.exists():
            continue
        dest = qdir / f"{lib_id}{suffix}.corrupt-{stamp}"
        n = 0
        while dest.exists():  # two corruptions within one second
            n += 1
            dest = qdir / f"{lib_id}{suffix}.corrupt-{stamp}.{n}"
        os.replace(src, dest)
        if suffix == ".db":
            moved = dest
    return moved


def ensure_library_integrity(libraries_dir: str | Path, lib_id: str,
                             backups_path: str | Path | None = None,
                             node: Any = None) -> dict[str, Any]:
    """The gate for one library's database, before anything opens it.
    Returns ``{"outcome": ok | missing | repaired | fresh, ...}``; never
    raises."""
    libraries_dir = Path(libraries_dir)
    db_path = libraries_dir / f"{lib_id}.db"
    if not db_path.exists():
        return {"outcome": "missing"}

    wal = libraries_dir / f"{lib_id}.db-wal"
    wal_pending = wal.exists() and wal.stat().st_size > 0
    t0 = time.perf_counter()
    problems = quick_check_file(db_path)
    _CHECK_SECONDS.observe(time.perf_counter() - t0)
    if not problems:
        BOOT_CHECKS["ok"] += 1
        _BOOT_CHECKS.inc(outcome="ok")
        if wal_pending:
            # quick_check's connection replayed it: the dead process's
            # committed, uncheckpointed work made it
            RECOVERED["wal_recovered"] += 1
            _WAL_RECOVERED.inc()
        return {"outcome": "ok", "wal_recovered": wal_pending}

    BOOT_CHECKS["corrupt"] += 1
    _BOOT_CHECKS.inc(outcome="corrupt")
    telemetry.event("db.quick_check_failed", library=lib_id, problems=problems[:4])
    logger.error("library %s failed quick_check (%d problem(s): %s); "
                 "entering the repair ladder", lib_id[:8], len(problems), problems[:2])
    quarantined = _quarantine(libraries_dir, lib_id)
    REPAIRS["quarantine"] += 1
    _REPAIRS.inc(action="quarantine")

    backup: Path | None = None
    if backups_path is not None and Path(backups_path).is_dir():
        from .backups import find_latest_backup

        backup = find_latest_backup(backups_path, lib_id)
    if backup is not None:
        try:
            from .backups import restore_files

            # find_latest_backup has just validated this file
            restore_files(backup, lib_id, libraries_dir)
            REPAIRS["restore_backup"] += 1
            _REPAIRS.inc(action="restore_backup")
            telemetry.event("db.restored_from_backup", library=lib_id, backup=str(backup))
            logger.warning("library %s restored from backup %s (damaged file kept at %s)",
                           lib_id[:8], backup.name, quarantined)
            _notify(node, lib_id, "restored_from_backup", str(backup))
            return {"outcome": "repaired", "backup": str(backup),
                    "quarantined": str(quarantined) if quarantined else None}
        except Exception:
            logger.exception("restore from %s failed; library %s starts with a fresh DB",
                             backup, lib_id[:8])
    REPAIRS["fresh_db"] += 1
    _REPAIRS.inc(action="fresh_db")
    logger.warning("library %s has no restorable backup; starting with a fresh DB "
                   "(damaged file kept at %s)", lib_id[:8], quarantined)
    _notify(node, lib_id, "fresh_db", None)
    return {"outcome": "fresh", "quarantined": str(quarantined) if quarantined else None}


def _notify(node: Any, lib_id: str, action: str, backup: str | None) -> None:
    """The node notification of a repair; best effort, since the boot is
    already recovering."""
    if node is None:
        return
    try:
        from .notifications import emit_node_notification

        emit_node_notification(node, {"kind": "library_db_repaired", "library_id": lib_id,
                                      "action": action, "backup": backup})
    except Exception:
        logger.exception("repair notification could not be emitted")
