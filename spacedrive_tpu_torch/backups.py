"""Library backups: a tar.gz of the config and the database behind a header.

Counterpart of ``spacedrive_tpu/backups.py``, in the same format both ways:
a 256-byte header (the magic ``SDTPUBAK``, the little-endian length of a
JSON object with the backup id, the timestamp in ms, the library id and
name, zero padding) followed by a tar.gz of ``<id>.sdlibrary`` and
``<id>.db``. A backup written by either package passes the other's
:func:`read_header` and :func:`validate_backup`.

- A backup is written atomically (temporary file, fsync, rename): a kill
  mid-backup leaves no ``.bkp`` at all, never a torn one.
- A restore validates the archive (every member read, so the gzip CRC is
  checked) and its header's library id first, extracts into a temporary
  directory beside the live files, and only then renames the database and
  the config over the originals: a kill at any point leaves the old
  library whole.
- The boot gate (:mod:`.recovery`) restores a corrupt database from the
  newest valid backup through the same extraction.

The ``backup`` and ``restore`` fault seams sit where the reference's do:
before the archive is built, before it is written, and before the renames.
"""

from __future__ import annotations

import gzip
import io
import json
import logging
import os
import shutil
import struct
import tarfile
import time
import uuid
import zlib
from pathlib import Path
from typing import TYPE_CHECKING, Any

from . import faults
from .atomic import TMP_MARK, atomic_write_bytes
from .retry import is_disk_full, note_disk_full

if TYPE_CHECKING:
    from .node import Node

logger = logging.getLogger(__name__)

MAGIC = b"SDTPUBAK"  # 8 bytes
HEADER_LEN = 256


def _header(backup_id: str, library_id: str, library_name: str) -> bytes:
    meta = json.dumps({
        "id": backup_id, "timestamp": int(time.time() * 1000),
        "library_id": library_id, "library_name": library_name[:80],
    }).encode()
    if len(meta) > HEADER_LEN - 12:
        meta = meta[: HEADER_LEN - 12]
    return MAGIC + struct.pack("<I", len(meta)) + meta.ljust(HEADER_LEN - 12, b"\0")


def read_header(path: str | Path) -> dict[str, Any]:
    with open(path, "rb") as fh:
        head = fh.read(HEADER_LEN)
    if len(head) < HEADER_LEN or not head.startswith(MAGIC):
        raise ValueError(f"not a backup file: {path}")
    (meta_len,) = struct.unpack_from("<I", head, 8)
    return json.loads(head[12 : 12 + meta_len])


def backups_dir(node: "Node") -> Path:
    d = node.data_dir / "backups"
    d.mkdir(parents=True, exist_ok=True)
    return d


def list_backups(node: "Node") -> list[dict[str, Any]]:
    out = []
    for path in sorted(backups_dir(node).glob("*.bkp")):
        try:
            out.append({**read_header(path), "path": str(path)})
        except (ValueError, json.JSONDecodeError):
            continue
    return out


def _member_names(library_id: str) -> tuple[str, str]:
    return f"{library_id}.sdlibrary", f"{library_id}.db"


def validate_backup(path: str | Path,
                    expect_library_id: str | None = None) -> dict[str, Any]:
    """The header, once the whole archive checked out: the magic, a
    ``library_id`` (equal to ``expect_library_id`` when given), a gzip
    stream read to its end (its CRC), and both members present as regular
    files. Raises ``ValueError`` otherwise."""
    try:
        header = read_header(path)
    except (OSError, json.JSONDecodeError, ValueError) as e:
        raise ValueError(f"backup {path}: unreadable header ({e})") from e
    library_id = header.get("library_id")
    if not library_id:
        raise ValueError(f"backup {path}: header missing library_id")
    if expect_library_id is not None and library_id != expect_library_id:
        raise ValueError(
            f"backup {path}: header library_id {library_id!r} does not match "
            f"the restore target {expect_library_id!r}")
    want = set(_member_names(library_id))
    try:
        with open(path, "rb") as fh:
            fh.seek(HEADER_LEN)
            body = io.BytesIO(fh.read())
        # the whole gzip stream first: its CRC is checked only at its end,
        # and a member walk can stop before the tar's trailing padding
        with gzip.GzipFile(fileobj=body) as gz:
            while gz.read(1 << 20):
                pass
        body.seek(0)
        with tarfile.open(fileobj=body, mode="r:gz") as tar:
            seen = set()
            for member in tar:
                if member.name not in want:
                    continue  # members of a later format are ignored
                seen.add(member.name)
                if not member.isreg():
                    raise ValueError(
                        f"backup {path}: member {member.name} is not a regular file")
    except ValueError:
        raise
    except (OSError, tarfile.TarError, EOFError, zlib.error) as e:
        raise ValueError(f"backup {path}: corrupt archive ({e})") from e
    missing = want - seen
    if missing:
        raise ValueError(f"backup {path}: missing member(s) {sorted(missing)}")
    return header


def find_latest_backup(backups_path: str | Path, library_id: str) -> Path | None:
    """The newest valid backup of ``library_id`` under ``backups_path``, by
    header timestamp; invalid and foreign files are skipped."""
    best: tuple[int, Path] | None = None
    for path in Path(backups_path).glob("*.bkp"):
        try:
            header = validate_backup(path, expect_library_id=library_id)
        except ValueError:
            continue
        ts = int(header.get("timestamp") or 0)
        if best is None or ts > best[0]:
            best = (ts, path)
    return best[1] if best else None


def do_backup(node: "Node", library_id: str) -> str:
    """Archive the library's config and database; returns the backup id."""
    library = node.libraries.get(library_id)
    backup_id = str(uuid.uuid4())
    target = backups_dir(node) / f"{backup_id}.bkp"
    cfg_path = node.libraries.dir / f"{library_id}.sdlibrary"
    db_path = node.libraries.dir / f"{library_id}.db"
    # an as-of statistics row goes into the backup; best effort
    try:
        from .statistics import update_statistics

        update_statistics(library)
    except Exception:
        logger.warning("statistics snapshot before backup failed", exc_info=True)
    # fold the WAL into the main file, so the archived .db stands alone
    library.db.execute("PRAGMA wal_checkpoint(TRUNCATE)")
    faults.inject("backup", key=library_id)
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        tar.add(cfg_path, arcname=f"{library_id}.sdlibrary")
        tar.add(db_path, arcname=f"{library_id}.db")
    faults.inject("backup", key="write")
    try:
        atomic_write_bytes(target, _header(backup_id, library_id, library.name)
                           + buf.getvalue())
    except OSError as e:
        if is_disk_full(e):
            # no torn .bkp survived the atomic write; the counter says why
            # the backup is missing
            note_disk_full("backup")
        raise
    return backup_id


def extract_validated(backup_path: str | Path, library_id: str,
                      dest_dir: Path) -> tuple[Path, Path]:
    """Extract the config and database members into ``dest_dir`` (on the
    live files' filesystem, so the renames after are atomic); returns
    ``(cfg_tmp, db_tmp)``."""
    cfg_name, db_name = _member_names(library_id)
    with open(backup_path, "rb") as fh:
        fh.seek(HEADER_LEN)
        # buffered: extraction seeks back in the gzip stream, and a rewind
        # over the raw file would land on the header
        buf = io.BytesIO(fh.read())
    with tarfile.open(fileobj=buf, mode="r:gz") as tar:
        members = [m for m in tar.getmembers() if m.name in (cfg_name, db_name)]
        tar.extractall(dest_dir, members=members, filter="data")
    return dest_dir / cfg_name, dest_dir / db_name


def restore_files(backup_path: str | Path, library_id: str, libraries_dir: Path) -> None:
    """Validated extraction into a temporary directory, then the database
    and the config renamed over the live files (in that order, each atomic).
    Shared by :func:`do_restore` and the boot gate, which runs before any
    Library exists; both have validated the backup before they call it."""
    tmp_dir = libraries_dir / f"{library_id}{TMP_MARK}.restore"
    shutil.rmtree(tmp_dir, ignore_errors=True)  # a stale earlier attempt
    tmp_dir.mkdir(parents=True)
    try:
        cfg_tmp, db_tmp = extract_validated(backup_path, library_id, tmp_dir)
        # a kill here leaves the originals whole: only the temporary
        # directory has been touched
        faults.inject("restore", key=library_id)
        # the old database's WAL and SHM must not replay into the restored file
        (libraries_dir / f"{library_id}.db-wal").unlink(missing_ok=True)
        (libraries_dir / f"{library_id}.db-shm").unlink(missing_ok=True)
        os.replace(db_tmp, libraries_dir / f"{library_id}.db")
        os.replace(cfg_tmp, libraries_dir / f"{library_id}.sdlibrary")
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)


def do_restore(node: "Node", backup_path: str | Path) -> str:
    """Validate, unload the library (its watchers stop), swap its files in,
    and load it again; returns its id."""
    header = validate_backup(backup_path)
    library_id = header["library_id"]
    # unloaded only after validation: a bad backup never takes it down
    try:
        library = node.libraries.get(library_id)
    except KeyError:
        library = None
    if library is not None:
        node.locations.drop_library(library_id)
        node.libraries.unload(library_id)
    restore_files(backup_path, library_id, node.libraries.dir)
    node.libraries.load(library_id)
    node.emit("library.reload", {"source": "restore"}, library_id=library_id)
    return library_id


def delete_backup(node: "Node", backup_id: str) -> None:
    path = backups_dir(node) / f"{backup_id}.bkp"
    if path.exists():
        path.unlink()
