"""Location watcher: live filesystem changes into the library's rows.

Counterpart of ``spacedrive_tpu/locations/watcher.py``: the per-OS backend
seam (raw inotify over ``ctypes`` on Linux; anywhere else, or when inotify
is refused, a polling backend that emits the same normalized events), the
Linux handler's debounce (updates wait 100 ms, rename pairs match by
cookie, a ``moved_from`` with no partner after 1 s is a remove) and the row
helpers (create, update, rename with every descendant rewritten, remove).

Events that survive the debounce are applied on the watcher's thread; the
library's database has one writer, so they serialize with the jobs' writes.
After each flush that created or changed files the handler runs one
:func:`..objects.file_identifier.shallow_identify` over the location's
orphan rows, inline on this thread: on a card node the BLAKE3 kernels (and,
with chunk manifests on, the Gear kernel) launch from here. Those launches
are counted under the origin ``"watcher"`` (:func:`..ops._kernels.origin`).

With sync emitting, each row helper logs its CRDT operations in the
transaction of its writes, as the reference's do (:278-422, :569): a
create's row, an update's size, mtime and cleared cas_id, a rename's new
path fields (and each descendant's materialized_path), a remove's deletes
(:func:`..objects.fs._remove_rows`). ``STATS`` counts, over every watcher,
the events applied, the shallow identify passes (and those that raised:
the pass is logged and the watcher goes on, as in the reference) and the
overflow rescans, and it splits the settle in two: ``apply_s`` sums the
time the debounced updates and renames took to reach the database,
``identify_s`` the identify passes through the kernels (span timers of
:mod:`..telemetry`). Each pass is also a ``watcher.identify`` event with
its duration. The reference's watcher has no telemetry.
"""

from __future__ import annotations

import collections
import ctypes
import ctypes.util
import dataclasses
import datetime as dt
import errno
import logging
import os
import select
import struct
import sys
import threading
import time
import uuid
from pathlib import Path
from typing import TYPE_CHECKING, Any, Callable

from .. import telemetry
from ..models import FilePath, Location, utc_now
from ..ops import _kernels
from ..sync.manager import emitter
from .paths import FilePathMetadata, IsolatedFilePathData
from .rules import CompiledRules, rules_for_location

if TYPE_CHECKING:
    from ..library import Library

logger = logging.getLogger(__name__)

ONE_SECOND = 1.0      # dangling-rename eviction
HUNDRED_MILLIS = 0.1  # update debounce window

#: ``events`` applied, ``identify`` passes, ``identify_failed`` passes,
#: ``overflow`` rescans, and the seconds of ``apply_s`` and ``identify_s``
#: (summed over every watcher of the process); :func:`reset_counts` zeroes
#: them
STATS: collections.Counter = collections.Counter()


def reset_counts() -> None:
    STATS.clear()


# ---------------------------------------------------------------------------
# Normalized events (what every backend emits)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RawEvent:
    kind: str            # create | modify | moved_from | moved_to | delete | overflow
    path: str            # absolute path
    is_dir: bool = False
    cookie: int = 0      # links moved_from/moved_to pairs (inotify cookie)


# ---------------------------------------------------------------------------
# inotify backend (Linux)
# ---------------------------------------------------------------------------

IN_MODIFY = 0x0002
IN_ATTRIB = 0x0004
IN_CLOSE_WRITE = 0x0008
IN_MOVED_FROM = 0x0040
IN_MOVED_TO = 0x0080
IN_CREATE = 0x0100
IN_DELETE = 0x0200
IN_DELETE_SELF = 0x0400
IN_Q_OVERFLOW = 0x4000
IN_ISDIR = 0x40000000
IN_ONLYDIR = 0x01000000

_WATCH_MASK = (IN_CREATE | IN_MODIFY | IN_ATTRIB | IN_CLOSE_WRITE
               | IN_MOVED_FROM | IN_MOVED_TO | IN_DELETE | IN_DELETE_SELF)

_EVENT_HDR = struct.Struct("iIII")  # wd, mask, cookie, len


class InotifyBackend:
    """Raw inotify through libc. A watch covers one directory, so the
    backend keeps a wd <-> path map of the tree, grown as directories
    appear and pruned on IN_DELETE_SELF."""

    def __init__(self, root: str) -> None:
        libc_name = ctypes.util.find_library("c") or "libc.so.6"
        self._libc = ctypes.CDLL(libc_name, use_errno=True)
        self._fd = self._libc.inotify_init1(os.O_NONBLOCK)
        if self._fd < 0:
            raise OSError(ctypes.get_errno(), "inotify_init1 failed")
        self._wd_to_path: dict[int, str] = {}
        self._path_to_wd: dict[str, int] = {}
        self._buf = b""
        self.root = root
        self._add_watch_recursive(root)

    def _add_watch(self, path: str) -> None:
        wd = self._libc.inotify_add_watch(
            self._fd, os.fsencode(path), _WATCH_MASK | IN_ONLYDIR)
        if wd < 0:
            err = ctypes.get_errno()
            if err not in (errno.ENOENT, errno.ENOTDIR):
                logger.warning("inotify_add_watch(%s): %s", path, os.strerror(err))
            return
        old = self._wd_to_path.get(wd)
        if old is not None:
            self._path_to_wd.pop(old, None)
        self._wd_to_path[wd] = path
        self._path_to_wd[path] = wd

    def _add_watch_recursive(self, path: str) -> None:
        self._add_watch(path)
        try:
            with os.scandir(path) as it:
                for entry in it:
                    if entry.is_dir(follow_symlinks=False):
                        self._add_watch_recursive(entry.path)
        except OSError:
            pass

    def note_dir_moved(self, from_path: str, to_path: str) -> None:
        """A watch follows its inode across a rename: rebase the path map."""
        prefix = from_path.rstrip("/") + "/"
        for wd, path in list(self._wd_to_path.items()):
            if path == from_path or path.startswith(prefix):
                new = to_path + path[len(from_path):]
                self._path_to_wd.pop(path, None)
                self._wd_to_path[wd] = new
                self._path_to_wd[new] = wd

    def watch_new_dir(self, path: str) -> None:
        self._add_watch_recursive(path)

    def read(self, timeout: float) -> list[RawEvent]:
        try:
            ready, _, _ = select.select([self._fd], [], [], timeout)
        except OSError:
            return []
        if not ready:
            return []
        try:
            self._buf += os.read(self._fd, 65536)
        except OSError:  # BlockingIOError included
            return []
        events: list[RawEvent] = []
        buf = self._buf
        offset = 0
        while offset + _EVENT_HDR.size <= len(buf):
            wd, mask, cookie, name_len = _EVENT_HDR.unpack_from(buf, offset)
            if offset + _EVENT_HDR.size + name_len > len(buf):
                break
            name = buf[offset + _EVENT_HDR.size: offset + _EVENT_HDR.size
                       + name_len].rstrip(b"\x00").decode(errors="surrogateescape")
            offset += _EVENT_HDR.size + name_len
            if mask & IN_Q_OVERFLOW:
                events.append(RawEvent("overflow", self.root))
                continue
            dir_path = self._wd_to_path.get(wd)
            if dir_path is None:
                continue
            if mask & IN_DELETE_SELF:
                self._path_to_wd.pop(dir_path, None)
                self._wd_to_path.pop(wd, None)
                continue
            path = os.path.join(dir_path, name) if name else dir_path
            is_dir = bool(mask & IN_ISDIR)
            if mask & IN_CREATE:
                events.append(RawEvent("create", path, is_dir, cookie))
            elif mask & (IN_CLOSE_WRITE | IN_MODIFY | IN_ATTRIB):
                events.append(RawEvent("modify", path, is_dir, cookie))
            elif mask & IN_MOVED_FROM:
                events.append(RawEvent("moved_from", path, is_dir, cookie))
            elif mask & IN_MOVED_TO:
                events.append(RawEvent("moved_to", path, is_dir, cookie))
            elif mask & IN_DELETE:
                events.append(RawEvent("delete", path, is_dir, cookie))
        self._buf = buf[offset:]
        return events

    def close(self) -> None:
        try:
            os.close(self._fd)
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Polling backend (the fallback, and the deterministic one for tests)
# ---------------------------------------------------------------------------

class PollingBackend:
    """A scandir snapshot diffed every ``interval`` seconds into the same
    normalized events. Renames are paired by inode between the vanished
    and the appeared paths."""

    def __init__(self, root: str, interval: float = 0.5) -> None:
        self.root = root
        self.interval = interval
        self._snapshot = self._scan()
        self._last = time.monotonic()
        self._cookie = 0

    def _scan(self) -> dict[str, tuple[bool, float, int, int]]:
        snap: dict[str, tuple[bool, float, int, int]] = {}
        stack = [self.root]
        while stack:
            d = stack.pop()
            try:
                with os.scandir(d) as it:
                    entries = list(it)
            except OSError:
                continue
            for entry in entries:
                try:
                    if entry.is_symlink():
                        continue
                    is_dir = entry.is_dir(follow_symlinks=False)
                    st = entry.stat(follow_symlinks=False)
                except OSError:
                    continue
                snap[entry.path] = (is_dir, st.st_mtime, st.st_size, st.st_ino)
                if is_dir:
                    stack.append(entry.path)
        return snap

    def note_dir_moved(self, from_path: str, to_path: str) -> None:
        pass

    def watch_new_dir(self, path: str) -> None:
        pass

    def read(self, timeout: float) -> list[RawEvent]:
        now = time.monotonic()
        wait = min(timeout, max(0.0, self.interval - (now - self._last)))
        if wait > 0:
            time.sleep(wait)
        if time.monotonic() - self._last < self.interval:
            return []
        self._last = time.monotonic()
        new = self._scan()
        old = self._snapshot
        self._snapshot = new
        events: list[RawEvent] = []
        gone = {p: v for p, v in old.items() if p not in new}
        appeared = {p: v for p, v in new.items() if p not in old}
        gone_by_ino = {v[3]: p for p, v in gone.items()}
        for path, (is_dir, _, _, ino) in sorted(appeared.items()):
            src = gone_by_ino.pop(ino, None)
            if src is not None and gone[src][0] == is_dir:
                self._cookie += 1
                events.append(RawEvent("moved_from", src, is_dir, self._cookie))
                events.append(RawEvent("moved_to", path, is_dir, self._cookie))
                del gone[src]
            else:
                events.append(RawEvent("create", path, is_dir))
        for path, (is_dir, *_rest) in sorted(gone.items()):
            events.append(RawEvent("delete", path, is_dir))
        for path, (is_dir, mtime, size, _ino) in new.items():
            if path in old and not is_dir:
                o = old[path]
                if o[1] != mtime or o[2] != size:
                    events.append(RawEvent("modify", path, is_dir))
        return events

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# Row helpers
# ---------------------------------------------------------------------------

def _row_for(library: "Library", location_id: int,
             iso: IsolatedFilePathData) -> dict[str, Any] | None:
    return library.db.find_one(FilePath, {
        "location_id": location_id,
        "materialized_path": iso.materialized_path,
        "name": iso.name, "extension": iso.extension,
    })


def apply_create(library: "Library", location: dict[str, Any],
                 rel_path: str, is_dir: bool) -> bool:
    """Insert the row of a new path (an existing row is updated instead).
    False when the path vanished before it could be stat'ed."""
    iso = IsolatedFilePathData.from_relative(location["id"], rel_path, is_dir)
    abs_path = iso.absolute_path(location["path"])
    try:
        st = abs_path.stat()
    except OSError:
        return False
    if _row_for(library, location["id"], iso) is not None:
        return apply_update(library, location, rel_path, is_dir)
    meta = FilePathMetadata.from_stat(abs_path, st)
    row = {
        "pub_id": str(uuid.uuid4()),
        **iso.db_fields(),
        "inode": meta.inode, "device": meta.device,
        "size_in_bytes": meta.size_in_bytes, "hidden": meta.hidden,
        "date_created": _iso_ts(meta.created_at),
        "date_modified": _iso_ts(meta.modified_at),
        "date_indexed": utc_now().isoformat(),
    }
    db = library.db
    sync = emitter(library)
    with db.transaction():
        db.insert_many(FilePath, [row], or_ignore=True)
        if sync is not None:
            sync.shared_create_many(FilePath, [row])
    if sync is not None:
        sync.created()
    library.emit("invalidate_query", {"key": "search.paths"})
    return True


def apply_update(library: "Library", location: dict[str, Any],
                 rel_path: str, is_dir: bool) -> bool:
    """Refresh a row's metadata; a content change (another size, or an
    mtime more than 1 ms away) clears its cas_id and object so that it is
    identified again. Returns whether the row needs identifying: its
    content changed, or the file has no object yet. The reference returns
    the first only, so a file whose row an fs job's light rescan inserted
    before the watcher applied the file's events stayed unidentified."""
    iso = IsolatedFilePathData.from_relative(location["id"], rel_path, is_dir)
    row = _row_for(library, location["id"], iso)
    if row is None:
        return apply_create(library, location, rel_path, is_dir)
    abs_path = iso.absolute_path(location["path"])
    try:
        st = abs_path.stat()
    except OSError:
        return False
    meta = FilePathMetadata.from_stat(abs_path, st)
    content_changed = ((row.get("size_in_bytes") or 0) != meta.size_in_bytes
                       or abs(_mtime_of(row) - meta.modified_at) > 0.001)
    values: dict[str, Any] = {
        "size_in_bytes": meta.size_in_bytes,
        "inode": meta.inode, "device": meta.device,
        "date_modified": _iso_ts(meta.modified_at),
        "hidden": meta.hidden,
    }
    if content_changed and not is_dir:
        values["cas_id"] = None
        values["object_id"] = None
    db = library.db
    sync = emitter(library)
    ops = []
    with db.transaction():
        db.update(FilePath, {"id": row["id"]}, values)
        if sync is not None:
            ops = [sync.shared_update(FilePath, row["pub_id"], field, values[field])
                   for field in ("size_in_bytes", "date_modified", "cas_id")
                   if field in values]
            sync.log_ops(ops)
    if ops:
        sync.created()
    library.emit("invalidate_query", {"key": "search.paths"})
    return content_changed or (not is_dir and row.get("object_id") is None)


def apply_rename(library: "Library", location: dict[str, Any],
                 from_rel: str, to_rel: str, is_dir: bool) -> None:
    """Move a row to its new identity, keeping its cas_id and object; for
    a directory, rewrite every descendant's materialized_path prefix in the
    same transaction."""
    db = library.db
    from_iso = IsolatedFilePathData.from_relative(location["id"], from_rel, is_dir)
    to_iso = IsolatedFilePathData.from_relative(location["id"], to_rel, is_dir)
    row = _row_for(library, location["id"], from_iso)
    if row is None:
        # never indexed (moved in and renamed at once): a create
        apply_create(library, location, to_rel, is_dir)
        return
    clash = _row_for(library, location["id"], to_iso)
    if clash is not None and clash["id"] != row["id"]:
        apply_remove_row(library, clash)
    sync = emitter(library)
    ops = []
    with db.transaction():
        db.update(FilePath, {"id": row["id"]}, {
            "materialized_path": to_iso.materialized_path,
            "name": to_iso.name, "extension": to_iso.extension,
            "date_modified": utc_now().isoformat(),
        })
        if sync is not None:
            ops = [sync.shared_update(FilePath, row["pub_id"], field, value)
                   for field, value in (("materialized_path", to_iso.materialized_path),
                                        ("name", to_iso.name),
                                        ("extension", to_iso.extension))]
        if is_dir:
            old_prefix = from_iso.child_materialized_path()
            new_prefix = to_iso.child_materialized_path()
            descendants = db.query(
                "SELECT id, pub_id, materialized_path FROM file_path "
                "WHERE location_id = ? AND materialized_path LIKE ?",
                [location["id"], old_prefix + "%"])
            for d in descendants:
                new_mp = new_prefix + d["materialized_path"][len(old_prefix):]
                db.update(FilePath, {"id": d["id"]}, {"materialized_path": new_mp})
                if sync is not None:
                    ops.append(sync.shared_update(FilePath, d["pub_id"], "materialized_path",
                                                  new_mp))
        if ops:
            sync.log_ops(ops)
    if ops:
        sync.created()
    library.emit("invalidate_query", {"key": "search.paths"})


def apply_remove_row(library: "Library", row: dict[str, Any]) -> None:
    from ..objects.fs import _remove_rows

    _remove_rows(library, row)
    library.emit("invalidate_query", {"key": "search.paths"})


def apply_remove(library: "Library", location: dict[str, Any], rel_path: str) -> None:
    """Drop the row of a vanished path, and a directory's whole subtree."""
    for is_dir in (False, True):  # a delete event may not say which it was
        iso = IsolatedFilePathData.from_relative(location["id"], rel_path, is_dir)
        row = _row_for(library, location["id"], iso)
        if row is not None:
            apply_remove_row(library, row)
            return


def _iso_ts(ts: float) -> str:
    return dt.datetime.fromtimestamp(ts, dt.timezone.utc).isoformat()


def _mtime_of(row: dict[str, Any]) -> float:
    value = row.get("date_modified")
    if value is None:
        return 0.0
    if isinstance(value, (int, float)):
        return float(value)
    if isinstance(value, str):
        try:
            return dt.datetime.fromisoformat(value).timestamp()
        except ValueError:
            return 0.0
    return value.timestamp()


# ---------------------------------------------------------------------------
# Event handler
# ---------------------------------------------------------------------------

class EventHandler:
    """Normalized events into row changes, with the Linux handler's
    buffering: creates and modifies wait 100 ms a path (a burst of writes
    to one file is one update), rename pairs match by cookie, a dangling
    ``moved_from`` becomes a remove after 1 s, and the changed files are
    identified again in one shallow pass a flush."""

    def __init__(self, library: "Library", location: dict[str, Any],
                 rules: CompiledRules, backend) -> None:
        self.library = library
        self.location = location
        self.rules = rules
        self.backend = backend
        self.files_to_update: dict[str, float] = {}
        self.rename_from: dict[int, tuple[str, bool, float]] = {}
        self.need_identify = False
        #: a shallow identify pass is running (read by LocationWatcher.flush)
        self.identifying = False

    def _rel(self, path: str) -> str | None:
        root = self.location["path"].rstrip("/")
        if path == root or not path.startswith(root + "/"):
            return None
        return path[len(root) + 1:]

    def _allowed(self, rel_path: str, is_dir: bool, abs_path: str) -> bool:
        try:
            return self.rules.allows_path(rel_path, is_dir, abs_path=abs_path)
        except Exception:
            return True

    def handle(self, ev: RawEvent) -> None:
        if ev.kind == "overflow":
            # the kernel dropped events: reconcile with a light pass
            from . import light_scan_location

            logger.warning("watcher queue overflow; rescanning location %s",
                           self.location["id"])
            STATS["overflow"] += 1
            try:
                light_scan_location(self.library, self.location["id"])
            except Exception:
                logger.exception("overflow rescan failed")
            return
        rel = self._rel(ev.path)
        if rel is None or os.path.basename(ev.path) == ".spacedrive":
            return
        if not self._allowed(rel, ev.is_dir, ev.path):
            return
        STATS["events"] += 1
        now = time.monotonic()
        if ev.kind == "create":
            if ev.is_dir:
                self.backend.watch_new_dir(ev.path)
                self._index_subtree(rel)
            else:
                self.files_to_update[ev.path] = now
        elif ev.kind == "modify":
            if not ev.is_dir:
                self.files_to_update[ev.path] = now
        elif ev.kind == "moved_from":
            self.rename_from[ev.cookie] = (ev.path, ev.is_dir, now)
        elif ev.kind == "moved_to":
            pending = self.rename_from.pop(ev.cookie, None)
            if pending is None:
                self._moved_in(rel, ev)
                return
            from_path, is_dir, _ = pending
            from_rel = self._rel(from_path)
            if is_dir:
                self.backend.note_dir_moved(from_path, ev.path)
            if from_rel is not None:
                apply_rename(self.library, self.location, from_rel, rel, is_dir)
            else:
                self._moved_in(rel, ev)
        elif ev.kind == "delete":
            self.files_to_update.pop(ev.path, None)
            apply_remove(self.library, self.location, rel)

    def _moved_in(self, rel: str, ev: RawEvent) -> None:
        """A ``moved_to`` with no ``moved_from``: the path came from outside
        the watched tree, a plain create."""
        if ev.is_dir:
            self.backend.watch_new_dir(ev.path)
            self._index_subtree(rel)
        else:
            self.files_to_update[ev.path] = time.monotonic()

    def _index_subtree(self, rel_path: str) -> None:
        """A directory appeared (created or moved in): index it and
        everything under it."""
        from .indexer_job import _entry_to_row
        from .walker import db_fetcher_for, walk

        db = self.library.db
        if not apply_create(self.library, self.location, rel_path, True):
            return
        result = walk(self.location["id"], self.location["path"], self.rules,
                      db_fetcher_for(db, self.location["id"]),
                      sub_path=rel_path, include_root=False)
        rows = [_entry_to_row(e) for e in result.walked]
        if rows:
            sync = emitter(self.library)
            with db.transaction():
                db.insert_many(FilePath, rows, or_ignore=True)
                if sync is not None:
                    sync.shared_create_many(FilePath, rows)
            if sync is not None:
                sync.created()
            self.need_identify = True
        self.library.emit("invalidate_query", {"key": "search.paths"})

    def tick(self) -> None:
        now = time.monotonic()
        ready = [p for p, t in self.files_to_update.items() if now - t >= HUNDRED_MILLIS]
        expired = [c for c, (_p, _d, t) in self.rename_from.items() if now - t >= ONE_SECOND]
        if ready or expired:
            with telemetry.span(None, "watcher.apply") as sp:
                self._apply_ready(ready, expired)
            STATS["apply_s"] += sp.duration_s
        if self.need_identify and not self.files_to_update:
            self.need_identify = False
            from ..objects.file_identifier import shallow_identify

            STATS["identify"] += 1
            self.identifying = True
            sp = telemetry.span(None, "watcher.identify")
            try:
                with sp, _kernels.origin("watcher"):
                    got = shallow_identify(self.library, self.location["id"])
                telemetry.event("watcher.identify", location=self.location["id"],
                                files=got.get("identified", 0),
                                duration_ms=round(sp.duration_s * 1000.0, 3))
            except Exception:
                STATS["identify_failed"] += 1
                logger.exception("watcher re-identify failed")
            finally:
                STATS["identify_s"] += sp.duration_s
                self.identifying = False

    def _apply_ready(self, ready: list[str], expired: list) -> None:
        """The debounced updates older than the window, then the renames
        whose other half never came (they moved out of the location)."""
        for path in ready:
            del self.files_to_update[path]
            rel = self._rel(path)
            if rel is None:
                continue
            if apply_update(self.library, self.location, rel, False):
                self.need_identify = True
        for cookie in expired:
            path, _is_dir, _t = self.rename_from.pop(cookie)
            rel = self._rel(path)
            if rel is not None:
                apply_remove(self.library, self.location, rel)


# ---------------------------------------------------------------------------
# The watcher actor
# ---------------------------------------------------------------------------

def _make_backend(root: str):
    if sys.platform.startswith("linux"):
        try:
            return InotifyBackend(root)
        except OSError as e:
            logger.warning("inotify unavailable (%s); polling fallback", e)
    return PollingBackend(root)


class LocationWatcher:
    """One thread a location: reads its backend and applies the events
    until stopped. :meth:`ignore_path` mutes a path (the fs jobs' own
    writes)."""

    def __init__(self, library: "Library", location_id: int,
                 backend_factory: Callable[[str], Any] | None = None,
                 poll_interval: float = 0.25) -> None:
        row = library.db.find_one(Location, {"id": location_id})
        if row is None or not row.get("path"):
            raise ValueError(f"location {location_id} has no path")
        if not Path(row["path"]).is_dir():
            raise ValueError(f"location path missing on disk: {row['path']}")
        self.library = library
        self.location = row
        self.poll_interval = poll_interval
        self._ignored: set[str] = set()
        self._ignored_lock = threading.Lock()
        self.backend = (backend_factory or _make_backend)(row["path"])
        rules = CompiledRules(rules_for_location(library.db, location_id))
        self.handler = EventHandler(library, row, rules, self.backend)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"watcher-{location_id}", daemon=True)
        self._thread.start()

    def ignore_path(self, path: str | Path, ignore: bool) -> None:
        with self._ignored_lock:
            if ignore:
                self._ignored.add(str(path))
            else:
                self._ignored.discard(str(path))

    def _is_ignored(self, path: str) -> bool:
        with self._ignored_lock:
            for ig in self._ignored:
                if path == ig or path.startswith(ig.rstrip("/") + "/"):
                    return True
        return False

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                for ev in self.backend.read(self.poll_interval):
                    if not self._is_ignored(ev.path):
                        self.handler.handle(ev)
                self.handler.tick()
            except Exception:
                logger.exception("watcher loop error (location %s)", self.location["id"])
                time.sleep(0.5)

    def flush(self, timeout: float = 3.0) -> bool:
        """Wait (at most ``timeout`` seconds) until the debounce buffers
        are empty and no identify pass is pending or running. True when they
        are."""
        h = self.handler
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if not (h.files_to_update or h.rename_from or h.need_identify or h.identifying):
                return True
            time.sleep(0.05)
        return False

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        self.backend.close()
