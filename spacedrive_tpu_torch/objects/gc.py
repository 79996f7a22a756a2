"""GC actors: the orphan-object remover and the thumbnail remover.

Counterpart of ``spacedrive_tpu/objects/gc.py``. Both are daemon threads
whose ticks are constructor arguments, so tests tick them at will:

- :class:`OrphanRemoverActor`, one a library: every ``tick_interval`` (1
  minute) or on :meth:`~OrphanRemoverActor.invoke`, at most once a
  ``debounce`` (10 s), deletes in batches of 512 the objects no file_path
  points at, with their ``tag_on_object``, ``media_data`` and
  ``chunk_manifest`` rows (the port's tables that hang off an object; the
  reference's label, space and album links are not in the port's schema). A cancelled or killed scan
  leaves no orphan of its own (an object is created in the transaction that
  links it), but a rescan that re-identifies a changed file does. Unlike
  the reference's, it never runs inside a sync pull round, which can apply
  an object's create before its files' links: there, a tick between the
  two deleted the object, and the files lost their link on that node only.
- :class:`ThumbnailRemoverActor`, one a node: every ``batch_interval`` (30
  s) deletes the thumbnails marked for deletion, and every
  ``full_interval`` (half an hour) every cached thumbnail whose cas_id no
  loaded library references.

The ephemeral-thumbnail shield:
:meth:`~ThumbnailRemoverActor.register_ephemeral`, called by the browse of
a directory outside any location (``search.ephemeralPaths`` with
thumbnails) before it makes them, shields a cas_id from the full sweep for
``EPHEMERAL_TTL`` after its last browse. The registry is persisted in
``thumbnails/ephemeral.json``, so the shield outlives a restart.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from pathlib import Path
from typing import TYPE_CHECKING, Iterable

from ..atomic import atomic_write_text

if TYPE_CHECKING:
    from ..library import Library
    from ..node import Node

logger = logging.getLogger(__name__)

TEN_SECONDS = 10.0
ONE_MINUTE = 60.0
THIRTY_SECS = 30.0
HALF_HOUR = 30.0 * 60.0

_ORPHAN_BATCH = 512
#: the port's tables whose rows belong to an object
_OBJECT_LINKS = ("tag_on_object", "media_data", "chunk_manifest")


class OrphanRemoverActor:
    """Deletes the objects that no file_path points at any more."""

    def __init__(self, library: "Library", tick_interval: float = ONE_MINUTE,
                 debounce: float = TEN_SECONDS) -> None:
        self.library = library
        self.tick_interval = tick_interval
        self.debounce = debounce
        self._signal = threading.Event()
        self._stop = threading.Event()
        self._last_checked = 0.0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"orphan-remover-{library.id[:8]}")
        self._thread.start()

    def invoke(self) -> None:
        self._signal.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            self._signal.wait(self.tick_interval)
            if self._stop.is_set():
                return
            self._signal.clear()
            # an invoke inside the debounce window waits for its end
            wait_left = self.debounce - (time.monotonic() - self._last_checked)
            if wait_left > 0 and self._stop.wait(wait_left):
                return
            try:
                self.process_clean_up()
            except Exception:
                logger.exception("orphan cleanup failed")
            self._last_checked = time.monotonic()

    def process_clean_up(self) -> int:
        """The batched delete loop; returns the objects removed. It waits
        for a running sync pull round to end (``sync.ingest_round``)."""
        with self.library.sync.ingest_round:
            return self._clean_up()

    def _clean_up(self) -> int:
        db = self.library.db
        removed = 0
        while True:
            ids = [r["id"] for r in db.query(
                "SELECT o.id FROM object o WHERE NOT EXISTS "
                "(SELECT 1 FROM file_path fp WHERE fp.object_id = o.id) LIMIT ?",
                [_ORPHAN_BATCH])]
            if not ids:
                return removed
            marks = ",".join("?" for _ in ids)
            # the orphan test again inside every delete: an object linked
            # since the select survives
            still_orphan = (f"object_id IN (SELECT o.id FROM object o WHERE o.id IN ({marks}) "
                            f"AND NOT EXISTS (SELECT 1 FROM file_path fp "
                            f"WHERE fp.object_id = o.id))")
            with db.transaction():
                for table in _OBJECT_LINKS:
                    db.execute(f"DELETE FROM {table} WHERE {still_orphan}", ids)
                db.execute(f"DELETE FROM object WHERE id IN ({marks}) AND NOT EXISTS "
                           f"(SELECT 1 FROM file_path fp WHERE fp.object_id = object.id)", ids)
            removed += len(ids)
            logger.debug("removed %d orphaned objects", len(ids))

    def stop(self) -> None:
        self._stop.set()
        self._signal.set()
        self._thread.join(timeout=5)


class ThumbnailRemoverActor:
    """Sweeps the cas-sharded thumbnail cache: marked thumbnails go at the
    next short tick, and the full sweep deletes those of cas_ids no loaded
    library references."""

    #: how long a registered ephemeral thumbnail survives the full sweep
    #: after its last browse
    EPHEMERAL_TTL = 24 * 3600.0

    def __init__(self, node: "Node", batch_interval: float = THIRTY_SECS,
                 full_interval: float = HALF_HOUR) -> None:
        self.node = node
        self.batch_interval = batch_interval
        self.full_interval = full_interval
        self._marked: set[str] = set()
        # cas_id -> last browse time, persisted: the first sweep after a
        # restart must not collect thumbnails browsed just before it
        self._ephemeral: dict[str, float] = self._load_ephemeral()
        self._marked_lock = threading.Lock()
        self._signal = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="thumbnail-remover")
        self._thread.start()

    def mark_for_deletion(self, cas_ids: Iterable[str]) -> None:
        """Delete these at the next short tick, with no liveness check."""
        with self._marked_lock:
            self._marked.update(cas_ids)
        self._signal.set()

    def register_ephemeral(self, cas_ids: Iterable[str]) -> None:
        """Shield thumbnails no library row references from the full sweep
        while they were browsed recently."""
        now = time.time()
        with self._marked_lock:
            for cas in cas_ids:
                self._ephemeral[cas] = now
            snapshot = dict(self._ephemeral)
        self._save_ephemeral(snapshot)

    def _ephemeral_path(self) -> Path:
        return self._thumb_dir() / "ephemeral.json"

    def _load_ephemeral(self) -> dict[str, float]:
        try:
            raw = json.loads(self._ephemeral_path().read_text())
            return {str(k): float(v) for k, v in raw.items()}
        except Exception:  # a missing or malformed side file is an empty registry
            return {}

    def _save_ephemeral(self, snapshot: dict[str, float]) -> None:
        try:
            atomic_write_text(self._ephemeral_path(), json.dumps(snapshot))
        except OSError as e:
            logger.debug("could not persist the ephemeral registry: %s", e)

    def _run(self) -> None:
        last_full = 0.0
        while not self._stop.is_set():
            self._signal.wait(self.batch_interval)
            if self._stop.is_set():
                return
            self._signal.clear()
            try:
                self.process_marked()
                if time.monotonic() - last_full >= self.full_interval:
                    self.full_sweep()
                    last_full = time.monotonic()
            except Exception:
                logger.exception("thumbnail GC failed")

    def _thumb_dir(self) -> Path:
        from .media.thumbnail import thumbnail_dir

        return Path(thumbnail_dir(self.node.data_dir))

    def process_marked(self) -> int:
        with self._marked_lock:
            marked, self._marked = self._marked, set()
        base = self._thumb_dir()
        return sum(1 for cas_id in marked if self._delete_thumb(base, cas_id))

    def full_sweep(self) -> int:
        """Delete every cached thumbnail whose cas_id no library references;
        returns how many."""
        base = self._thumb_dir()
        on_disk = [entry.stem for shard in base.iterdir() if shard.is_dir()
                   for entry in shard.glob("*.webp")]
        if not on_disk:
            return 0
        alive: set[str] = set()
        for library in self.node.libraries.list():
            for start in range(0, len(on_disk), 500):
                chunk = on_disk[start:start + 500]
                marks = ",".join("?" for _ in chunk)
                alive.update(r["cas_id"] for r in library.db.query(
                    f"SELECT DISTINCT cas_id FROM file_path WHERE cas_id IN ({marks})", chunk))
        cutoff = time.time() - self.EPHEMERAL_TTL
        with self._marked_lock:
            self._ephemeral = {c: t for c, t in self._ephemeral.items() if t >= cutoff}
        removed = 0
        for cas_id in on_disk:
            if cas_id in alive:
                continue
            # the shield is read under the lock right before the unlink: a
            # browse registered since the sweep began still protects it
            with self._marked_lock:
                if cas_id in self._ephemeral:
                    continue
                if self._delete_thumb(base, cas_id):
                    removed += 1
        if removed:
            logger.info("thumbnail GC removed %d stale thumbnails", removed)
        return removed

    def _delete_thumb(self, base: Path, cas_id: str) -> bool:
        path = base / cas_id[:2] / f"{cas_id}.webp"
        try:
            path.unlink()
        except FileNotFoundError:
            return False
        except OSError as e:
            logger.warning("could not delete thumbnail %s: %s", cas_id, e)
            return False
        try:
            path.parent.rmdir()  # prune an empty shard
        except OSError:
            pass
        return True

    def stop(self) -> None:
        self._stop.set()
        self._signal.set()
        self._thread.join(timeout=5)
