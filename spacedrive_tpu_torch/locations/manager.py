"""Locations actor: the online set, the watchers and the media warm start.

Counterpart of ``spacedrive_tpu/locations/manager.py``. The node boots it
after its libraries and before their cold resume, as the reference does;
it marks every location of every loaded library online and, unless the
node's ``watch_locations`` is off, starts a :class:`.watcher.LocationWatcher`
on each (:meth:`LocationsActor._start_watcher`), so a change on disk
reaches the rows without a rescan. :meth:`LocationsActor.media_warm_start`
hands freshly identified prefixes to the media lane.
"""

from __future__ import annotations

import logging
import threading
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from ..library import Library
    from ..node import Node

logger = logging.getLogger(__name__)


class LocationsActor:
    def __init__(self, node: "Node") -> None:
        from ..models import Location

        self.node = node
        self._lock = threading.Lock()
        self._online: set[tuple[str, int]] = set()  # (library id, location id)
        self._watchers: dict[tuple[str, int], object] = {}
        #: (library id, location id, prefix) already handed to the media
        #: lane by this process
        self._warm_started: set[tuple[str, int, str]] = set()
        for library in node.libraries.list():
            for row in library.db.find(Location):
                self.add(library, row["id"])

    def add(self, library: "Library", location_id: int) -> None:
        with self._lock:
            self._online.add((library.id, location_id))
        self._start_watcher(library, location_id)

    def remove(self, library: "Library", location_id: int) -> None:
        key = (library.id, location_id)
        with self._lock:
            self._online.discard(key)
            self._stop_watcher(key)

    def drop_library(self, library_id: str) -> None:
        """A library closed for good (deleted, or unloaded for a restore):
        its locations go offline and their watchers stop."""
        with self._lock:
            for key in [k for k in self._online if k[0] == library_id]:
                self._online.discard(key)
                self._stop_watcher(key)

    def is_online(self, library_id: str, location_id: int) -> bool:
        with self._lock:
            return (library_id, location_id) in self._online

    def online_ids(self, library_id: str) -> list[int]:
        with self._lock:
            return sorted(loc for lib, loc in self._online if lib == library_id)

    def media_warm_start(self, library: "Library", location_id: int,
                         prefixes: set[str]) -> None:
        """Spawn one media-lane MediaProcessorJob per new prefix, which runs
        beside the default lane's scan chain instead of after identify.
        Best effort: each prefix once a process, a dedup rejection
        swallowed, since the chain's whole-location media job takes up
        whatever was missed (existing thumbnails are skipped)."""
        from ..jobs import JobAlreadyRunning
        from ..objects.media.processor import MediaProcessorJob

        for prefix in sorted(prefixes):
            key = (library.id, location_id, prefix)
            with self._lock:
                if key in self._warm_started:
                    continue
                self._warm_started.add(key)
            try:
                self.node.jobs.spawn(library, [MediaProcessorJob(
                    {"location_id": location_id, "sub_path": prefix})],
                    action="media_warm_start")
            except JobAlreadyRunning:
                pass
            except Exception:
                logger.exception("media warm start failed for %s", prefix)

    def _start_watcher(self, library: "Library", location_id: int) -> None:
        if not getattr(self.node, "watch_locations", True):
            return
        from .watcher import LocationWatcher

        key = (library.id, location_id)
        with self._lock:
            if key in self._watchers:
                return
            try:
                self._watchers[key] = LocationWatcher(library, location_id)
            except Exception as e:
                logger.warning("watcher for location %s failed to start: %s",
                               location_id, e)

    def watcher_for(self, library_id: str, location_id: int):
        """The location's watcher, or None (``ignore_path`` on it mutes a
        path: the reference's IgnorePath channel)."""
        with self._lock:
            return self._watchers.get((library_id, location_id))

    def _stop_watcher(self, key: tuple[str, int]) -> None:
        """Callers hold the lock."""
        watcher = self._watchers.pop(key, None)
        if watcher is not None:
            try:
                watcher.stop()
            except Exception:
                logger.exception("watcher stop failed")

    def stop(self) -> None:
        """Stop every watcher (the node's shutdown, after its jobs)."""
        with self._lock:
            keys = list(self._watchers)
        for key in keys:
            with self._lock:
                self._stop_watcher(key)
