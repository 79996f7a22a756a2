"""Locations actor: the online set and the media warm start.

Counterpart of ``spacedrive_tpu/locations/manager.py`` (:25-96). The node
boots it after its libraries and before their cold resume, as the reference
does; it marks every location of every loaded library online, and
:meth:`LocationsActor.media_warm_start` hands freshly identified prefixes to
the media lane. The filesystem watcher (``_start_watcher``, the
``LocationWatcher`` of every online location) is not ported: the port has
no watcher yet, so a location's changes reach its rows only through a
rescan.
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
        #: (library id, location id, prefix) already handed to the media
        #: lane by this process
        self._warm_started: set[tuple[str, int, str]] = set()
        for library in node.libraries.list():
            for row in library.db.find(Location):
                self.add(library, row["id"])

    def add(self, library: "Library", location_id: int) -> None:
        with self._lock:
            self._online.add((library.id, location_id))

    def remove(self, library: "Library", location_id: int) -> None:
        with self._lock:
            self._online.discard((library.id, location_id))

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
