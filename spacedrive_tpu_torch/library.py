"""Libraries: one SQLite database per library under ``<data_dir>/libraries/``.

Counterpart of ``spacedrive_tpu/library.py`` (``Libraries.create`` :288),
trimmed to what a scan and a search need: the ``<uuid>.sdlibrary`` JSON
sidecar with the name, the ``<uuid>.db`` database with the port's tables,
``Library.emit`` onto the node's event bus, and each library's
:class:`.objects.gc.OrphanRemoverActor` (``library.py`` :278-286).
:meth:`Libraries.init` sweeps the ``*.sd-tmp*`` debris a kill left in the
libraries directory and in the node's ``thumbnails`` and ``backups``
directories before it opens anything (:204-212). Sync, instance identities
and the boot-time repair ladder are not ported; SQLite's own WAL recovery
runs when a database opens.
"""

from __future__ import annotations

import json
import threading
import uuid
from pathlib import Path
from typing import TYPE_CHECKING, Any

from .atomic import cleanup_stale_tmp
from .models import ALL_MODELS, Database

if TYPE_CHECKING:
    from .node import Node


class Library:
    def __init__(self, lib_id: str, name: str, db: Database, node: "Node | None") -> None:
        from .objects.gc import OrphanRemoverActor

        self.id = lib_id
        self.name = name
        self.db = db
        self.node = node
        self.orphan_remover = OrphanRemoverActor(self)

    def emit(self, kind: str, payload: Any = None) -> None:
        """An event scoped to this library on the node's bus (none when the
        library has no node)."""
        if self.node is not None:
            self.node.events.emit_kind(kind, payload, library_id=self.id)

    def close(self) -> None:
        self.orphan_remover.stop()
        self.db.close()


class Libraries:
    """Loads and owns every library under ``<data_dir>/libraries``."""

    def __init__(self, data_dir: str | Path, node: "Node | None") -> None:
        self.dir = Path(data_dir) / "libraries"
        self.node = node
        self._lock = threading.Lock()
        self._libraries: dict[str, Library] = {}

    def init(self) -> None:
        """Sweep the temporaries a killed write left, then open every
        library already on disk."""
        self.dir.mkdir(parents=True, exist_ok=True)
        cleanup_stale_tmp(self.dir)
        if self.node is not None:
            for artifact_dir in ("backups", "thumbnails"):
                cleanup_stale_tmp(self.node.data_dir / artifact_dir)
        for cfg_path in sorted(self.dir.glob("*.sdlibrary")):
            self._open(cfg_path.stem, json.loads(cfg_path.read_text())["name"])

    def _open(self, lib_id: str, name: str) -> Library:
        library = Library(lib_id, name, Database(self.dir / f"{lib_id}.db", ALL_MODELS),
                          self.node)
        with self._lock:
            self._libraries[lib_id] = library
        return library

    def list(self) -> list[Library]:
        with self._lock:
            return list(self._libraries.values())

    def get(self, lib_id: str) -> Library:
        """The open library ``lib_id``; KeyError when there is none."""
        with self._lock:
            return self._libraries[lib_id]

    def create(self, name: str, description: str = "") -> Library:
        name = name.strip()
        if not name:
            raise ValueError("library name cannot be empty")
        lib_id = str(uuid.uuid4())
        self.dir.mkdir(parents=True, exist_ok=True)
        (self.dir / f"{lib_id}.sdlibrary").write_text(
            json.dumps({"version": 1, "name": name, "description": description}))
        return self._open(lib_id, name)

    def close(self) -> None:
        with self._lock:
            libs = list(self._libraries.values())
            self._libraries.clear()
        for lib in libs:
            lib.close()
