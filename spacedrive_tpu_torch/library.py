"""Libraries: one SQLite database per library under ``<data_dir>/libraries/``.

Counterpart of ``spacedrive_tpu/library.py`` (``Libraries.create`` :288,
``edit`` :334, ``delete`` :350), trimmed to what a scan, a search and the
``libraries.*`` procedures need: the ``<uuid>.sdlibrary`` JSON sidecar with
the name and description, the ``<uuid>.db`` database with the port's tables,
``Library.emit`` onto the node's event bus, and each library's
:class:`.objects.gc.OrphanRemoverActor` (``library.py`` :278-286).
:meth:`Libraries.init` sweeps the ``*.sd-tmp*`` debris a kill left in the
libraries directory and in the node's ``thumbnails`` and ``backups``
directories before it opens anything (:204-212). Before a database opens,
the boot gate (:func:`.recovery.ensure_library_integrity`, :219-231) checks
it and repairs a corrupt one from the newest valid backup under
``<data_dir>/backups`` (or starts it fresh). Sync, instance identities (a
library has no ``instance_id``) and the library-manager events are not
ported.
"""

from __future__ import annotations

import json
import threading
import uuid
from pathlib import Path
from typing import TYPE_CHECKING, Any

from .atomic import atomic_write_text, cleanup_stale_tmp
from .models import ALL_MODELS, Database

if TYPE_CHECKING:
    from .node import Node


def validate_library_name(name: str) -> str:
    name = name.strip()
    if not name:
        raise ValueError("library name cannot be empty")
    return name


class Library:
    def __init__(self, lib_id: str, name: str, db: Database, node: "Node | None",
                 description: str = "") -> None:
        from .objects.gc import OrphanRemoverActor

        self.id = lib_id
        self.name = name
        self.description = description
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
            self.load(cfg_path.stem)

    def load(self, lib_id: str) -> Library:
        """Open the library whose config is on disk; its locations go
        online (and are watched) when the node's locations actor runs."""
        cfg = json.loads((self.dir / f"{lib_id}.sdlibrary").read_text())
        library = self._open(lib_id, cfg["name"], cfg.get("description", ""))
        actor = getattr(self.node, "locations", None) if self.node is not None else None
        if actor is not None:
            from .models import Location

            for row in library.db.find(Location):
                actor.add(library, row["id"])
        return library

    def unload(self, lib_id: str) -> None:
        """Close the library and forget it; its files stay."""
        library = self.get(lib_id)
        with self._lock:
            self._libraries.pop(lib_id, None)
        library.close()

    def _open(self, lib_id: str, name: str, description: str = "") -> Library:
        from .recovery import ensure_library_integrity

        ensure_library_integrity(
            self.dir, lib_id,
            backups_path=self.node.data_dir / "backups" if self.node is not None else None,
            node=self.node)
        library = Library(lib_id, name, Database(self.dir / f"{lib_id}.db", ALL_MODELS),
                          self.node, description)
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

    def _write_config(self, library_id: str, name: str, description: str) -> None:
        atomic_write_text(self.dir / f"{library_id}.sdlibrary", json.dumps(
            {"version": 1, "name": name, "description": description}))

    def create(self, name: str, description: str = "") -> Library:
        name = validate_library_name(name)
        lib_id = str(uuid.uuid4())
        self.dir.mkdir(parents=True, exist_ok=True)
        self._write_config(lib_id, name, description)
        return self._open(lib_id, name, description)

    def edit(self, lib_id: str, name: str | None = None,
             description: str | None = None) -> Library:
        library = self.get(lib_id)
        if name is not None:
            library.name = validate_library_name(name)
        if description is not None:
            library.description = description
        self._write_config(lib_id, library.name, library.description)
        return library

    def delete(self, lib_id: str) -> None:
        """Close the library and remove its sidecar and database."""
        actor = getattr(self.node, "locations", None) if self.node is not None else None
        if actor is not None:
            actor.drop_library(lib_id)
        self.unload(lib_id)
        (self.dir / f"{lib_id}.sdlibrary").unlink(missing_ok=True)
        (self.dir / f"{lib_id}.db").unlink(missing_ok=True)

    def close(self) -> None:
        with self._lock:
            libs = list(self._libraries.values())
            self._libraries.clear()
        for lib in libs:
            lib.close()
