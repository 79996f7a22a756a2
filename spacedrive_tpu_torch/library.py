"""Libraries: one SQLite database per library under ``<data_dir>/libraries/``.

Counterpart of ``spacedrive_tpu/library.py`` (``Libraries.create`` :288,
``edit`` :334, ``delete`` :350), trimmed to what a scan, a search, sync and
the ``libraries.*`` procedures need: the ``<uuid>.sdlibrary`` JSON sidecar
with the name, the description and the library's own ``instance_id``, the
``<uuid>.db`` database with the port's tables, ``Library.emit`` onto the
node's event bus, and each library's services (``_attach_services``,
:278-286): its :class:`.sync.SyncManager` (``library.sync``, emitting when
the node's ``syncEmitMessages`` feature flag is on) and its
:class:`.objects.gc.OrphanRemoverActor`.

Each library has an ``instance`` row of its own, made at create with a
fresh ed25519 identity (:mod:`.p2p.identity`); :meth:`Library.instance`
reads it, and :meth:`Library.add_remote_instance` registers a paired
peer's (the reference's two-instance tests pair libraries so, by hand).
:meth:`Libraries.init` sweeps the ``*.sd-tmp*`` debris a kill left in the
libraries directory and in the node's ``thumbnails`` and ``backups``
directories before it opens anything (:204-212). Before a database opens,
the boot gate (:func:`.recovery.ensure_library_integrity`, :219-231) checks
it and repairs a corrupt one from the newest valid backup under
``<data_dir>/backups`` (or starts it fresh); a database without the row
its sidecar's ``instance_id`` names (a fresh repair) gets a new instance
row and the sidecar is repointed (``_ensure_instance_row``, :242-274).

The library-manager events (:class:`LibraryManagerEvent`: load, edit,
delete, instances modified) reach :meth:`Libraries.subscribe`'s callbacks
synchronously, on the thread that caused them; a new subscriber first gets
a load for every open library. The p2p layer's
:class:`~.p2p.nlm.NetworkedLibraries` rebuilds its per-library peer state
from them. :meth:`Libraries.create` takes the pairing path's ``lib_id``,
``instance_pub_id`` and ``instance_identity`` (reference :288-333): a
paired node mirrors the library under the same uuid, with the instance its
pairing request announced.
"""

from __future__ import annotations

import json
import logging
import threading
import uuid
from pathlib import Path
from typing import TYPE_CHECKING, Any, Callable

from .atomic import atomic_write_text, cleanup_stale_tmp
from .config import PLATFORM
from .models import ALL_MODELS, Database, Instance, utc_now

if TYPE_CHECKING:
    from .node import Node

logger = logging.getLogger(__name__)

class LibraryManagerEvent:
    LOAD = "load"
    EDIT = "edit"
    DELETE = "delete"
    INSTANCES_MODIFIED = "instances_modified"


def validate_library_name(name: str) -> str:
    name = name.strip()
    if not name:
        raise ValueError("library name cannot be empty")
    return name


class Library:
    def __init__(self, lib_id: str, name: str, db: Database, node: "Node | None",
                 description: str = "", instance_id: int = 0) -> None:
        self.id = lib_id
        self.name = name
        self.description = description
        self.db = db
        self.node = node
        #: the id of this library's own row in ``instance``
        self.instance_id = instance_id
        self.sync = None  # attached by Libraries._attach_services
        self.orphan_remover = None

    def emit(self, kind: str, payload: Any = None) -> None:
        """An event scoped to this library on the node's bus (none when the
        library has no node)."""
        if self.node is not None:
            self.node.events.emit_kind(kind, payload, library_id=self.id)

    def instance(self) -> dict[str, Any] | None:
        """This library's own instance row."""
        return self.db.find_one(Instance, {"id": self.instance_id})

    def add_remote_instance(self, instance_row: dict[str, Any]) -> int:
        """Register a paired peer's instance row (its local id is dropped);
        returns the row's id here. An instance already known keeps its row."""
        row = {k: v for k, v in instance_row.items() if k != "id"}
        row.setdefault("last_seen", utc_now())
        row.setdefault("date_created", utc_now())
        existing = self.db.find_one(Instance, {"pub_id": row["pub_id"]})
        if existing is not None:
            return existing["id"]
        return self.db.insert(Instance, row)

    def close(self) -> None:
        if self.orphan_remover is not None:
            self.orphan_remover.stop()
        pool = self.__dict__.pop("_ingest_lanes", None)
        if pool is not None:  # the partitioned ingest lanes (sync/lanes.py)
            pool.close()
        self.db.close()


class Libraries:
    """Loads and owns every library under ``<data_dir>/libraries``."""

    def __init__(self, data_dir: str | Path, node: "Node | None") -> None:
        self.dir = Path(data_dir) / "libraries"
        self.node = node
        self._lock = threading.Lock()
        self._libraries: dict[str, Library] = {}
        self._subscribers: list[Callable[[str, Library], None]] = []

    def subscribe(self, fn: Callable[[str, Library], None]) -> None:
        """Call ``fn(event, library)`` on every library-manager event; a load
        for each open library first."""
        with self._lock:
            self._subscribers.append(fn)
            current = list(self._libraries.values())
        for library in current:
            fn(LibraryManagerEvent.LOAD, library)

    def _emit(self, event: str, library: Library) -> None:
        with self._lock:
            subs = list(self._subscribers)
        for fn in subs:
            try:
                fn(event, library)
            except Exception:
                logger.exception("library %s event subscriber failed", event)

    def notify_instances_modified(self, library: Library) -> None:
        """Pairing added instance rows: the subscribers rebuild."""
        self._emit(LibraryManagerEvent.INSTANCES_MODIFIED, library)

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
        db = Database(self.dir / f"{lib_id}.db", ALL_MODELS)
        cfg_path = self.dir / f"{lib_id}.sdlibrary"
        cfg = json.loads(cfg_path.read_text()) if cfg_path.exists() else {}
        instance_id = self._ensure_instance_row(lib_id, name, description,
                                                cfg.get("instance_id", 0), db)
        library = Library(lib_id, name, db, self.node, description, instance_id)
        self._attach_services(library)
        with self._lock:
            self._libraries[lib_id] = library
        self._emit(LibraryManagerEvent.LOAD, library)
        return library

    def _new_instance_row(self, db: Database, pub_id: str | None = None,
                          identity: str | None = None) -> int:
        """This node's instance row in ``db``: ``pub_id`` and the encoded
        ``identity`` when pairing chose them, else fresh ones."""
        from .p2p.identity import Identity, encode_identity

        node_cfg = self.node.config.get() if self.node is not None else {}
        seed = node_cfg.get("keypair_seed")
        return db.insert(Instance, {
            "pub_id": pub_id or str(uuid.uuid4()),
            "identity": identity or encode_identity(Identity()),
            "node_remote_identity": (Identity.from_seed(seed).to_remote_identity().encode()
                                     if seed else None),
            "node_id": node_cfg.get("id", str(uuid.uuid4())),
            "node_name": node_cfg.get("name", "node"),
            "node_platform": node_cfg.get("platform", PLATFORM),
            "last_seen": utc_now(),
            "date_created": utc_now(),
        })

    def _ensure_instance_row(self, lib_id: str, name: str, description: str,
                             instance_id: int, db: Database) -> int:
        """The sidecar's ``instance_id`` when the database has that row;
        else (a fresh database after a repair, a sidecar from before sync)
        a new row, and the sidecar points at it."""
        if instance_id and db.find_one(Instance, {"id": instance_id}) is not None:
            return instance_id
        had = instance_id
        instance_id = self._new_instance_row(db)
        self._write_config(lib_id, name, description, instance_id)
        if had:
            logger.warning("library %s had no instance row %d (a fresh database?); "
                           "made instance %d", lib_id[:8], had, instance_id)
        return instance_id

    def _attach_services(self, library: Library) -> None:
        from .config import BackendFeature
        from .objects.gc import OrphanRemoverActor
        from .sync.manager import SyncManager

        library.sync = SyncManager(library)
        if self.node is not None:
            library.sync.emit_messages = self.node.config.has_feature(
                BackendFeature.SYNC_EMIT_MESSAGES)
        library.orphan_remover = OrphanRemoverActor(library)

    def list(self) -> list[Library]:
        with self._lock:
            return list(self._libraries.values())

    def get(self, lib_id: str) -> Library:
        """The open library ``lib_id``; KeyError when there is none."""
        with self._lock:
            return self._libraries[lib_id]

    def _write_config(self, library_id: str, name: str, description: str,
                      instance_id: int) -> None:
        atomic_write_text(self.dir / f"{library_id}.sdlibrary", json.dumps(
            {"version": 1, "name": name, "description": description,
             "instance_id": instance_id}))

    def create(self, name: str, description: str = "", lib_id: str | None = None,
               instance_pub_id: str | None = None,
               instance_identity: str | None = None) -> Library:
        """A new library with its own instance row; ``lib_id``,
        ``instance_pub_id`` and ``instance_identity`` are the pairing
        path's (a mirror under the peer's uuid)."""
        name = validate_library_name(name)
        lib_id = lib_id or str(uuid.uuid4())
        with self._lock:
            if lib_id in self._libraries:
                raise ValueError(f"library {lib_id} already exists")
        self.dir.mkdir(parents=True, exist_ok=True)
        instance_id = 0
        if instance_pub_id is not None or instance_identity is not None:
            db = Database(self.dir / f"{lib_id}.db", ALL_MODELS)
            try:
                instance_id = self._new_instance_row(db, instance_pub_id, instance_identity)
            finally:
                db.close()
        self._write_config(lib_id, name, description, instance_id)
        return self._open(lib_id, name, description)

    def edit(self, lib_id: str, name: str | None = None,
             description: str | None = None) -> Library:
        library = self.get(lib_id)
        if name is not None:
            library.name = validate_library_name(name)
        if description is not None:
            library.description = description
        self._write_config(lib_id, library.name, library.description, library.instance_id)
        self._emit(LibraryManagerEvent.EDIT, library)
        return library

    def delete(self, lib_id: str) -> None:
        """Close the library and remove its sidecar and database."""
        actor = getattr(self.node, "locations", None) if self.node is not None else None
        if actor is not None:
            actor.drop_library(lib_id)
        self._emit(LibraryManagerEvent.DELETE, self.get(lib_id))
        self.unload(lib_id)
        (self.dir / f"{lib_id}.sdlibrary").unlink(missing_ok=True)
        (self.dir / f"{lib_id}.db").unlink(missing_ok=True)

    def close(self) -> None:
        with self._lock:
            libs = list(self._libraries.values())
            self._libraries.clear()
        for lib in libs:
            lib.close()
