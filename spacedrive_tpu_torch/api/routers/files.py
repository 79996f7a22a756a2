"""files.* procedures (``spacedrive_tpu/api/routers/files.py``): the object
and file_path getters, the note, favorite and access-time mutations, rename,
create, and the launchers of the fs jobs (copy, cut, duplicate, delete,
erase) and of the crypto jobs (``encryptFiles``, ``decryptFiles``). With
sync emitting, ``setNote`` and ``setFavorite`` log the
object's field update and ``renameFile`` the row's name and extension (and
each descendant's materialized_path), in the transaction of the write."""

from __future__ import annotations

from pathlib import Path

from ...models import FilePath, MediaData, Object, utc_now
from ...objects.crypto_jobs import FileDecryptorJob, FileEncryptorJob
from ...objects.fs import (FileCopierJob, FileCutterJob, FileDeleterJob, FileEraserJob,
                           create_directory, create_file, file_path_abs, location_path_of)
from ...objects.media.metadata import extract_media_data
from ...sync.manager import emitter
from ..invalidate import invalidate_query
from ..router import ApiError


def _set_object_field(library, object_id: int, field: str, value) -> None:
    """One object field, with its sync update when sync emits."""
    obj = _object_of(library, object_id)
    sync = emitter(library)
    ops = [] if sync is None else [sync.shared_update(Object, obj["pub_id"], field, value)]
    library.sync.write_ops(ops, lambda db: db.update(Object, {"id": obj["id"]}, {field: value}))


def _object_of(library, object_id: int) -> dict:
    row = library.db.find_one(Object, {"id": object_id})
    if row is None:
        raise ApiError(f"object {object_id} not found", code=404)
    return row


def mount(router) -> None:
    @router.library_query("files.get", pool=True, replica=False)
    def get(node, library, arg):
        """Object + its file_paths by object id or file_path id."""
        db = library.db
        if arg.get("file_path_id") is not None:
            fp = db.find_one(FilePath, {"id": arg["file_path_id"]})
            if fp is None:
                raise ApiError("file_path not found", code=404)
            obj = db.find_one(Object, {"id": fp["object_id"]}) if fp["object_id"] else None
        else:
            obj = _object_of(library, arg["object_id"])
            fp = None
        paths = db.find(FilePath, {"object_id": obj["id"]}) if obj else ([fp] if fp else [])
        return {"object": obj, "file_paths": paths}

    @router.library_query("files.getPath", pool=True, replica=False)
    def get_path(node, library, file_path_id: int):
        _row, path = file_path_abs(library.db, file_path_id)
        return str(path)

    @router.library_query("files.getMediaData", pool=True, replica=False)
    def get_media_data(node, library, object_id: int):
        return library.db.find_one(MediaData, {"object_id": object_id})

    @router.query("files.getEphemeralMediaData")
    def get_ephemeral_media_data(node, path: str):
        return extract_media_data(path, Path(path).suffix.lstrip(".").lower())

    @router.library_mutation("files.setNote")
    def set_note(node, library, arg):
        _set_object_field(library, arg["object_id"], "note", arg.get("note"))
        invalidate_query(library, "search.paths")
        return None

    @router.library_mutation("files.setFavorite")
    def set_favorite(node, library, arg):
        _set_object_field(library, arg["object_id"], "favorite", bool(arg.get("favorite")))
        invalidate_query(library, "search.paths")
        return None

    @router.library_mutation("files.updateAccessTime")
    def update_access_time(node, library, object_id: int):
        library.db.update(Object, {"id": object_id}, {"date_accessed": utc_now()})
        invalidate_query(library, "files.get")
        return None

    @router.library_mutation("files.removeAccessTime")
    def remove_access_time(node, library, object_id: int):
        library.db.update(Object, {"id": object_id}, {"date_accessed": None})
        invalidate_query(library, "files.get")
        return None

    @router.library_mutation("files.renameFile")
    def rename_file(node, library, arg):
        """Rename on disk and in the row; a directory's descendants get the
        new materialized_path prefix in the same transaction."""
        db = library.db
        row, path = file_path_abs(db, arg["file_path_id"])
        new_name = arg["new_name"]
        if "/" in new_name or new_name in (".", ".."):
            raise ApiError(f"invalid name {new_name!r}")
        target = path.with_name(new_name)
        if target.exists():
            raise ApiError(f"target exists: {target.name}", code=409)
        path.rename(target)
        stem, dot, ext = new_name.rpartition(".")
        if row["is_dir"] or not dot or not stem:
            stem, ext = new_name, ""
        sync = emitter(library)
        ops = []
        with db.transaction():
            db.update(FilePath, {"id": row["id"]}, {"name": stem, "extension": ext.lower()})
            if sync is not None:
                ops = [sync.shared_update(FilePath, row["pub_id"], "name", stem),
                       sync.shared_update(FilePath, row["pub_id"], "extension", ext.lower())]
            if row["is_dir"]:
                old_prefix = f"{row['materialized_path'] or '/'}{row['name']}/"
                new_prefix = f"{row['materialized_path'] or '/'}{stem}/"
                like = (old_prefix.replace("\\", "\\\\")
                        .replace("%", "\\%").replace("_", "\\_")) + "%"
                children = db.query(
                    "SELECT id, pub_id, materialized_path FROM file_path "
                    "WHERE location_id = ? AND materialized_path LIKE ? ESCAPE '\\'",
                    (row["location_id"], like))
                for child in children:
                    new_mp = new_prefix + child["materialized_path"][len(old_prefix):]
                    db.update(FilePath, {"id": child["id"]}, {"materialized_path": new_mp})
                    if sync is not None:
                        ops.append(sync.shared_update(FilePath, child["pub_id"],
                                                      "materialized_path", new_mp))
            if ops:
                sync.log_ops(ops)
        if ops:
            sync.created()
        invalidate_query(library, "search.paths")
        return None

    @router.library_mutation("files.createDirectory")
    def create_dir(node, library, arg):
        from ...locations import light_scan_location

        sub = arg.get("sub_path", "").strip("/")
        made = create_directory(location_path_of(library.db, arg["location_id"]) / sub,
                                arg.get("name", "New Folder"))
        light_scan_location(library, arg["location_id"], sub)
        invalidate_query(library, "search.paths")
        return str(made)

    @router.library_mutation("files.createFile")
    def create_file_(node, library, arg):
        from ...locations import light_scan_location

        sub = arg.get("sub_path", "").strip("/")
        made = create_file(location_path_of(library.db, arg["location_id"]) / sub,
                           arg.get("name", "New File"))
        light_scan_location(library, arg["location_id"], sub)
        invalidate_query(library, "search.paths")
        return str(made)

    # -- job launchers ------------------------------------------------------
    @router.library_mutation("files.copyFiles")
    def copy_files(node, library, arg):
        return node.jobs.spawn(library, [FileCopierJob({
            "sources": arg["sources"],
            "target_location_id": arg["target_location_id"],
            "target_dir": arg.get("target_dir", "")})])

    @router.library_mutation("files.cutFiles")
    def cut_files(node, library, arg):
        return node.jobs.spawn(library, [FileCutterJob({
            "sources": arg["sources"],
            "target_location_id": arg["target_location_id"],
            "target_dir": arg.get("target_dir", "")})])

    @router.library_mutation("files.duplicateFiles")
    def duplicate_files(node, library, arg):
        """Copy each source into its own directory (collision-safe names)."""
        jobs = []
        for fp_id in arg["sources"]:
            row, _path = file_path_abs(library.db, fp_id)
            jobs.append(FileCopierJob({
                "sources": [fp_id],
                "target_location_id": row["location_id"],
                "target_dir": (row["materialized_path"] or "/").strip("/")}))
        return node.jobs.spawn(library, jobs)

    @router.library_mutation("files.deleteFiles")
    def delete_files(node, library, arg):
        return node.jobs.spawn(library, [FileDeleterJob({"sources": arg["sources"]})])

    @router.library_mutation("files.eraseFiles")
    def erase_files(node, library, arg):
        return node.jobs.spawn(library, [FileEraserJob({
            "sources": arg["sources"], "passes": arg.get("passes", 2)})])

    @router.library_mutation("files.encryptFiles")
    def encrypt_files(node, library, arg):
        """FileEncryptorJob over the sources, with a password or a key_uuid."""
        return node.jobs.spawn(library, [FileEncryptorJob({
            "sources": arg["sources"],
            "password": arg.get("password"),
            "key_uuid": arg.get("key_uuid"),
            "algorithm": arg.get("algorithm", "XChaCha20Poly1305"),
            "metadata": arg.get("metadata", False),
            "erase_original": arg.get("erase_original", False)})])

    @router.library_mutation("files.decryptFiles")
    def decrypt_files(node, library, arg):
        """FileDecryptorJob over the sources' ``.bytes`` files."""
        return node.jobs.spawn(library, [FileDecryptorJob({
            "sources": arg["sources"],
            "password": arg.get("password"),
            "key_uuid": arg.get("key_uuid"),
            "erase_original": arg.get("erase_original", False)})])
