"""The library tables the scan writes, column for column as
``spacedrive_tpu/models/schema.py`` declares them (location :149,
file_path :174, object :216, job :348, indexer_rule :375,
indexer_rule_in_location :388, near_duplicate :420, chunk_manifest :439,
media_data :233, statistics :114, tag :257, tag_on_object :271,
notification :410, preference :400), so rows written by the two packages compare directly.

One difference in constraints, none in columns: ``location.instance_id``
keeps its column but not its foreign key, because the port has no
``instance`` table (sync identity is not ported).
"""

from __future__ import annotations

from .base import Field, Model

_I = "INTEGER"
_T = "TEXT"
_B = "BOOLEAN"
_D = "DATETIME"
_BY = "BYTES"
_J = "JSON"


def _pk() -> Field:
    return Field(_I, primary_key=True, autoincrement=True)


def _pub_id() -> Field:
    return Field(_T, nullable=False, unique=True)


class Location(Model):
    TABLE = "location"
    FIELDS = {
        "id": _pk(),
        "pub_id": _pub_id(),
        "name": Field(_T),
        "path": Field(_T),
        "total_capacity": Field(_I),
        "available_capacity": Field(_I),
        "is_archived": Field(_B),
        "generate_preview_media": Field(_B),
        "sync_preview_media": Field(_B),
        "hidden": Field(_B),
        "date_created": Field(_D),
        "instance_id": Field(_I),
        #: which hasher identified files here; the port writes its device
        "hasher": Field(_T, default="tpu"),
    }


class FilePath(Model):
    TABLE = "file_path"
    FIELDS = {
        "id": _pk(),
        "pub_id": _pub_id(),
        "is_dir": Field(_B),
        "cas_id": Field(_T),
        "integrity_checksum": Field(_T),
        "location_id": Field(_I, references="location.id", on_delete="CASCADE"),
        "materialized_path": Field(_T),
        "name": Field(_T),
        "extension": Field(_T),
        "hidden": Field(_B),
        "size_in_bytes": Field(_I),
        "inode": Field(_I),
        "device": Field(_I),
        "object_id": Field(_I, references="object.id", on_delete="SET NULL"),
        "key_id": Field(_I),
        "date_created": Field(_D),
        "date_modified": Field(_D),
        "date_indexed": Field(_D),
    }
    UNIQUES = (
        ("location_id", "materialized_path", "name", "extension"),
        ("location_id", "inode", "device"),
    )
    INDEXES = (("location_id",), ("location_id", "materialized_path"),
               ("cas_id",), ("object_id",),
               ("materialized_path", "is_dir", "name"),
               ("location_id", "materialized_path COLLATE NOCASE"),
               ("location_id", "hidden"))


class Object(Model):
    TABLE = "object"
    FIELDS = {
        "id": _pk(),
        "pub_id": _pub_id(),
        "kind": Field(_I),
        "key_id": Field(_I),
        "hidden": Field(_B),
        "favorite": Field(_B),
        "important": Field(_B),
        "note": Field(_T),
        "date_created": Field(_D),
        "date_accessed": Field(_D),
    }


class JobRow(Model):
    """Persisted job reports; ``parent_id`` chains a job pipeline."""

    TABLE = "job"
    FIELDS = {
        "id": Field(_T, primary_key=True),  # job uuid
        "name": Field(_T),
        "action": Field(_T),
        "status": Field(_I),
        "errors_text": Field(_T),
        "data": Field(_BY),
        "metadata": Field(_J),
        "parent_id": Field(_T),
        "task_count": Field(_I),
        "completed_task_count": Field(_I),
        "date_estimated_completion": Field(_D),
        "date_created": Field(_D),
        "date_started": Field(_D),
        "date_completed": Field(_D),
    }
    INDEXES = (("status",), ("parent_id",))


class IndexerRule(Model):
    TABLE = "indexer_rule"
    FIELDS = {
        "id": _pk(),
        "pub_id": _pub_id(),
        "name": Field(_T),
        "default": Field(_B),
        "rules_per_kind": Field(_J),
        "date_created": Field(_D),
        "date_modified": Field(_D),
    }


class IndexerRulesInLocation(Model):
    TABLE = "indexer_rule_in_location"
    FIELDS = {
        "location_id": Field(_I, nullable=False, references="location.id",
                             on_delete="RESTRICT"),
        "indexer_rule_id": Field(_I, nullable=False, references="indexer_rule.id",
                                 on_delete="RESTRICT"),
    }
    UNIQUES = (("location_id", "indexer_rule_id"),)


class ChunkManifest(Model):
    """One content-defined chunk of an object; rows cascade with objects."""

    TABLE = "chunk_manifest"
    FIELDS = {
        "id": _pk(),
        "object_id": Field(_I, nullable=False, references="object.id",
                           on_delete="CASCADE"),
        "seq": Field(_I, nullable=False),
        "chunk_hash": Field(_T, nullable=False),
        "length": Field(_I, nullable=False),
    }
    UNIQUES = (("object_id", "seq"),)
    INDEXES = (("chunk_hash",),)


class NearDuplicate(Model):
    """A near-duplicate pair found by the MinHash detector: derived,
    local-only data, rebuilt by rescans; rows cascade away with their
    file_paths."""

    TABLE = "near_duplicate"
    FIELDS = {
        "id": _pk(),
        "file_path_a_id": Field(_I, nullable=False,
                                references="file_path.id", on_delete="CASCADE"),
        "file_path_b_id": Field(_I, nullable=False,
                                references="file_path.id", on_delete="CASCADE"),
        "similarity": Field("REAL", nullable=False),
        "date_detected": Field(_D),
    }
    UNIQUES = (("file_path_a_id", "file_path_b_id"),)


class MediaData(Model):
    """Image metadata of an object (dimensions, capture date, camera
    fields, GPS location with its plus code), written by the media
    processor. The stream columns are the reference's and stay empty until
    audio and video are ported."""

    TABLE = "media_data"
    FIELDS = {
        "id": _pk(),
        "dimensions": Field(_J),
        "media_date": Field(_T),
        "media_location": Field(_J),
        "camera_data": Field(_J),
        "artist": Field(_T),
        "description": Field(_T),
        "copyright": Field(_T),
        "exif_version": Field(_T),
        "duration_seconds": Field("REAL"),
        "bit_rate": Field(_I),
        "streams": Field(_J),
        "object_id": Field(_I, nullable=False, unique=True, references="object.id",
                           on_delete="CASCADE"),
    }


class Statistics(Model):
    TABLE = "statistics"
    FIELDS = {
        "id": _pk(),
        "date_captured": Field(_D, nullable=False),
        "total_object_count": Field(_I, default=0),
        "library_db_size": Field(_T, default="0"),
        "total_bytes_used": Field(_T, default="0"),
        "total_bytes_capacity": Field(_T, default="0"),
        "total_unique_bytes": Field(_T, default="0"),
        "total_bytes_free": Field(_T, default="0"),
        "preview_media_bytes": Field(_T, default="0"),
    }


class Tag(Model):
    TABLE = "tag"
    FIELDS = {
        "id": _pk(),
        "pub_id": _pub_id(),
        "name": Field(_T),
        "color": Field(_T),
        "redundancy_goal": Field(_I),
        "date_created": Field(_D),
        "date_modified": Field(_D),
    }


class TagOnObject(Model):
    TABLE = "tag_on_object"
    FIELDS = {
        "tag_id": Field(_I, nullable=False, references="tag.id", on_delete="RESTRICT"),
        "object_id": Field(_I, nullable=False, references="object.id", on_delete="RESTRICT"),
    }
    UNIQUES = (("tag_id", "object_id"),)


class Preference(Model):
    """One leaf of the library's preference tree, by its dotted key."""

    TABLE = "preference"
    FIELDS = {
        "key": Field(_T, primary_key=True),
        "value": Field(_J),
    }


class Notification(Model):
    """A library-level notification (node-level ones live in the node
    config)."""

    TABLE = "notification"
    FIELDS = {
        "id": _pk(),
        "read": Field(_B, default=0),
        "data": Field(_J, nullable=False),
        "expires_at": Field(_D),
    }


ALL_MODELS: tuple[type[Model], ...] = (
    Statistics, Location, FilePath, Object, MediaData, Tag, TagOnObject, JobRow,
    IndexerRule, IndexerRulesInLocation, Notification, ChunkManifest, NearDuplicate,
    Preference,
)
