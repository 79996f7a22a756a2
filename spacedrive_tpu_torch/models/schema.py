"""The library tables, column for column as
``spacedrive_tpu/models/schema.py`` declares them (the sync op log
shared_operation :43 and relation_operation :59, node :78, instance :92,
location :149, file_path :174, object :216, job :348, indexer_rule :375,
indexer_rule_in_location :388, near_duplicate :420, chunk_manifest :439,
media_data :233, statistics :114, tag :257, tag_on_object :271,
notification :410, preference :400), so rows written by the two packages
compare directly, with the reference's ``SYNC`` annotations: location,
file_path, object, tag and preference are :class:`Shared`, tag_on_object is
a :class:`Relation` of tag and object, instance is local.
:data:`SYNCED_MODELS` maps their tables to them (:489).
"""

from __future__ import annotations

from .base import Field, Model, Relation, Shared

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


# ---- sync op log -----------------------------------------------------------


class SharedOperationRow(Model):
    TABLE = "shared_operation"
    FIELDS = {
        "id": Field(_T, primary_key=True),  # op uuid
        "timestamp": Field(_I, nullable=False),  # NTP64 HLC
        "model": Field(_T, nullable=False),
        "record_id": Field(_T, nullable=False),
        "kind": Field(_T, nullable=False),  # c | u:<field> | d
        "data": Field(_J),
        "instance_id": Field(_I, nullable=False, references="instance.id", on_delete="RESTRICT"),
    }
    #: (timestamp, id) serves get_ops' ORDER BY + LIMIT without a sort
    INDEXES = (("instance_id", "timestamp"), ("model", "record_id"), ("timestamp", "id"))


class RelationOperationRow(Model):
    TABLE = "relation_operation"
    FIELDS = {
        "id": Field(_T, primary_key=True),
        "timestamp": Field(_I, nullable=False),
        "relation": Field(_T, nullable=False),
        "item_id": Field(_T, nullable=False),
        "group_id": Field(_T, nullable=False),
        "kind": Field(_T, nullable=False),
        "data": Field(_J),
        "instance_id": Field(_I, nullable=False, references="instance.id", on_delete="RESTRICT"),
    }
    INDEXES = (("instance_id", "timestamp"), ("relation", "item_id", "group_id"),
               ("timestamp", "id"))


# ---- identity ---------------------------------------------------------------


class NodeRow(Model):
    """Deprecated in the reference's schema, kept for parity."""

    TABLE = "node"
    FIELDS = {
        "id": _pk(),
        "pub_id": _pub_id(),
        "name": Field(_T, nullable=False),
        "platform": Field(_I, nullable=False),
        "date_created": Field(_D, nullable=False),
        "identity": Field(_BY),
    }


class Instance(Model):
    """A paired instance of this library; ``timestamp`` persists the
    per-instance HLC floor that ingest has applied."""

    TABLE = "instance"
    SYNC = None  # @local(id: pub_id)
    FIELDS = {
        "id": _pk(),
        "pub_id": _pub_id(),
        "identity": Field(_T, nullable=False),  # the tagged I:/R: encoding
        "node_remote_identity": Field(_T),
        "node_id": Field(_T, nullable=False),
        "node_name": Field(_T, nullable=False),
        "node_platform": Field(_I, nullable=False),
        "last_seen": Field(_D, nullable=False),
        "date_created": Field(_D, nullable=False),
        "timestamp": Field(_I),
    }


# ---- core domain --------------------------------------------------------------


class Location(Model):
    TABLE = "location"
    SYNC = Shared(id="pub_id")
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
        # a declared FK, so emission sends it as the instance's pub_id
        "instance_id": Field(_I, references="instance.id", on_delete="SET NULL"),
        #: which hasher identified files here; the port writes its device
        "hasher": Field(_T, default="tpu"),
    }


class FilePath(Model):
    TABLE = "file_path"
    SYNC = Shared(id="pub_id")
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
    SYNC = Shared(id="pub_id")
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
    SYNC = Shared(id="pub_id")
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
    SYNC = Relation(item="tag", group="object")
    FIELDS = {
        "tag_id": Field(_I, nullable=False, references="tag.id", on_delete="RESTRICT"),
        "object_id": Field(_I, nullable=False, references="object.id", on_delete="RESTRICT"),
    }
    UNIQUES = (("tag_id", "object_id"),)


class Preference(Model):
    """One leaf of the library's preference tree, by its dotted key."""

    TABLE = "preference"
    SYNC = Shared(id="key")
    SYNC_SKIP = ()
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
    Instance,  # the op-log tables reference it: created first
    SharedOperationRow, RelationOperationRow, NodeRow, Statistics, Location, FilePath, Object, MediaData, Tag, TagOnObject, JobRow,
    IndexerRule, IndexerRulesInLocation, Notification, ChunkManifest, NearDuplicate,
    Preference,
)

SYNCED_MODELS: dict[str, type[Model]] = {m.TABLE: m for m in ALL_MODELS if m.SYNC is not None}
