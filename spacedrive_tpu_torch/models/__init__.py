"""Library database: the trimmed model layer and the library's tables."""

from .base import MODEL_REGISTRY, Database, Field, Model, Relation, Shared, utc_now
from .schema import (ALL_MODELS, SYNCED_MODELS, ChunkManifest, FilePath, IndexerRule,
                     IndexerRulesInLocation, Instance, JobRow, Location, MediaData,
                     NearDuplicate, NodeRow, Notification, Object, Preference,
                     RelationOperationRow, SharedOperationRow, Statistics, Tag, TagOnObject)

__all__ = [
    "ALL_MODELS", "ChunkManifest", "Database", "Field", "FilePath", "IndexerRule",
    "IndexerRulesInLocation", "Instance", "JobRow", "Location", "MODEL_REGISTRY", "MediaData",
    "Model", "NearDuplicate", "NodeRow", "Notification", "Object", "Preference", "Relation",
    "RelationOperationRow", "SYNCED_MODELS", "Shared", "SharedOperationRow", "Statistics",
    "Tag", "TagOnObject", "utc_now",
]
