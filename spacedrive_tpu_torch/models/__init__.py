"""Library database: the trimmed model layer and the scan's tables."""

from .base import Database, Field, Model, utc_now
from .schema import (ALL_MODELS, ChunkManifest, FilePath, IndexerRule,
                     IndexerRulesInLocation, JobRow, Location, MediaData, NearDuplicate,
                     Notification, Object, Preference, Statistics, Tag,
                     TagOnObject)

__all__ = [
    "ALL_MODELS", "ChunkManifest", "Database", "Field", "FilePath",
    "IndexerRule", "IndexerRulesInLocation", "JobRow", "Location", "MediaData",
    "Model", "NearDuplicate", "Notification", "Object", "Preference", "Statistics", "Tag",
    "TagOnObject", "utc_now",
]
