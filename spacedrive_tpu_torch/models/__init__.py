"""Library database: the trimmed model layer and the scan's tables."""

from .base import Database, Field, Model, utc_now
from .schema import (ALL_MODELS, ChunkManifest, FilePath, IndexerRule,
                     IndexerRulesInLocation, JobRow, Location, MediaData, NearDuplicate,
                     Object)

__all__ = [
    "ALL_MODELS", "ChunkManifest", "Database", "Field", "FilePath",
    "IndexerRule", "IndexerRulesInLocation", "JobRow", "Location", "MediaData",
    "Model", "NearDuplicate", "Object", "utc_now",
]
