"""IsolatedFilePathData: the canonical path representation.

Copy of the parts of spacedrive_tpu/locations/paths.py the scan uses, which
mirrors core/src/location/file_path_helper/isolated_file_path_data.rs:25-38:
a file_path row is (location_id, materialized_path, name, extension, is_dir)
where ``materialized_path`` is the parent directory path relative to the
location root, always "/"-wrapped (``"/"``, ``"/sub/dir/"``). The location
root itself is (``"/"``, ``""``, ``""``, is_dir=True).
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Any


class FilePathError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class IsolatedFilePathData:
    location_id: int
    materialized_path: str  # parent dir, "/"-wrapped
    name: str
    extension: str
    is_dir: bool

    def __post_init__(self) -> None:
        mp = self.materialized_path
        if not (mp.startswith("/") and mp.endswith("/")):
            raise FilePathError(f"materialized_path must be '/'-wrapped: {mp!r}")

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_parts(cls, location_id: int, rel_dir: str, leaf: str,
                   is_dir: bool) -> "IsolatedFilePathData":
        """Fast constructor for the walker's hot loop: the caller already
        holds the parent dir (location-relative, no slashes wrapping) and
        the entry name — pure string ops, no PurePosixPath parsing."""
        parent = f"/{rel_dir}/" if rel_dir else "/"
        if is_dir:
            return cls(location_id, parent, leaf, "", True)
        stem, dot, ext = leaf.rpartition(".")
        if not dot or not stem:
            return cls(location_id, parent, leaf, "", False)
        return cls(location_id, parent, stem, ext.lower(), False)

    # -- conversions --------------------------------------------------------
    @property
    def full_name(self) -> str:
        if self.is_dir or not self.extension:
            return self.name
        return f"{self.name}.{self.extension}"

    def relative_path(self) -> str:
        """Path relative to the location root, no leading slash."""
        return (self.materialized_path + self.full_name).lstrip("/")

    def db_fields(self) -> dict[str, Any]:
        return {
            "location_id": self.location_id,
            "materialized_path": self.materialized_path,
            "name": self.name,
            "extension": self.extension,
            "is_dir": self.is_dir,
        }


@dataclasses.dataclass(frozen=True)
class FilePathMetadata:
    """stat() capture carried alongside each walked entry."""

    inode: int
    device: int
    size_in_bytes: int
    created_at: float
    modified_at: float
    hidden: bool

    @classmethod
    def from_stat(cls, path: "Path | str", st: os.stat_result) -> "FilePathMetadata":
        name = path if isinstance(path, str) else path.name
        return cls(
            inode=st.st_ino,
            device=st.st_dev,
            size_in_bytes=st.st_size,
            created_at=getattr(st, "st_ctime", 0.0),
            modified_at=st.st_mtime,
            hidden=name.startswith("."),
        )
