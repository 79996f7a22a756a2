"""Ephemeral (non-indexed) directory browsing.

Counterpart of ``spacedrive_tpu/locations/non_indexed.py``: list a directory
outside any location without touching a database. Entries get kinds from
the extension registry, the default system rules filter noise, and with
``with_cas_ids`` files get the cas_id of their content. With a node, the
thumbnailable images get thumbnails in the node's cache, made on the host
one at a time (at most ``EPHEMERAL_THUMBS_PER_REQUEST`` new ones a call),
and their cas_ids are registered with the thumbnail remover first, so a
full sweep running meanwhile does not collect a thumbnail the answer
advertises.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any

from ..objects.cas import generate_cas_id
from ..objects.kind import ObjectKind, kind_from_extension
from .rules import SYSTEM_RULES, CompiledRules, IndexerRuleSpec

#: new thumbnails made a request; the rest report pending and come with
#: the next requests (a cache hit is free and not counted)
EPHEMERAL_THUMBS_PER_REQUEST = 32


def _default_rules(include_hidden: bool) -> CompiledRules:
    specs: list[IndexerRuleSpec] = [s for s in SYSTEM_RULES if s.default]
    if include_hidden:
        specs = [s for s in specs if s.name != "No Hidden"]
    return CompiledRules(specs)


def walk_ephemeral(path: str | Path, include_hidden: bool = False,
                   with_cas_ids: bool = False, node: Any = None) -> dict[str, Any]:
    """One directory's listing, ``{"entries", "errors"}``; with ``node``
    (and cas_ids), thumbnails too, and rows carry ``has_thumbnail``."""
    root = Path(path)
    if not root.is_dir():
        raise NotADirectoryError(str(root))
    rules = _default_rules(include_hidden)
    entries: list[dict[str, Any]] = []
    errors: list[str] = []
    try:
        listing = sorted(os.scandir(root), key=lambda e: e.name)
    except OSError as e:
        return {"entries": [], "errors": [f"scandir {root}: {e}"]}
    for entry in listing:
        try:
            if entry.is_symlink():
                continue
            is_dir = entry.is_dir(follow_symlinks=False)
            if not rules.allows_path(entry.name, is_dir, abs_path=entry.path):
                continue
            st = entry.stat(follow_symlinks=False)
            name, dot, ext = entry.name.rpartition(".")
            if is_dir or not dot or not name:
                name, ext = entry.name, ""
            kind = ObjectKind.FOLDER if is_dir else kind_from_extension(ext.lower(), False)
            row: dict[str, Any] = {
                "name": name, "extension": ext.lower() if not is_dir else "",
                "kind": kind, "is_dir": is_dir,
                "size_in_bytes": 0 if is_dir else st.st_size,
                "date_modified": st.st_mtime, "date_created": st.st_ctime,
                "hidden": entry.name.startswith("."),
                "path": entry.path,
            }
            if with_cas_ids and not is_dir and st.st_size > 0:
                try:
                    row["cas_id"] = generate_cas_id(entry.path, st.st_size)
                except (OSError, EOFError) as e:
                    errors.append(f"cas {entry.name}: {e}")
            entries.append(row)
        except OSError as e:
            errors.append(f"stat {entry.name}: {e}")
    if node is not None:
        _attach_thumbnails(node, entries, errors)
    return {"entries": entries, "errors": errors}


def _attach_thumbnails(node: Any, entries: list[dict[str, Any]], errors: list[str]) -> None:
    from ..objects.media.thumbnail import (can_generate_thumbnail, generate_thumbnail,
                                           thumbnail_path)

    candidates = [row for row in entries
                  if row.get("cas_id") and can_generate_thumbnail(row.get("extension"))]
    if candidates:
        # registered before any is made or advertised, once a request (one
        # registry write)
        node.thumbnail_remover.register_ephemeral([row["cas_id"] for row in candidates])
    generated = pending = 0
    for row in candidates:
        cas = row["cas_id"]
        if thumbnail_path(node.data_dir, cas).exists():
            row["has_thumbnail"] = True
            continue
        if generated >= EPHEMERAL_THUMBS_PER_REQUEST:
            pending += 1
            row["has_thumbnail"] = False
            continue
        made = generate_thumbnail(row["path"], node.data_dir, cas, row.get("extension"))
        generated += 1
        if made is None:
            errors.append(f"thumbnail {row['name']}")
            continue
        row["has_thumbnail"] = True
    if pending:
        errors.append(f"{pending} thumbnails deferred "
                      f"(cap {EPHEMERAL_THUMBS_PER_REQUEST}/request)")
