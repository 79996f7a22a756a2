"""Indexer rules: per-location accept/reject filtering (copy of
spacedrive_tpu/locations/rules.py, with the same system rules, so both
packages index the same file set).

Mirrors core/src/location/indexer/rules/mod.rs — four rule kinds
(:155-177): accept/reject files by glob, accept/reject directories by the
presence of named children — plus the seeded system rules (rules/seed.rs:
"No OS protected", "No Hidden", "No node_modules", "Only Git Repositories").

Globs are compiled to regexes with globset semantics (``**`` crosses
separators, ``*``/``?`` don't, ``{a,b}`` alternation, ``[...]`` classes).
"""

from __future__ import annotations

import dataclasses
import os
import re
import uuid
from pathlib import Path
from typing import Any, Iterable

from ..models import Database, IndexerRule, IndexerRulesInLocation, utc_now


class RuleKind:
    ACCEPT_FILES_BY_GLOB = 0
    REJECT_FILES_BY_GLOB = 1
    ACCEPT_IF_CHILDREN_DIRECTORIES_ARE_PRESENT = 2
    REJECT_IF_CHILDREN_DIRECTORIES_ARE_PRESENT = 3


def glob_to_regex(glob: str) -> str:
    """globset-compatible translation."""
    out = []
    i, n = 0, len(glob)
    while i < n:
        c = glob[i]
        if c == "*":
            if glob[i : i + 3] == "**/":
                out.append("(?:[^/]+/)*")
                i += 3
                continue
            if glob[i : i + 2] == "**":
                out.append(".*")
                i += 2
                continue
            out.append("[^/]*")
        elif c == "?":
            out.append("[^/]")
        elif c == "[":
            j = i + 1
            if j < n and glob[j] in "!^":
                j += 1
            if j < n and glob[j] == "]":
                j += 1
            while j < n and glob[j] != "]":
                j += 1
            if j >= n:
                out.append(re.escape(c))
            else:
                cls = glob[i + 1 : j].replace("\\", "\\\\")
                if cls.startswith(("!", "^")):
                    cls = "^" + cls[1:]
                out.append(f"[{cls}]")
                i = j
        elif c == "{":
            j = glob.find("}", i)
            if j == -1:
                out.append(re.escape(c))
            else:
                alts = glob[i + 1 : j].split(",")
                out.append("(?:" + "|".join(re.escape(a) for a in alts) + ")")
                i = j
        else:
            out.append(re.escape(c))
        i += 1
    return "".join(out)


def compile_globs(globs: Iterable[str]) -> re.Pattern:
    return re.compile("|".join(f"(?:{glob_to_regex(g)})" for g in globs) or r"(?!x)x")


@dataclasses.dataclass
class IndexerRuleSpec:
    """One named rule = per-kind parameter lists (rules_per_kind in the DB)."""

    name: str
    default: bool
    rules: dict[int, list[str]]  # RuleKind -> globs or child names
    pub_id: str = dataclasses.field(default_factory=lambda: str(uuid.uuid4()))

    def to_row(self) -> dict[str, Any]:
        return {
            "pub_id": self.pub_id,
            "name": self.name,
            "default": self.default,
            "rules_per_kind": {str(k): v for k, v in self.rules.items()},
            "date_created": utc_now(),
            "date_modified": utc_now(),
        }

    @classmethod
    def from_row(cls, row: dict[str, Any]) -> "IndexerRuleSpec":
        return cls(
            name=row["name"],
            default=bool(row["default"]),
            rules={int(k): v for k, v in (row["rules_per_kind"] or {}).items()},
            pub_id=row["pub_id"],
        )


class CompiledRules:
    """All rules for one location, compiled once per walk."""

    def __init__(self, specs: list[IndexerRuleSpec]) -> None:
        accept, reject, reject_abs = [], [], []
        self.accept_children: list[set[str]] = []
        self.reject_children: list[set[str]] = []
        for spec in specs:
            accept += spec.rules.get(RuleKind.ACCEPT_FILES_BY_GLOB, [])
            for g in spec.rules.get(RuleKind.REJECT_FILES_BY_GLOB, []):
                # globs anchored at "/" target absolute OS paths (the seeded
                # /proc, /sys... guards) — entries are walked as
                # location-relative, so these match the absolute path instead
                (reject_abs if g.startswith("/") else reject).append(g)
            if RuleKind.ACCEPT_IF_CHILDREN_DIRECTORIES_ARE_PRESENT in spec.rules:
                self.accept_children.append(
                    set(spec.rules[RuleKind.ACCEPT_IF_CHILDREN_DIRECTORIES_ARE_PRESENT]))
            if RuleKind.REJECT_IF_CHILDREN_DIRECTORIES_ARE_PRESENT in spec.rules:
                self.reject_children.append(
                    set(spec.rules[RuleKind.REJECT_IF_CHILDREN_DIRECTORIES_ARE_PRESENT]))
        self._accept = compile_globs(accept) if accept else None
        self._reject = compile_globs(reject)
        self._reject_abs = compile_globs(reject_abs) if reject_abs else None

    def allows_path(self, rel_path: str, is_dir: bool, abs_path: str = "") -> bool:
        """Glob acceptance for one entry (path relative to location root;
        ``abs_path`` additionally screens the absolute-anchored rejects)."""
        if self._reject.fullmatch(rel_path):
            return False
        if self._reject_abs is not None and abs_path and self._reject_abs.fullmatch(abs_path):
            return False
        if self._accept is not None and not is_dir and not self._accept.fullmatch(rel_path):
            return False
        return True

    def allows_dir_by_children(self, dir_path: Path) -> bool:
        """Children-presence rules need a directory listing."""
        if not self.accept_children and not self.reject_children:
            return True
        try:
            children = {e.name for e in os.scandir(dir_path) if e.is_dir(follow_symlinks=False)}
        except OSError:
            return True
        for required in self.accept_children:
            if not (children & required):
                return False
        for banned in self.reject_children:
            if children & banned:
                return False
        return True


# -- seeded system rules (rules/seed.rs) ------------------------------------

NO_OS_PROTECTED = IndexerRuleSpec(
    name="No OS protected",
    default=True,
    rules={RuleKind.REJECT_FILES_BY_GLOB: [
        "**/.DS_Store", "**/Thumbs.db", "**/desktop.ini",
        # leading "/" = absolute-path rejects (see CompiledRules.allows_path)
        "/proc/**", "/sys/**", "/dev/**", "/run/**", "/boot/**",
        "**/System Volume Information/**", "**/$RECYCLE.BIN/**",
        "**/lost+found/**", "**/.Trash-*/**",
    ]},
)

NO_HIDDEN = IndexerRuleSpec(
    name="No Hidden",
    default=True,
    rules={RuleKind.REJECT_FILES_BY_GLOB: ["**/.*"]},
)

NO_NODE_MODULES = IndexerRuleSpec(
    name="No node_modules",
    default=True,
    rules={RuleKind.REJECT_FILES_BY_GLOB: ["**/node_modules", "**/node_modules/**"]},
)

ONLY_GIT_REPOSITORIES = IndexerRuleSpec(
    name="Only Git Repositories",
    default=False,
    rules={RuleKind.ACCEPT_IF_CHILDREN_DIRECTORIES_ARE_PRESENT: [".git"]},
)

SYSTEM_RULES = (NO_OS_PROTECTED, NO_HIDDEN, NO_NODE_MODULES, ONLY_GIT_REPOSITORIES)


def seed_rules(db: Database) -> None:
    """Insert system rules once per library (idempotent by name)."""
    for spec in SYSTEM_RULES:
        if db.find_one(IndexerRule, {"name": spec.name}) is None:
            db.insert(IndexerRule, spec.to_row())


def rules_for_location(db: Database, location_id: int) -> list[IndexerRuleSpec]:
    links = db.find(IndexerRulesInLocation, {"location_id": location_id})
    specs = []
    for link in links:
        row = db.find_one(IndexerRule, {"id": link["indexer_rule_id"]})
        if row:
            specs.append(IndexerRuleSpec.from_row(row))
    return specs
