"""categories.list (``spacedrive_tpu/api/routers/categories.py``): the
seeded overview categories with their object counts by kind."""

from __future__ import annotations

from ...objects.kind import CATEGORY_KINDS
from ...objects.tags import CATEGORIES


def mount(router) -> None:
    @router.library_query("categories.list", pool=True)
    def list_categories(node, library, _arg):
        counts = {r["kind"]: r["n"] for r in library.db.query(
            "SELECT kind, COUNT(*) n FROM object GROUP BY kind")}
        out = []
        for name in CATEGORIES:
            kinds = CATEGORY_KINDS.get(name, ())
            out.append({"category": name, "kinds": list(kinds),
                        "count": sum(counts.get(k, 0) for k in kinds)})
        return out
