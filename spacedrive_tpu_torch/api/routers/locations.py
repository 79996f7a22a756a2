"""locations.* procedures (``spacedrive_tpu/api/routers/locations.py``):
CRUD, rescans, the online subscription and the indexer_rules sub-router.
``create`` and ``addLibrary`` scan the new location, as in the reference;
``locations.create`` records the reference's default hasher name
(``"hybrid"``), which the port hashes on the node's device like any name
but ``"tpu-sharded"``."""

from __future__ import annotations

from ...locations import (create_location, delete_location, light_scan_location,
                          read_metadata, scan_location)
from ...locations.rules import IndexerRuleSpec, rules_for_location, seed_rules
from ...models import IndexerRule, IndexerRulesInLocation, Location
from ..invalidate import invalidate_query
from ..router import ApiError
from ._util import filtered_subscription


def _rule_specs(db, location_id: int) -> list[dict]:
    return [{"name": s.name, "rules": s.rules, "default": s.default}
            for s in rules_for_location(db, location_id)]


def mount(router) -> None:
    @router.library_query("locations.list")
    def list_locations(node, library, _arg):
        rows = library.db.find(Location, order_by="name")
        online = set(node.locations.online_ids(library.id))
        for r in rows:
            r["online"] = r["id"] in online
        return rows

    @router.library_query("locations.get", pool=True, replica=False)
    def get(node, library, location_id: int):
        row = library.db.find_one(Location, {"id": location_id})
        if row is None:
            raise ApiError("location not found", code=404)
        return row

    @router.library_query("locations.getWithRules", pool=True, replica=False)
    def get_with_rules(node, library, location_id: int):
        row = library.db.find_one(Location, {"id": location_id})
        if row is None:
            raise ApiError("location not found", code=404)
        row["indexer_rules"] = _rule_specs(library.db, location_id)
        return row

    @router.library_mutation("locations.create")
    def create(node, library, arg):
        row = create_location(library, arg["path"], name=arg.get("name"),
                              indexer_rule_names=arg.get("indexer_rules"),
                              hasher=arg.get("hasher", "hybrid"),
                              dry_run=arg.get("dry_run", False))
        if not arg.get("dry_run"):
            scan_location(library, row["id"])
        return row

    @router.library_mutation("locations.update")
    def update(node, library, arg):
        db = library.db
        location_id = arg["id"]
        if db.find_one(Location, {"id": location_id}) is None:
            raise ApiError("location not found", code=404)
        values = {k: arg[k] for k in ("name", "hidden", "generate_preview_media", "hasher")
                  if k in arg}
        if values:
            db.update(Location, {"id": location_id}, values)
        if "indexer_rules" in arg:
            db.delete(IndexerRulesInLocation, {"location_id": location_id})
            for rule_name in arg["indexer_rules"]:
                rule = db.find_one(IndexerRule, {"name": rule_name})
                if rule:
                    db.insert(IndexerRulesInLocation,
                              {"location_id": location_id, "indexer_rule_id": rule["id"]},
                              or_ignore=True)
        invalidate_query(library, "locations.list")
        return None

    @router.library_mutation("locations.delete")
    def delete(node, library, location_id: int):
        delete_location(library, location_id)
        return None

    @router.library_mutation("locations.relink")
    def relink(node, library, path: str):
        """Re-bind a moved location directory through its .spacedrive
        sidecar. As in the reference, the sidecar maps the library to the
        location id itself, which this lookup indexes as a mapping: a relink
        that finds its entry raises TypeError there too."""
        meta = read_metadata(path)
        if meta is None or library.id not in meta.get("libraries", {}):
            raise ApiError("no spacedrive metadata for this library here")
        location_id = meta["libraries"][library.id]["location_id"]
        library.db.update(Location, {"id": location_id}, {"path": str(path)})
        invalidate_query(library, "locations.list")
        return location_id

    @router.library_mutation("locations.addLibrary")
    def add_library(node, library, arg):
        """Add a directory another library already tracks to this library
        too (the sidecar keeps one entry a library)."""
        row = create_location(library, arg["path"], name=arg.get("name"),
                              indexer_rule_names=arg.get("indexer_rules"),
                              hasher=arg.get("hasher", "hybrid"))
        scan_location(library, row["id"])
        invalidate_query(library, "locations.list")
        return row

    @router.library_mutation("locations.fullRescan")
    def full_rescan(node, library, arg):
        return scan_location(library, arg["location_id"])

    @router.library_mutation("locations.subPathRescan")
    def sub_path_rescan(node, library, arg):
        return scan_location(library, arg["location_id"], sub_path=arg.get("sub_path"))

    @router.library_mutation("locations.quickRescan")
    def quick_rescan(node, library, arg):
        light_scan_location(library, arg["location_id"], arg.get("sub_path", ""))
        invalidate_query(library, "search.paths")
        return None

    @router.library_subscription("locations.online")
    def online(node, library, _arg):
        return filtered_subscription(node, {"locations_online"}, library.id)

    # -- indexer_rules sub-router ------------------------------------------
    @router.library_query("locations.indexer_rules.list")
    def rules_list(node, library, _arg):
        seed_rules(library.db)
        return library.db.find(IndexerRule, order_by="name")

    @router.library_query("locations.indexer_rules.get", pool=True, replica=False)
    def rules_get(node, library, rule_id: int):
        row = library.db.find_one(IndexerRule, {"id": rule_id})
        if row is None:
            raise ApiError("rule not found", code=404)
        return row

    @router.library_query("locations.indexer_rules.listForLocation", pool=True, replica=False)
    def rules_for_loc(node, library, location_id: int):
        return _rule_specs(library.db, location_id)

    @router.library_mutation("locations.indexer_rules.create")
    def rules_create(node, library, arg):
        spec = IndexerRuleSpec(name=arg["name"], default=False,
                               rules={int(k): v for k, v in arg["rules"].items()})
        rule_id = library.db.insert(IndexerRule, spec.to_row())
        invalidate_query(library, "locations.indexer_rules.list")
        return rule_id

    @router.library_mutation("locations.indexer_rules.delete")
    def rules_delete(node, library, rule_id: int):
        row = library.db.find_one(IndexerRule, {"id": rule_id})
        if row and row["default"]:
            raise ApiError("cannot delete a system rule")
        library.db.delete(IndexerRulesInLocation, {"indexer_rule_id": rule_id})
        library.db.delete(IndexerRule, {"id": rule_id})
        invalidate_query(library, "locations.indexer_rules.list")
        invalidate_query(library, "locations.indexer_rules.listForLocation")
        invalidate_query(library, "locations.getWithRules")
        return None
