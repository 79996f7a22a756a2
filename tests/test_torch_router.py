"""The port's rspc router (spacedrive_tpu_torch/api) against the JAX
package's, on the CPU.

Two nodes, the JAX ``Node`` and ``spacedrive_tpu_torch.node.Node(device=
"cpu")``, go through the same calls of ``node.router.resolve(key, arg,
library_id)`` over the same small tree (one scan each, with chunk manifests
and the search engine on), and every ported procedure's answer is compared:
search (paths with the ``tags`` filter, objects, ephemeralPaths with
thumbnails, duplicates, chunkDuplicates), tags, libraries, locations, jobs,
notifications (the cold-resume failure notification included), files,
nodes, volumes, preferences, categories and backups, the mutations in
lockstep, and the subscriptions by the events they deliver. The files
mutations that change the disk run on a pair whose nodes each scan their
own copy of the tree, with each copy's root replaced by ``<tree>`` and
the ``inode`` keys dropped.

The comparison rule (:func:`norm`): an answer is compared as JSON with
every ``pub_id`` and ``*_pub_id`` key and every ``date_*`` key dropped,
every uuid string (library, job and node ids) replaced by ``<uuid>``, and
each node's own data dir replaced by ``<data>``; everything else must be
equal. One key more is dropped because the port does not have what it
names: in ``jobs.reports`` the ``metadata`` of each job (the run's timings
and the reference's telemetry trace; the scan's rows are compared in
tests/test_torch_scan.py).

With sync emitting (``toggleFeatureFlag``), the tag, note, favorite,
preference and rename mutations log the operations the JAX package's log
(``tests/torch_sync_cases.op_log``, a multiset with pub_ids mapped to what
their rows are), and ``sync.messages`` and ``sync.fleetStatus`` answer as
the JAX router's do. ``libraries.statistics`` is compared without
``total_bytes_free`` (the disk's free bytes move between the two calls) and
``library_db_size`` (each package's database holds its own tables), and
``volumes.list`` without ``available_capacity`` (the same free bytes).
"""

import json
import re
import shutil

import numpy as np
import pytest

from spacedrive_tpu.api import router as jax_router
from spacedrive_tpu.api.routers import backups as jax_backups
from spacedrive_tpu.api.routers import categories as jax_categories
from spacedrive_tpu.api.routers import files as jax_files
from spacedrive_tpu.api.routers import jobs as jax_jobs
from spacedrive_tpu.api.routers import libraries as jax_libraries
from spacedrive_tpu.api.routers import locations as jax_locations
from spacedrive_tpu.api.routers import nodes as jax_nodes
from spacedrive_tpu.api.routers import notifications as jax_notifications
from spacedrive_tpu.api.routers import keys as jax_keys
from spacedrive_tpu.api.routers import telemetry as jax_telemetry_router
from spacedrive_tpu.api.routers import p2p as jax_p2p
from spacedrive_tpu.api.routers import preferences as jax_preferences
from spacedrive_tpu.api.routers import root as jax_root
from spacedrive_tpu.api.routers import search as jax_search
from spacedrive_tpu.api.routers import sync as jax_sync_router
from spacedrive_tpu.api.routers import tags as jax_tags
from spacedrive_tpu.api.routers import volumes as jax_volumes
from spacedrive_tpu.jobs.report import JobReport as JaxJobReport
from spacedrive_tpu.jobs.report import JobStatus as JaxJobStatus
from spacedrive_tpu.node import Node as JaxNode
from spacedrive_tpu import telemetry as jax_telemetry
from spacedrive_tpu_torch import telemetry as port_telemetry
from spacedrive_tpu_torch.api.router import ApiError
from spacedrive_tpu_torch.jobs import JobReport, JobStatus
from spacedrive_tpu_torch.node import Node
from tests.torch_scan_cases import one_torch_thread  # noqa: F401
from tests.torch_sync_cases import op_log, pub_keys

UUID = re.compile(r"^[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}$")


def norm(value, data_dir: str):
    """The comparison rule of the module docstring."""
    if isinstance(value, dict):
        return {k: norm(v, data_dir) for k, v in value.items()
                if not (k == "pub_id" or k.endswith("_pub_id") or k.startswith("date_"))}
    if isinstance(value, list):
        return [norm(v, data_dir) for v in value]
    if isinstance(value, str):
        if UUID.match(value):
            return "<uuid>"
        return value.replace(data_dir, "<data>") if data_dir else value
    return value


def blob(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, size=n, dtype=np.uint8).tobytes()


def png(path, seed: int, h: int = 48, w: int = 64) -> None:
    from PIL import Image

    Image.fromarray(np.frombuffer(blob(seed, h * w * 3), np.uint8).reshape(h, w, 3)).save(path)


def make_tree(root):
    """Text files, two copies and a near copy over 100 KiB (a near-duplicate
    pair and shared chunks), a PNG, a subdirectory and a hidden file."""
    root.mkdir()
    for i in range(5):
        (root / f"note{i}.txt").write_bytes(blob(i, 400 + i))
    big = blob(50, 110_000)
    (root / "big_a.bin").write_bytes(big)
    (root / "big_b.bin").write_bytes(big)
    (root / "near.bin").write_bytes(big[:90_000] + blob(51, 20_000))
    png(root / "pic.png", 3)
    (root / "sub").mkdir()
    (root / "sub" / "deep.txt").write_bytes(b"deep" * 50)
    (root / ".hidden").write_bytes(b"skipped")
    return root


class Pair:
    """The two nodes, called in lockstep."""

    def __init__(self, base, **port_kw) -> None:
        self.base = base
        self.jax = JaxNode(base / "jax", probe_accelerator=False, watch_locations=False)
        self.port = Node(base / "port", device="cpu", **port_kw, watch_locations=False)
        self.libs: tuple = (None, None)

    def call(self, key, arg=None, scoped=False, args=None):
        """(jax answer, port answer), each normalized; a raise becomes
        ``("raised", type name)``. ``args`` gives each node its own arg."""
        out = []
        for i, node in enumerate((self.jax, self.port)):
            lib = self.libs[i] if scoped else None
            try:
                got = node.router.resolve(key, args[i] if args else arg, lib)
                out.append(norm(json.loads(json.dumps(got, default=str)), str(node.data_dir)))
            except Exception as e:  # noqa: BLE001 — compared below
                out.append(("raised", type(e).__name__))
        return tuple(out)

    def same(self, key, arg=None, scoped=False, args=None):
        want, got = self.call(key, arg, scoped, args)
        assert got == want, f"{key} {arg}"
        return got

    def wait(self) -> None:
        assert self.jax.jobs.wait_idle(120) and self.port.jobs.wait_idle(120)

    def object_ids(self, names):
        """Each node's object ids of the files ``names``."""
        out = []
        for node, lib in zip((self.jax, self.port), self.libs):
            db = node.libraries.get(lib).db
            out.append([db.query("SELECT object_id FROM file_path WHERE name = ?", [n])[0][0]
                        for n in names])
        return out

    def close(self) -> None:
        self.port.shutdown()
        self.jax.shutdown()


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("SD_P2P_DISABLED", "1")
    mp.setenv("SD_CHUNK_MANIFESTS", "1")
    mp.setenv("SD_CDC_KERNEL", "numpy")
    mp.setenv("SD_SEARCH_ENGINE", "device")
    reset_telemetry()
    yield
    mp.undo()


def scanned_pair(base, tree) -> Pair:
    pair = Pair(base)
    pair.libs = tuple(node.router.resolve("libraries.create", {"name": "lib"})["id"]
                      for node in (pair.jax, pair.port))
    pair.same("locations.create", {"path": str(tree)}, scoped=True)
    pair.wait()
    return pair


@pytest.fixture(scope="module")
def scanned(env, tmp_path_factory):
    """Both nodes after one scan of the tree and the same tag calls: tag
    "red" on the copies and the PNG, "blue" on one note, "blue" renamed."""
    base = tmp_path_factory.mktemp("router")
    tree = make_tree(base / "tree")
    make_ephemeral(base / "eph")
    pair = scanned_pair(base, tree)
    pair.tree = tree
    for name, color in (("red", "#f00"), ("blue", "#00f")):
        pair.same("tags.create", {"name": name, "color": color}, scoped=True)
    ids = pair.object_ids(["big_a", "pic", "note2"])
    pair.same("tags.assign", scoped=True,
              args=[{"tag_id": 1, "object_ids": i[:2]} for i in ids])
    pair.same("tags.assign", scoped=True,
              args=[{"tag_id": 2, "object_ids": i[2:] + [999_999]} for i in ids])
    pair.same("tags.update", {"id": 2, "name": "navy"}, scoped=True)
    for node, lib in zip((pair.jax, pair.port), pair.libs):
        node.search_engine.refresh_now(node.libraries.get(lib))
    yield pair
    pair.close()


def make_ephemeral(root):
    root.mkdir()
    png(root / "a.png", 7)
    png(root / "b.png", 8, 30, 90)
    (root / "c.txt").write_bytes(b"not indexed" * 10)
    (root / ".dot").write_bytes(b"hidden")
    (root / "dir").mkdir()


#: read-only calls over the scanned pair: (key, arg, library-scoped)
QUERIES = [
    ("buildInfo", None, False),
    ("nodeState", None, False),
    ("libraries.list", None, False),
    ("locations.list", None, True),
    ("locations.get", 1, True),
    ("locations.get", 7, True),
    ("locations.getWithRules", 1, True),
    ("locations.indexer_rules.list", None, True),
    ("locations.indexer_rules.get", 2, True),
    ("locations.indexer_rules.listForLocation", 1, True),
    ("search.paths", {}, True),
    ("search.paths", {"tags": [1]}, True),
    ("search.paths", {"tags": [1, 2], "search": "i", "order_by": "size_in_bytes"}, True),
    ("search.paths", {"search": "note", "take": 2}, True),
    ("search.pathsCount", {"tags": [2]}, True),
    ("search.pathsCount", {"extensions": ["bin"]}, True),
    ("search.objects", {}, True),
    ("search.objects", {"take": 3}, True),
    ("search.objects", {"take": 3, "cursor": 3}, True),
    ("search.objects", {"tags": [1], "kinds": [5, 7, 0]}, True),
    ("search.objects", {"favorite": False}, True),
    ("search.objectsCount", None, True),
    ("search.duplicates", {}, True),
    ("search.duplicates", {"location_id": 1, "take": 1}, True),
    ("search.chunkDuplicates", {}, True),
    ("search.chunkDuplicates", {"take": 1}, True),
    ("search.nearDuplicates", {}, True),
    ("tags.list", None, True),
    ("tags.get", 2, True),
    ("tags.get", 9, True),
    ("tags.getWithObjects", 1, True),
    ("jobs.isActive", None, False),
    ("notifications.get", None, False),
    ("unknown.procedure", None, False),
    ("files.get", {"object_id": 1}, True),
    ("files.get", {"file_path_id": 2}, True),
    ("files.get", {"file_path_id": 999}, True),
    ("files.getPath", 3, True),
    ("files.getMediaData", 999, True),
    ("nodes.listLocations", None, True),
    ("preferences.get", None, True),
    ("categories.list", None, True),
    ("backups.getAll", None, False),
]


@pytest.mark.parametrize("key,arg,scoped", QUERIES,
                         ids=[f"{k}-{json.dumps(a)}"[:60] for k, a, _ in QUERIES])
def test_query_matches_jax(scanned, key, arg, scoped):
    got = scanned.same(key, arg, scoped)
    if key == "search.paths" and arg.get("tags"):
        assert got["items"], "the tags filter matched nothing: the comparison tests nothing"


def test_tags_of_an_object_match_jax(scanned):
    ids = scanned.object_ids(["big_a", "note2", "note0"])
    for k in range(3):
        got = scanned.same("tags.getForObject", scoped=True, args=[i[k] for i in ids])
        assert [t["name"] for t in got] == [["red"], ["navy"], []][k]


def test_volumes_match_jax(scanned):
    """Compared without ``available_capacity``: the disk's free bytes move
    between the two calls."""
    want, got = scanned.call("volumes.list")
    for answer in (want, got):
        for volume in answer:
            assert volume.pop("available_capacity") >= 0
    assert got == want and got


def test_statistics_match_jax(scanned):
    want, got = scanned.call("libraries.statistics", scoped=True)
    for answer in (want, got):
        del answer["total_bytes_free"], answer["library_db_size"]
    assert got == want
    assert got["total_object_count"] > 0 and int(got["total_unique_bytes"]) > 0


def test_job_reports_match_jax(scanned):
    want, got = scanned.call("jobs.reports", scoped=True)

    def cut(reports):
        return [{k: v for k, v in r.items() if k != "metadata"} | (
            {"children": cut(r["children"])} if "children" in r else {}) for r in reports]

    assert cut(got) == cut(want)
    assert [c["name"] for c in got[0]["children"]] == [
        "dedup_detector", "media_processor", "file_identifier"]


def test_ephemeral_paths_with_thumbnails_match_jax(scanned):
    eph = scanned.base / "eph"
    for arg in ({"path": str(eph)}, {"path": str(eph), "include_hidden": True},
                {"path": str(eph), "with_cas_ids": True},
                {"path": str(eph), "with_thumbnails": True}):
        got = scanned.same("search.ephemeralPaths", arg)
    thumbs = {e["name"]: e.get("has_thumbnail") for e in got["entries"]}
    assert thumbs == {"a": True, "b": True, "c": None, "dir": None} and not got["errors"]
    # the shield: registered (and persisted) before the thumbnails were
    # made, so a full sweep keeps these thumbnails no library references
    remover = scanned.port.thumbnail_remover
    cas = [e["cas_id"] for e in got["entries"] if e.get("has_thumbnail")]
    registry = json.loads((scanned.port.data_dir / "thumbnails" / "ephemeral.json").read_text())
    assert set(cas) <= set(registry)
    remover.full_sweep()
    from spacedrive_tpu_torch.objects.media.thumbnail import thumbnail_path

    assert all(thumbnail_path(scanned.port.data_dir, c).exists() for c in cas)
    with pytest.raises(NotADirectoryError):
        scanned.port.router.resolve("search.ephemeralPaths", {"path": str(eph / "c.txt")})


def test_schema_matches_the_jax_routers(scanned):
    """(key, kind, scope) of every procedure, against a JAX router with
    the same sub-routers mounted."""
    ref = jax_router.Router(scanned.jax)
    for module in (jax_root, jax_libraries, jax_locations, jax_search, jax_files, jax_jobs,
                   jax_tags, jax_volumes, jax_nodes, jax_notifications, jax_preferences,
                   jax_backups, jax_categories, jax_sync_router, jax_p2p, jax_keys,
                   jax_telemetry_router):
        module.mount(ref)

    def procs(router):
        return sorted((p["key"], p["kind"], p["scope"]) for p in router.schema()["procedures"])

    assert procs(scanned.port.router) == procs(ref)
    pools = {k for k, p in scanned.port.router.procedures.items() if p.pool}
    assert pools == {k for k, p in ref.procedures.items() if p.pool}


def test_subscriptions_deliver_what_jax_delivers(scanned):
    """invalidation.listen, jobs.progress, notifications.listen and
    jobs.newThumbnail on both nodes, through the same calls."""
    subs = {}
    for i, node in enumerate((scanned.jax, scanned.port)):
        lib = scanned.libs[i]
        subs[i] = {key: node.router.subscribe(key, None, lib if scoped else None)
                   for key, scoped in (("invalidation.listen", False), ("jobs.progress", True),
                                       ("notifications.listen", False),
                                       ("jobs.newThumbnail", True))}
    scanned.same("tags.create", {"name": "green"}, scoped=True)
    scanned.same("notifications.test")
    scanned.same("jobs.identifyUniqueFiles", {"location_id": 1}, scoped=True)
    scanned.wait()
    scanned.same("tags.delete", 3, scoped=True)

    def drain(sub):
        out = []
        while (ev := sub.get(timeout=0.2)) is not None:
            if sub.filter(ev):
                out.append(ev)
        sub.close()
        return out

    got = {i: {k: drain(s) for k, s in subs[i].items()} for i in subs}
    for i in got:
        kinds = {ev.kind for events in got[i].values() for ev in events}
        assert kinds == {"invalidate_query", "job_progress", "notification"}
    for key in ("invalidation.listen", "notifications.listen"):
        want, port = ([norm(ev.payload, "") for ev in got[i][key]] for i in (0, 1))
        assert port == want, (key, port, want)
    ends = [{(ev.payload["name"], ev.payload["status"]) for ev in got[i]["jobs.progress"]}
            for i in (0, 1)]
    assert ends[1] == ends[0] and ("file_identifier", JobStatus.COMPLETED) in ends[1]
    assert got[1]["jobs.newThumbnail"] == got[0]["jobs.newThumbnail"] == []


def test_subscriptions_refuse_like_jax(scanned):
    for key, scoped in (("jobs.progress", False), ("search.paths", True),
                        ("no.such", False)):
        errors = []
        for i, node in enumerate((scanned.jax, scanned.port)):
            with pytest.raises(Exception) as info:
                node.router.subscribe(key, None, scanned.libs[i] if scoped else None)
            errors.append((type(info.value).__name__, str(info.value)))
        assert errors[1] == errors[0]
    with pytest.raises(ApiError, match="is a subscription"):
        scanned.port.router.resolve("jobs.progress", None, scanned.libs[1])


# -- mutations, each scenario on its own pair ---------------------------------


def reset_telemetry() -> None:
    """Zero both packages' registries before nodes boot: each node's alert
    rules read its package's process-wide registry, which earlier tests
    fill (a corrupt boot's counter fires an alert into the node
    notifications). Both nodes then run their default rules from the same
    empty state, and an alert notification compares like the rest."""
    jax_telemetry.reset()
    port_telemetry.reset()


@pytest.fixture()
def pair(env, tmp_path):
    reset_telemetry()
    tree = make_tree(tmp_path / "tree")
    pair = scanned_pair(tmp_path, tree)
    pair.tree = tree
    yield pair
    pair.close()


def test_location_mutations_match_jax(pair):
    pair.same("locations.update", {"id": 1, "name": "renamed", "hidden": True,
                                   "indexer_rules": ["No OS protected"]}, scoped=True)
    pair.same("locations.getWithRules", 1, scoped=True)
    pair.same("locations.update", {"id": 5}, scoped=True)
    # a quick rescan of the root: one file added, one changed, one removed
    (pair.tree / "added.txt").write_bytes(b"new file")
    (pair.tree / "note1.txt").write_bytes(blob(99, 900))
    (pair.tree / "note3.txt").unlink()
    pair.same("locations.quickRescan", {"location_id": 1}, scoped=True)
    pair.same("search.paths", {"include_hidden": True}, scoped=True)
    pair.same("locations.subPathRescan", {"location_id": 1, "sub_path": "sub"}, scoped=True)
    pair.wait()
    pair.same("locations.fullRescan", {"location_id": 1}, scoped=True)
    pair.wait()
    pair.same("search.paths", {"include_hidden": True}, scoped=True)
    pair.same("search.objects", {}, scoped=True)
    # the sidecar names the location; the reference's relink then indexes
    # the location id as a mapping and raises, and so does the port's
    assert pair.same("locations.relink", str(pair.tree), scoped=True) == ("raised", "TypeError")
    assert pair.same("locations.relink", str(pair.tree / "sub"), scoped=True) \
        == ("raised", "ApiError")
    pair.same("locations.create", {"path": str(pair.tree / "sub")}, scoped=True)
    pair.same("locations.create", {"path": str(pair.tree / "nope")}, scoped=True)
    pair.same("locations.delete", 1, scoped=True)
    pair.same("locations.list", scoped=True)
    pair.same("search.pathsCount", {}, scoped=True)
    assert not (pair.tree / ".spacedrive").exists()
    pair.same("locations.delete", 1, scoped=True)


def test_a_second_library_adds_the_location_like_jax(pair):
    lib2 = [node.router.resolve("libraries.create", {"name": "two", "description": "d"})["id"]
            for node in (pair.jax, pair.port)]
    pair.libs, first = tuple(lib2), pair.libs
    pair.same("locations.create", {"path": str(pair.tree), "dry_run": True}, scoped=True)
    pair.same("locations.addLibrary", {"path": str(pair.tree), "name": "again"}, scoped=True)
    pair.wait()
    pair.same("locations.list", scoped=True)
    pair.same("search.paths", {}, scoped=True)
    sidecar = json.loads((pair.tree / ".spacedrive").read_text())
    assert len(sidecar["libraries"]) == 4  # both libraries of both nodes
    pair.same("libraries.list")
    pair.same("libraries.edit", args=[
        {"id": lib, "name": "edited", "description": "e"} for lib in lib2])
    pair.same("libraries.list")
    pair.same("libraries.edit", args=[{"id": lib, "name": " "} for lib in lib2])
    pair.same("libraries.delete", args=list(first))
    pair.same("libraries.list")
    assert pair.same("search.paths", {}, scoped=True)["items"]
    assert not list((pair.base / "port" / "libraries").glob(f"{first[1]}*"))


def test_indexer_rule_and_tag_mutations_match_jax(pair):
    rule = {"name": "no logs", "rules": {"1": ["*.log"]}}
    pair.same("locations.indexer_rules.create", rule, scoped=True)
    pair.same("locations.indexer_rules.list", scoped=True)
    pair.same("locations.update", {"id": 1, "indexer_rules": ["no logs", "No Hidden"]},
              scoped=True)
    pair.same("locations.indexer_rules.listForLocation", 1, scoped=True)
    pair.same("locations.indexer_rules.delete", 1, scoped=True)  # a system rule
    pair.same("locations.indexer_rules.delete", 5, scoped=True)
    pair.same("locations.indexer_rules.listForLocation", 1, scoped=True)
    pair.same("tags.create", {"name": "t"}, scoped=True)
    ids = pair.object_ids(["note0", "big_b"])
    pair.same("tags.assign", scoped=True, args=[{"tag_id": 1, "object_ids": i} for i in ids])
    pair.same("tags.assign", scoped=True,
              args=[{"tag_id": 1, "object_ids": i[:1], "unassign": True} for i in ids])
    pair.same("tags.getWithObjects", 1, scoped=True)
    pair.same("tags.assign", {"tag_id": 7, "object_ids": [1]}, scoped=True)
    pair.same("tags.delete", 1, scoped=True)
    pair.same("tags.delete", 1, scoped=True)
    pair.same("tags.list", scoped=True)


def test_job_mutations_match_jax(pair):
    pair.same("jobs.generateThumbsForLocation", {"location_id": 1, "regenerate": True},
              scoped=True)
    pair.same("jobs.objectValidator", {"location_id": 1}, scoped=True)
    pair.wait()
    reports = [node.router.resolve("jobs.reports", None, lib)
               for node, lib in zip((pair.jax, pair.port), pair.libs)]
    assert [[r["name"] for r in rs] for rs in reports[1:]] == [[r["name"] for r in rs]
                                                               for rs in reports[:1]]
    pair.same("jobs.clear", scoped=True, args=[rs[0]["id"] for rs in reports])
    pair.same("jobs.pause", scoped=False, args=[rs[1]["id"] for rs in reports])
    pair.same("jobs.cancel", scoped=False, args=[rs[1]["id"] for rs in reports])
    pair.same("jobs.resume", scoped=True, args=[rs[1]["id"] for rs in reports])
    pair.same("jobs.clearAll", scoped=True)
    assert pair.same("jobs.reports", scoped=True) == []


def test_notifications_match_jax(pair):
    pair.same("notifications.test")
    pair.same("notifications.test")
    pair.same("notifications.testLibrary", scoped=True)
    pair.same("notifications.get")
    pair.same("notifications.dismiss", {"source": "node", "id": 1})
    pair.same("notifications.dismiss", args=[
        {"source": "library", "id": 1, "library_id": lib} for lib in pair.libs])
    assert [n["id"] for n in pair.same("notifications.get")] == [2]
    pair.same("notifications.testLibrary", scoped=True)
    pair.same("notifications.dismissAll")
    assert pair.same("notifications.get") == []


def test_the_cold_resume_failure_notifies_like_jax(env, tmp_path):
    """A checkpoint of a job no registry knows, found at boot, fails loudly:
    the job ends Failed and the library gets a notification."""
    pair = Pair(tmp_path)
    try:
        pair.libs = tuple(node.router.resolve("libraries.create", {"name": "l"})["id"]
                          for node in (pair.jax, pair.port))
        for node, lib, report_cls, status in (
                (pair.jax, pair.libs[0], JaxJobReport, JaxJobStatus.PAUSED),
                (pair.port, pair.libs[1], JobReport, JobStatus.PAUSED)):
            report = report_cls.new("does_not_exist")
            report.status = status
            report.data = b'{"bad": "state"}'
            report.create(node.libraries.get(lib).db)
        pair.close()
        pair.jax = JaxNode(tmp_path / "jax", probe_accelerator=False, watch_locations=False)
        pair.port = Node(tmp_path / "port", device="cpu", watch_locations=False)
        got = pair.same("notifications.get")
        assert [n["data"]["kind"] for n in got] == ["job_cold_resume_failed"]
        assert got[0]["data"]["job_name"] == "does_not_exist"
        assert [r["status"] for r in pair.same("jobs.reports", scoped=True)] \
            == [JobStatus.FAILED]
    finally:
        pair.close()


def test_a_tagged_orphan_object_is_collected(env, tmp_path):
    """The orphan remover deletes an object's tag links with it (the
    tag_on_object foreign key would refuse the object's delete)."""
    tree = make_tree(tmp_path / "tree")
    node = Node(tmp_path / "port", device="cpu", watch_locations=False)
    try:
        lib_id = node.router.resolve("libraries.create", {"name": "l"})["id"]
        node.router.resolve("locations.create", {"path": str(tree)}, lib_id)
        assert node.jobs.wait_idle(120)
        lib = node.libraries.get(lib_id)
        oid = lib.db.query("SELECT object_id FROM file_path WHERE name = 'note4'")[0][0]
        node.router.resolve("tags.create", {"name": "x"}, lib_id)
        node.router.resolve("tags.assign", {"tag_id": 1, "object_ids": [oid]}, lib_id)
        (tree / "note4.txt").unlink()
        node.router.resolve("locations.quickRescan", {"location_id": 1}, lib_id)
        assert lib.orphan_remover.process_clean_up() >= 1
        assert lib.db.query("SELECT COUNT(*) FROM tag_on_object")[0][0] == 0
        assert not lib.db.query("SELECT id FROM object WHERE id = ?", [oid])
    finally:
        node.shutdown()
    shutil.rmtree(tree)


def test_files_media_data_and_metadata_mutations_match_jax(scanned):
    oid = scanned.object_ids(["pic"])
    scanned.same("files.getMediaData", scoped=True, args=[i[0] for i in oid])
    scanned.same("files.getEphemeralMediaData", str(scanned.tree / "pic.png"))
    ids = scanned.object_ids(["note1"])
    for key, arg in (("files.setNote", {"note": "seen"}), ("files.setFavorite", {"favorite": 1}),
                     ("files.updateAccessTime", None), ("files.removeAccessTime", None)):
        scanned.same(key, scoped=True, args=[
            i[0] if arg is None else {"object_id": i[0], **arg} for i in ids])
    got = scanned.same("files.get", scoped=True, args=[{"object_id": i[0]} for i in ids])
    assert got["object"]["note"] == "seen" and got["object"]["favorite"]
    scanned.same("files.setNote", {"object_id": 999_999, "note": "x"}, scoped=True)
    scanned.same("search.objects", {"favorite": True}, scoped=True)


def test_preferences_nodes_and_backups_match_jax(pair):
    pair.same("preferences.update", {"explorer": {"view": "grid", "size": 3}, "theme": "dark"},
              scoped=True)
    pair.same("preferences.update", {"explorer": {"size": None}}, scoped=True)
    assert pair.same("preferences.get", scoped=True) == {"explorer": {"view": "grid"},
                                                        "theme": "dark"}
    pair.same("preferences.update", {"a.b": 1}, scoped=True)
    pair.same("nodes.edit", {"name": "renamed-node"})
    assert pair.same("nodeState")["name"] == "renamed-node"
    pair.same("backups.backup", args=list(pair.libs))
    listed = [node.router.resolve("backups.getAll") for node in (pair.jax, pair.port)]
    for node, got in zip((pair.jax, pair.port), listed):
        (entry,) = got["backups"]
        assert entry.pop("timestamp") > 0
        assert entry.pop("path").startswith(str(node.data_dir / "backups"))
    assert norm(listed[1], str(pair.port.data_dir)) == norm(listed[0], str(pair.jax.data_dir))
    paths = [got["backups"][0]["id"] for got in listed]
    pair.same("backups.restore", args=[str(n.data_dir / "backups" / f"{b}.bkp")
                                       for n, b in zip((pair.jax, pair.port), paths)])
    pair.same("search.paths", {}, scoped=True)
    pair.same("backups.restore", str(pair.base / "missing.bkp"))
    pair.same("backups.delete", args=paths)
    assert pair.same("backups.getAll")["backups"] == []


@pytest.fixture()
def fs_pair(env, tmp_path):
    """Each node scans its own copy of the tree."""
    pair = Pair(tmp_path)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    pair.trees = (make_tree(tmp_path / "a" / "tree"), make_tree(tmp_path / "b" / "tree"))
    pair.libs = tuple(node.router.resolve("libraries.create", {"name": "lib"})["id"]
                      for node in (pair.jax, pair.port))
    fs_same(pair, "locations.create", {"path": "<tree>"})
    pair.wait()
    yield pair
    pair.close()


def fs_same(pair, key, arg=None, scoped=True):
    """``pair.same`` with each node's tree root replaced by ``<tree>`` and
    ``inode`` dropped (the copies' files are different inodes)."""
    want, got = pair.call(key, scoped=scoped, args=[
        json.loads(json.dumps(arg).replace("<tree>", str(t))) for t in pair.trees])
    want, got = (json.loads(json.dumps(a).replace(str(t), "<tree>"))
                 for a, t in zip((want, got), pair.trees))
    want, got = (json.loads(json.dumps(a), object_hook=lambda d: {
        k: v for k, v in d.items() if k != "inode"}) for a in (want, got))
    assert got == want, f"{key} {arg}"
    return got


def test_files_mutations_and_fs_jobs_match_jax(fs_pair):
    pair = fs_pair
    fid = {name: pair.port.libraries.get(pair.libs[1]).db.query(
        "SELECT id FROM file_path WHERE name = ?", [name])[0]["id"]
        for name in ("note0", "note1", "note2", "sub", "big_a", "near", "deep")}
    fs_same(pair, "files.renameFile", {"file_path_id": fid["note0"], "new_name": "Renamed.MD"})
    fs_same(pair, "files.renameFile", {"file_path_id": fid["sub"], "new_name": "sub2"})
    fs_same(pair, "files.getPath", fid["deep"])
    fs_same(pair, "files.renameFile", {"file_path_id": fid["note1"], "new_name": "note2.txt"})
    fs_same(pair, "files.renameFile", {"file_path_id": fid["note1"], "new_name": "a/b"})
    for _ in range(2):
        fs_same(pair, "files.createDirectory", {"location_id": 1, "sub_path": "sub2"})
    fs_same(pair, "files.createFile", {"location_id": 1, "name": "new.txt"})
    fs_same(pair, "files.createFile", {"location_id": 1, "name": "new.txt"})
    fs_same(pair, "files.copyFiles", {"sources": [fid["big_a"], fid["sub"]],
                                      "target_location_id": 1, "target_dir": ""})
    pair.wait()
    fs_same(pair, "files.duplicateFiles", {"sources": [fid["note2"], fid["deep"]]})
    pair.wait()
    fs_same(pair, "files.cutFiles", {"sources": [fid["near"]], "target_location_id": 1,
                                     "target_dir": "sub2/New Folder"})
    pair.wait()
    fs_same(pair, "search.paths", {"include_hidden": True, "take": 100})
    fs_same(pair, "files.deleteFiles", {"sources": [fid["note2"]]})
    fs_same(pair, "files.eraseFiles", {"sources": [fid["big_a"]], "passes": 1})
    pair.wait()
    got = fs_same(pair, "search.paths", {"include_hidden": True, "take": 100})
    names = {(i["materialized_path"], i["name"]) for i in got["items"]}
    assert ("/", "Renamed") in names and ("/sub2/", "New Folder (2)") in names
    assert ("/", "big_a (2)") in names and ("/", "sub2 (2)") in names
    assert ("/", "note2") not in names and ("/", "big_a") not in names
    assert not (pair.trees[1] / "big_a.bin").exists()
    # the fs jobs' reports, each metadata without the reference's telemetry
    # trace (the scan's reports are compared in test_job_reports_match_jax)
    want, got = ([r for r in rs if r["name"].startswith("file_")]
                 for rs in pair.call("jobs.reports", scoped=True))
    reports = [r for rs in (want, got) for r in rs]
    while reports:
        r = reports.pop()
        r["metadata"].pop("trace", None)
        reports += r.get("children", [])
    assert got == want and {r["name"] for r in got} == {
        "file_copier", "file_cutter", "file_deleter", "file_eraser"}


def emitted(pair, roots=(), drop=()):
    """Each node's op log (``op_log``), pub_ids keyed by the rows as they
    stand and as ``before`` saw them."""
    out = []
    for i, node in enumerate((pair.jax, pair.port)):
        db = node.libraries.get(pair.libs[i]).db
        keys = {**pub_keys(db), **pair.keys[i]}
        out.append(op_log(db, keys, roots=roots[i:i + 1] if roots else (), drop=drop))
    return out


def start_emitting(pair) -> None:
    """``toggleFeatureFlag`` on both nodes; the rows' keys as they are."""
    assert pair.same("toggleFeatureFlag", "syncEmitMessages") is True
    pair.keys = [pub_keys(node.libraries.get(lib).db)
                 for node, lib in zip((pair.jax, pair.port), pair.libs)]


def test_tag_note_favorite_and_preference_ops_match_jax(pair):
    start_emitting(pair)
    pair.same("tags.create", {"name": "red", "color": "#f00"}, scoped=True)
    pair.same("tags.create", {"name": "blue"}, scoped=True)
    ids = pair.object_ids(["big_a", "pic", "note2"])
    pair.same("tags.assign", scoped=True, args=[{"tag_id": 1, "object_ids": i} for i in ids])
    pair.same("tags.assign", scoped=True,
              args=[{"tag_id": 1, "object_ids": i[2:], "unassign": True} for i in ids])
    pair.same("tags.update", {"id": 2, "name": "navy", "color": "#00f"}, scoped=True)
    pair.same("files.setNote", scoped=True, args=[{"object_id": i[0], "note": "n"} for i in ids])
    pair.same("files.setFavorite", scoped=True,
              args=[{"object_id": i[1], "favorite": True} for i in ids])
    pair.same("preferences.update", {"explorer": {"view": "grid", "size": 3}}, scoped=True)
    pair.same("preferences.update", {"explorer": {"size": None}}, scoped=True)
    pair.same("tags.delete", 2, scoped=True)
    # the port's tag creates carry date_modified, the reference's do not
    want, got = emitted(pair, drop=("date_modified",))
    assert got == want and sum(want.values()) == 15
    # the op log feed, without the HLC stamps (and the port's date_modified)
    feeds = pair.call("sync.messages", {"count": 5}, scoped=True)
    for answer in feeds:
        for op in answer["ops"]:
            assert op.pop("timestamp") > 0
            if isinstance(op["typ"]["data"], dict):
                op["typ"]["data"].pop("date_modified", None)
    assert feeds[1] == feeds[0] and len(feeds[1]["ops"]) == 5 and feeds[1]["has_more"] is True
    pair.same("sync.fleetStatus")
    assert pair.same("toggleFeatureFlag", "syncEmitMessages") is False
    pair.same("tags.create", {"name": "unlogged"}, scoped=True)
    assert emitted(pair, drop=("date_modified",)) == [want, got]
    pair.same("toggleFeatureFlag", "noSuchFlag")


def test_rename_ops_match_jax(fs_pair):
    pair = fs_pair
    start_emitting(pair)
    fid = {name: pair.port.libraries.get(pair.libs[1]).db.query(
        "SELECT id FROM file_path WHERE name = ?", [name])[0]["id"]
        for name in ("note0", "sub")}
    fs_same(pair, "files.renameFile", {"file_path_id": fid["note0"], "new_name": "Renamed.MD"})
    fs_same(pair, "files.renameFile", {"file_path_id": fid["sub"], "new_name": "sub2"})
    want, got = emitted(pair, roots=pair.trees, drop=("inode",))
    assert got == want and sum(want.values()) == 5
