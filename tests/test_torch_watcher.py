"""The port's location watcher (spacedrive_tpu_torch/locations/watcher.py)
against the JAX package's, on the CPU.

- Event scripts through both ``EventHandler``s on one patched clock (no
  sleeps): files created (one a copy of an indexed file), a directory
  created with a subtree, a file appended to, a modify then a delete before
  the debounce ends, a file renamed, a directory renamed with its
  descendants, a directory moved in from outside, a dangling ``moved_from``
  evicted to a remove after 1 s, an overflow reconciled by the light
  rescan, and paths the rules reject. Both libraries index the same tree;
  after each script the rows (path, name, extension, size, cas_id, kind),
  the grouping of files into objects and which changed files were
  identified again equal the reference's, and the ``cas_id``s equal a
  fresh identify's.
- ``LocationWatcher`` on a scripted backend: ``ignore_path`` mutes a
  directory, ``flush`` waits the debounce out, ``stop`` ends the thread.
- The backends: ``InotifyBackend`` and ``PollingBackend`` of both packages
  on the same operations give the same events (read with a bounded wait),
  and ``_make_backend`` falls back to polling when inotify is refused.
- A Node with the watcher on starts one a location, answers
  ``watcher_for`` and stops them at shutdown; ``SD_NO_WATCHER`` gates it.
- With sync emitting (``toggleFeatureFlag``), the event scripts log the
  operations the JAX package's log (``tests/torch_sync_cases.op_log``):
  creates, the indexed subtree, updates, renames, removes and the
  identify passes that follow them.
"""

import json
import os
import shutil
import time
import types

import pytest

from spacedrive_tpu.locations import create_location as jax_create_location
from spacedrive_tpu.locations import watcher as jax_watcher
from spacedrive_tpu.locations.indexer_job import IndexerJob as JaxIndexerJob
from spacedrive_tpu.node import Node as JaxNode
from spacedrive_tpu.objects.file_identifier import FileIdentifierJob as JaxIdentifierJob
from spacedrive_tpu_torch.locations import create_location
from spacedrive_tpu_torch.locations import watcher
from spacedrive_tpu_torch.locations.indexer_job import IndexerJob
from spacedrive_tpu_torch.models import FilePath
from spacedrive_tpu_torch.node import Node
from spacedrive_tpu_torch.objects.cas import generate_cas_id
from spacedrive_tpu_torch.objects.file_identifier import FileIdentifierJob
from tests.torch_scan_cases import blob, rows_of, one_torch_thread  # noqa: F401
from tests.torch_sync_cases import op_log, pub_keys

MODS = {"jax": jax_watcher, "port": watcher}


def make_tree(root):
    """Four directories of small and sampled-size files, a nested one and a
    copy; a root-level file for the overflow script."""
    for d in range(4):
        (root / f"d{d}" / "sub").mkdir(parents=True)
        for i in range(5):
            (root / f"d{d}" / f"f{i}.bin").write_bytes(blob(10 * d + i, 300 + 700 * i))
        (root / f"d{d}" / "sub" / "deep.txt").write_bytes(blob(100 + d, 150_000 if d == 1 else 80))
    (root / "top.txt").write_bytes(b"top" * 30)
    return root


class Clock:
    """``time`` of both watcher modules: ``monotonic`` reads ``now``."""

    def __init__(self) -> None:
        self.now = 1000.0
        self.sleep = time.sleep
        self.perf_counter = time.perf_counter

    def monotonic(self) -> float:
        return self.now


class StubBackend:
    """A backend that records the handler's calls and yields what the test
    queues (for ``LocationWatcher``)."""

    def __init__(self, root) -> None:
        self.root = root
        self.queue: list = []
        self.calls: list = []

    def note_dir_moved(self, a, b) -> None:
        self.calls.append(("moved", a, b))

    def watch_new_dir(self, path) -> None:
        self.calls.append(("watch", path))

    def read(self, timeout):
        out, self.queue = self.queue, []
        if not out:
            time.sleep(min(timeout, 0.02))
        return out

    def close(self) -> None:
        self.calls.append(("close",))


@pytest.fixture()
def pair(tmp_path, monkeypatch):
    """Both nodes (watchers off) indexing and identifying one tree, and an
    EventHandler of each package on its library, on one patched clock."""
    monkeypatch.setenv("SD_P2P_DISABLED", "1")
    tree = make_tree(tmp_path / "tree")
    (tmp_path / "outside").mkdir()
    clock = Clock()
    for mod in MODS.values():
        monkeypatch.setattr(mod, "time", clock)
    jnode = JaxNode(tmp_path / "jax", probe_accelerator=False, watch_locations=False)
    pnode = Node(tmp_path / "port", device="cpu", watch_locations=False)
    sides = {}
    try:
        for pkg, node, create, jobs in (
                ("jax", jnode, jax_create_location, (JaxIndexerJob, JaxIdentifierJob)),
                ("port", pnode, create_location, (IndexerJob, FileIdentifierJob))):
            lib = node.libraries.create(pkg)
            loc = create(lib, tree)
            node.jobs.spawn(lib, [job({"location_id": loc["id"]}) for job in jobs])
            assert node.jobs.wait_idle(120)
            mod = MODS[pkg]
            rules = mod.CompiledRules(mod.rules_for_location(lib.db, loc["id"]))
            backend = StubBackend(str(tree))
            handler = mod.EventHandler(lib, loc, rules, backend)
            sides[pkg] = types.SimpleNamespace(node=node, lib=lib, loc=loc, handler=handler,
                                               backend=backend)
        yield types.SimpleNamespace(tree=tree, outside=tmp_path / "outside", clock=clock,
                                    sides=sides)
    finally:
        jnode.shutdown()
        pnode.shutdown()


def run(pair, script):
    """Feed ``script`` (a list of (dt, [(kind, rel, is_dir, cookie)]) items:
    advance the clock by dt, hand the events to both handlers, tick both)."""
    for dt, events in script:
        pair.clock.now += dt
        for pkg, side in pair.sides.items():
            mod = MODS[pkg]
            for kind, rel, is_dir, cookie in events:
                path = rel if os.path.isabs(rel) else str(pair.tree / rel)
                side.handler.handle(mod.RawEvent(kind, path, is_dir, cookie))
            side.handler.tick()


def settle(pair, seconds=1.2):
    """Past the debounce and the dangling-rename window: every buffer
    flushes and the identify pass runs."""
    run(pair, [(seconds, []), (0.0, [])])


def assert_same(pair, label):
    got = {pkg: rows_of(s.lib.db) for pkg, s in pair.sides.items()}
    assert got["port"] == got["jax"], label
    for side in pair.sides.values():
        h = side.handler
        assert not (h.files_to_update or h.rename_from or h.need_identify), label
    return got["port"]


def cas_of(rows, mp, name):
    return next(r[4] for r in rows[0] if r[0] == mp and r[1] == name)


def test_event_scripts_match_jax(pair):
    tree = pair.tree
    # 1. files created, one a copy of an indexed file; a directory with a
    # subtree created at once (its one event is the directory's)
    (tree / "d0" / "new1.txt").write_bytes(blob(500, 200))
    shutil.copy(tree / "d1" / "f3.bin", tree / "d0" / "copy_of_f3.bin")
    (tree / "fresh" / "inner").mkdir(parents=True)
    for i in range(3):
        (tree / "fresh" / f"n{i}.dat").write_bytes(blob(600 + i, 900 + i))
    (tree / "fresh" / "inner" / "x.txt").write_bytes(blob(700, 50))
    run(pair, [(0.0, [("create", "d0/new1.txt", False, 0), ("modify", "d0/new1.txt", False, 0),
                      ("create", "d0/copy_of_f3.bin", False, 0)]),
               (0.05, []),  # inside the debounce: nothing applied yet
               (0.0, [("create", "fresh", True, 0)])])
    assert ("watch", str(tree / "fresh")) in pair.sides["port"].backend.calls
    settle(pair)
    rows = assert_same(pair, "create")
    assert cas_of(rows, "/d0/", "copy_of_f3") == cas_of(rows, "/d1/", "f3")
    assert cas_of(rows, "/fresh/inner/", "x") == generate_cas_id(tree / "fresh/inner/x.txt")

    # 2. an append (the size changes), and a modify undone by a delete
    # before the debounce ends
    with open(tree / "d1" / "sub" / "deep.txt", "ab") as fh:
        fh.write(blob(800, 4000))
    old = cas_of(rows, "/d1/sub/", "deep")
    (tree / "d2" / "f0.bin").unlink()
    run(pair, [(0.0, [("modify", "d1/sub/deep.txt", False, 0),
                      ("modify", "d2/f0.bin", False, 0)]),
               (0.02, [("delete", "d2/f0.bin", False, 0)])])
    settle(pair)
    rows = assert_same(pair, "modify")
    assert cas_of(rows, "/d1/sub/", "deep") not in (None, old)
    assert not any(r[0] == "/d2/" and r[1] == "f0" for r in rows[0])

    # 3. a file renamed (another extension), 4. a directory renamed with
    # its descendants
    os.rename(tree / "d0" / "f1.bin", tree / "d0" / "renamed.dat")
    os.rename(tree / "d2", tree / "d2_moved")
    run(pair, [(0.0, [("moved_from", "d0/f1.bin", False, 7),
                      ("moved_to", "d0/renamed.dat", False, 7),
                      ("moved_from", "d2", True, 8), ("moved_to", "d2_moved", True, 8)])])
    assert ("moved", str(tree / "d2"), str(tree / "d2_moved")) in \
        pair.sides["port"].backend.calls
    settle(pair)
    rows = assert_same(pair, "rename")
    assert any(r[0] == "/d2_moved/sub/" and r[1] == "deep" for r in rows[0])
    assert not any(r[0].startswith("/d2/") for r in rows[0])

    # 5. a directory moved in from outside (no moved_from), 6. one moved
    # out (a moved_from whose pair never comes)
    (pair.outside / "import").mkdir()
    for i in range(4):
        (pair.outside / "import" / f"img{i}.raw").write_bytes(blob(900 + i, 2000 * (i + 1)))
    os.rename(pair.outside / "import", tree / "imported")
    os.rename(tree / "d3", pair.outside / "d3")
    run(pair, [(0.0, [("moved_to", "imported", True, 11), ("moved_from", "d3", True, 12)]),
               (0.5, [])])
    assert any(r[0] == "/d3/" for r in rows_of(pair.sides["port"].lib.db)[0])  # not yet
    settle(pair)
    rows = assert_same(pair, "moved in and out")
    assert not any(r[0].startswith("/d3/") or (r[0] == "/" and r[1] == "d3") for r in rows[0])
    assert cas_of(rows, "/imported/", "img2") == generate_cas_id(tree / "imported/img2.raw")

    # 7. an overflow: the kernel dropped events, a light rescan of the
    # root reconciles what it can see
    (tree / "after_overflow.txt").write_bytes(b"x" * 70)
    (tree / "top.txt").unlink()
    run(pair, [(0.0, [("overflow", str(tree), False, 0)])])
    settle(pair)
    rows = assert_same(pair, "overflow")
    assert any(r[1] == "after_overflow" for r in rows[0])
    assert not any(r[0] == "/" and r[1] == "top" for r in rows[0])

    # 8. paths the rules reject, the sidecar, and paths outside the location
    (tree / "d0" / ".hidden").write_bytes(b"h")
    (tree / "node_modules").mkdir()
    (tree / "node_modules" / "m.js").write_bytes(b"m")
    (tree / "d1" / ".DS_Store").write_bytes(b"d")
    before = rows_of(pair.sides["port"].lib.db)
    run(pair, [(0.0, [("create", "d0/.hidden", False, 0), ("create", "node_modules", True, 0),
                      ("create", "d1/.DS_Store", False, 0), ("modify", ".spacedrive", False, 0),
                      ("create", str(pair.outside / "elsewhere.txt"), False, 0)])])
    settle(pair)
    assert assert_same(pair, "rules") == before


def test_event_scripts_log_the_ops_jax_logs(pair):
    tree = pair.tree
    keys = {}
    for pkg, side in pair.sides.items():
        assert side.node.router.resolve("toggleFeatureFlag", "syncEmitMessages") is True
        keys[pkg] = pub_keys(side.lib.db)
    (tree / "d0" / "new1.txt").write_bytes(blob(500, 200))
    shutil.copy(tree / "d1" / "f3.bin", tree / "d0" / "copy_of_f3.bin")
    (tree / "fresh" / "inner").mkdir(parents=True)
    (tree / "fresh" / "inner" / "x.txt").write_bytes(blob(700, 50))
    run(pair, [(0.0, [("create", "d0/new1.txt", False, 0),
                      ("create", "d0/copy_of_f3.bin", False, 0),
                      ("create", "fresh", True, 0)])])
    settle(pair)
    with open(tree / "d1" / "sub" / "deep.txt", "ab") as fh:
        fh.write(blob(800, 4000))
    (tree / "d2" / "f0.bin").unlink()
    os.rename(tree / "d0" / "f1.bin", tree / "d0" / "renamed.dat")
    os.rename(tree / "d3", tree / "d3_moved")
    run(pair, [(0.0, [("modify", "d1/sub/deep.txt", False, 0),
                      ("delete", "d2/f0.bin", False, 0),
                      ("moved_from", "d0/f1.bin", False, 7),
                      ("moved_to", "d0/renamed.dat", False, 7),
                      ("moved_from", "d3", True, 8), ("moved_to", "d3_moved", True, 8)])])
    settle(pair)
    assert_same(pair, "scripts with sync on")
    logs = {pkg: op_log(side.lib.db, {**pub_keys(side.lib.db), **keys[pkg]})
            for pkg, side in pair.sides.items()}
    assert logs["port"] == logs["jax"]
    kinds = {json.loads(k)[3] for k in logs["port"]}
    assert {"c", "d", "u:cas_id", "u:object_id", "u:size_in_bytes", "u:name",
            "u:materialized_path"} <= kinds


def test_a_row_the_light_rescan_inserted_is_identified(pair):
    """An fs job's light rescan can insert a file's row (no cas_id, no
    object) before the watcher applies the file's events. The port's
    watcher then identifies it; the reference's leaves it unidentified
    until the next scan (ROADMAP.md, Queue 3): the one place the two
    differ."""
    from spacedrive_tpu.locations import light_scan_location as jax_light_scan
    from spacedrive_tpu_torch.locations import light_scan_location

    shutil.copy(pair.tree / "d1" / "f4.bin", pair.tree / "d0" / "copied.bin")
    (pair.tree / "d0" / "created.txt").write_bytes(b"")
    for (pkg, side), light in zip(pair.sides.items(), (jax_light_scan, light_scan_location)):
        light(side.lib, side.loc["id"], "d0")
    run(pair, [(0.0, [("create", "d0/copied.bin", False, 0),
                      ("create", "d0/created.txt", False, 0)])])
    settle(pair)
    got = {pkg: {(r[1], r[4]) for r in rows_of(s.lib.db)[0] if r[0] == "/d0/"}
           for pkg, s in pair.sides.items()}
    want_cas = generate_cas_id(pair.tree / "d0" / "copied.bin")
    assert ("copied", want_cas) in got["port"] and ("copied", None) in got["jax"]
    objects = {pkg: s.lib.db.query("SELECT object_id FROM file_path WHERE name = 'created'")[0][0]
               for pkg, s in pair.sides.items()}
    assert objects["port"] is not None and objects["jax"] is None
    assert got["port"] - {("copied", want_cas)} == got["jax"] - {("copied", None)}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_location_watcher_ignores_flushes_and_stops(pair, pkg):
    side, mod = pair.sides[pkg], MODS[pkg]
    for m in MODS.values():  # real time for the watcher's thread
        m.time = time
    tree = pair.tree
    stub = StubBackend(str(tree))
    w = mod.LocationWatcher(side.lib, side.loc["id"], backend_factory=lambda root: stub,
                            poll_interval=0.02)
    try:
        (tree / "d0" / "muted").mkdir()
        (tree / "d0" / "muted" / "a.txt").write_bytes(b"a" * 10)
        (tree / "d0" / "heard.txt").write_bytes(b"b" * 10)
        w.ignore_path(tree / "d0" / "muted", True)
        stub.queue = [mod.RawEvent("create", str(tree / "d0" / "muted"), True),
                      mod.RawEvent("create", str(tree / "d0" / "muted" / "a.txt")),
                      mod.RawEvent("create", str(tree / "d0" / "heard.txt"))]
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and (stub.queue or not side.lib.db.query(
                "SELECT 1 FROM file_path WHERE name = 'heard'")):
            time.sleep(0.02)
        w.flush(10.0)
        # the reference's flush returns once the identify pass has started,
        # not ended: wait for its cas_id (bounded)
        while time.monotonic() < deadline and not side.lib.db.query(
                "SELECT cas_id FROM file_path WHERE name = 'heard'")[0]["cas_id"]:
            time.sleep(0.02)
        names = {r["name"] for r in side.lib.db.query(
            "SELECT name FROM file_path WHERE materialized_path LIKE '/d0/%'")}
        assert "heard" in names and "muted" not in names and "a" not in names
        row = side.lib.db.query("SELECT cas_id FROM file_path WHERE name = 'heard'")[0]
        assert row["cas_id"] == generate_cas_id(tree / "d0" / "heard.txt")
        w.ignore_path(tree / "d0" / "muted", False)
        assert not w._is_ignored(str(tree / "d0" / "muted" / "a.txt"))
    finally:
        w.stop()
    assert stub.calls[-1] == ("close",) and not w._thread.is_alive()


def drain(backend, quiet=0.3, limit=5.0):
    """Every event the backend delivers until it has been quiet ``quiet``
    seconds (at most ``limit``)."""
    out, last, deadline = [], time.monotonic(), time.monotonic() + limit
    while time.monotonic() < deadline:
        got = backend.read(0.05)
        if got:
            out += got
            last = time.monotonic()
        elif out and time.monotonic() - last > quiet:
            break
    return out


def disk_script(root, outside):
    (root / "a.txt").write_bytes(b"one")
    with open(root / "a.txt", "ab") as fh:
        fh.write(b"two")
    (root / "dir").mkdir()
    os.rename(root / "a.txt", root / "dir" / "b.txt")
    os.rename(root / "keep", root / "kept")
    (root / "kept" / "k.txt").unlink()
    os.rename(root / "gone", outside / "gone")


def normalized(events, root):
    """(kind, path relative to ``root``, is_dir, cookie's first position)."""
    first: dict = {}
    out = []
    for e in events:
        if e.cookie:
            first.setdefault(e.cookie, len(first))
        out.append((e.kind, os.path.relpath(e.path, root), e.is_dir,
                    first.get(e.cookie) if e.cookie else None))
    return out


@pytest.mark.parametrize("backend", ["InotifyBackend", "PollingBackend"])
def test_backends_match_jax(tmp_path, backend):
    root, outside = tmp_path / "root", tmp_path / "outside"
    for d in (root / "keep", root / "gone", outside):
        d.mkdir(parents=True)
    (root / "keep" / "k.txt").write_bytes(b"k")
    (root / "gone" / "g.txt").write_bytes(b"g")
    kw = {"interval": 0.05} if backend == "PollingBackend" else {}
    backends = {pkg: getattr(mod, backend)(str(root), **kw) for pkg, mod in MODS.items()}
    try:
        disk_script(root, outside)
        if backend == "PollingBackend":
            time.sleep(0.1)
        got = {pkg: normalized(drain(b), root) for pkg, b in backends.items()}
    finally:
        for b in backends.values():
            b.close()
    assert got["port"] == got["jax"]
    kinds = {k for k, *_ in got["port"]}
    assert {"create", "moved_from", "moved_to", "delete"} <= kinds
    if backend == "InotifyBackend":  # a move out: a moved_from with no moved_to
        gone = [c for k, path, _d, c in got["port"] if k == "moved_from" and path == "gone"]
        assert gone and not [c for k, _p, _d, c in got["port"] if k == "moved_to" and c in gone]


def test_make_backend_falls_back_to_polling(tmp_path, monkeypatch):
    def refuse(root):
        raise OSError(24, "inotify_init1 failed")

    kinds = []
    for mod in MODS.values():
        monkeypatch.setattr(mod, "InotifyBackend", refuse)
        kinds.append(type(mod._make_backend(str(tmp_path))).__name__)
    assert kinds == ["PollingBackend", "PollingBackend"]


def test_a_node_watches_its_locations(tmp_path, monkeypatch):
    tree = tmp_path / "tree"
    tree.mkdir()
    node = Node(tmp_path / "data", device="cpu", watch_locations=True)
    try:
        lib = node.libraries.create("w")
        loc = create_location(lib, tree)
        w = node.locations.watcher_for(lib.id, loc["id"])
        assert type(w.backend).__name__ in ("InotifyBackend", "PollingBackend")
        (tree / "live.txt").write_bytes(blob(3, 500))
        deadline = time.monotonic() + 20
        row = None
        while time.monotonic() < deadline:
            w.flush(5.0)
            row = lib.db.find_one(FilePath, {"name": "live"})
            if row is not None and row["cas_id"]:
                break
            time.sleep(0.05)
        assert row is not None and row["cas_id"] == generate_cas_id(tree / "live.txt")
    finally:
        node.shutdown()
    assert not w._thread.is_alive()
    assert node.locations.watcher_for(lib.id, loc["id"]) is None
    monkeypatch.setenv("SD_NO_WATCHER", "1")
    gated = Node(tmp_path / "data2", device="cpu")
    try:
        lib = gated.libraries.create("g")
        loc = create_location(lib, tree)
        assert not gated.watch_locations
        assert gated.locations.watcher_for(lib.id, loc["id"]) is None
    finally:
        gated.shutdown()
