"""The boot-time temp sweep and the GC actors of the port
(``spacedrive_tpu_torch/atomic.py`` ``cleanup_stale_tmp``, ``library.py``,
``objects/gc.py``) against the JAX package's, on the CPU: ports of
``tests/test_gc.py`` :35-160, with the sweep and the collectors run on the
same trees and the same planted rows by both packages where they share the
behaviour.
"""

import time
import uuid
from pathlib import Path

import pytest

from spacedrive_tpu.locations import create_location as jax_create_location
from spacedrive_tpu.locations import scan_location as jax_scan_location
from spacedrive_tpu.models import Object as JaxObject
from spacedrive_tpu.node import Node as JaxNode
from spacedrive_tpu.objects.media.thumbnail import thumbnail_path as jax_thumbnail_path
from spacedrive_tpu.utils.atomic import cleanup_stale_tmp as jax_cleanup_stale_tmp
from spacedrive_tpu_torch.atomic import TMP_MARK, atomic_write_bytes, cleanup_stale_tmp
from spacedrive_tpu_torch.locations import create_location, scan_location
from spacedrive_tpu_torch.models import ChunkManifest, MediaData, Object
from spacedrive_tpu_torch.node import Node
from spacedrive_tpu_torch.objects.gc import OrphanRemoverActor, ThumbnailRemoverActor
from spacedrive_tpu_torch.objects.media.thumbnail import thumbnail_dir, thumbnail_path
from tests.torch_scan_cases import one_torch_thread  # noqa: F401

#: (relative path, is a directory) of the debris and of what must stay
DEBRIS = [("a.db.sd-tmp.1a2b3c4d", False), ("ab/cafe.webp.sd-tmp.00ff00ff", False),
          ("cd/x.sd-tmp.dir", True), ("keep.db", False), ("ab/cafe.webp", False),
          ("ab/deep/y.webp.sd-tmp.12345678", False), ("sd-tmp-lookalike.txt", False)]


def plant(root: Path) -> None:
    for rel, is_dir in DEBRIS:
        path = root / rel
        if is_dir:
            path.mkdir(parents=True)
            (path / "inner").write_bytes(b"x")
        else:
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_bytes(b"x")


def left(root: Path) -> list:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*"))


def test_cleanup_stale_tmp_sweeps_a_directory_and_one_level_below_as_jax_does(tmp_path):
    plant(tmp_path / "port")
    plant(tmp_path / "jax")
    removed = cleanup_stale_tmp(tmp_path / "port")
    assert removed == jax_cleanup_stale_tmp(tmp_path / "jax") == 3
    assert left(tmp_path / "port") == left(tmp_path / "jax")
    assert "ab/deep/y.webp.sd-tmp.12345678" in left(tmp_path / "port")  # two levels down
    assert "keep.db" in left(tmp_path / "port") and "ab/cafe.webp" in left(tmp_path / "port")
    assert cleanup_stale_tmp(tmp_path / "missing") == 0


def test_boot_sweeps_the_debris_of_a_killed_write(tmp_path):
    data = tmp_path / "data"
    Node(data, device="cpu", watch_locations=False).shutdown()
    stale = [data / "libraries" / "x.sdlibrary.sd-tmp.0badf00d",
             data / "thumbnails" / "ab" / "abcd.webp.sd-tmp.deadbeef",
             data / "backups" / "b.tar.sd-tmp.11111111"]
    for path in stale:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(b"half written")
    atomic_write_bytes(data / "thumbnails" / "ab" / "abcd.webp", b"whole")
    node = Node(data, device="cpu", watch_locations=False)
    try:
        assert not any(p.exists() for p in stale)
        assert (data / "thumbnails" / "ab" / "abcd.webp").read_bytes() == b"whole"
        assert not list(data.rglob(f"*{TMP_MARK}*"))
    finally:
        node.shutdown()


def write_tree(root: Path) -> Path:
    root.mkdir()
    (root / "keep.txt").write_text("keep me around")
    (root / "other.txt").write_text("another file")
    return root


@pytest.fixture()
def nodes(tmp_path, monkeypatch):
    """A port Node and a JAX Node, each with one scanned library of the same
    two-file tree."""
    monkeypatch.setenv("SD_P2P_DISABLED", "1")
    tree = write_tree(tmp_path / "tree")
    out = {}
    for pkg, make, create, scan in (
            ("port", lambda d: Node(d, device="cpu", watch_locations=False), create_location,
             scan_location),
            ("jax", lambda d: JaxNode(d, probe_accelerator=False, watch_locations=False),
             lambda lib, t: jax_create_location(lib, t, hasher="cpu"), jax_scan_location)):
        node = make(tmp_path / pkg)
        lib = node.libraries.create("gc")
        scan(lib, create(lib, tree)["id"])
        assert node.jobs.wait_idle(60)
        out[pkg] = (node, lib)
    yield out
    for node, _lib in out.values():
        node.shutdown()


def test_orphan_remover_collects_only_orphans(nodes):
    counts = {}
    for pkg, (_node, lib) in nodes.items():
        db = lib.db
        live = db.query("SELECT object_id FROM file_path WHERE name = 'keep'")[0]["object_id"]
        model = Object if pkg == "port" else JaxObject
        orphans = [db.insert(model, {"pub_id": str(uuid.uuid4()), "kind": 0}) for _ in range(3)]
        if pkg == "port":
            db.insert(MediaData, {"object_id": orphans[0], "dimensions": {"width": 1}})
            db.insert(MediaData, {"object_id": live, "dimensions": {"width": 2}})
            db.insert(ChunkManifest, {"object_id": orphans[1], "seq": 0,
                                      "chunk_hash": "00" * 16, "length": 5})
        removed = lib.orphan_remover.process_clean_up()
        remaining = {r["id"] for r in db.query("SELECT id FROM object")}
        assert live in remaining and not set(orphans) & remaining
        counts[pkg] = (removed, len(remaining), lib.orphan_remover.process_clean_up())
    assert counts["port"] == counts["jax"] == (3, 2, 0)
    db = nodes["port"][1].db
    assert [r["object_id"] for r in db.query("SELECT object_id FROM media_data")] == [
        db.query("SELECT object_id FROM file_path WHERE name = 'keep'")[0]["object_id"]]
    assert db.query("SELECT COUNT(*) AS n FROM chunk_manifest")[0]["n"] == 0


def test_orphan_remover_ticks_on_invoke(nodes):
    _node, lib = nodes["port"]
    db = lib.db
    # a fast-ticking actor, so the invoke lands at once
    lib.orphan_remover.stop()
    lib.orphan_remover = OrphanRemoverActor(lib, tick_interval=0.2, debounce=0.0)
    fp = db.query("SELECT id, object_id FROM file_path WHERE name = 'keep'")[0]
    db.execute("DELETE FROM file_path WHERE id = ?", [fp["id"]])
    lib.orphan_remover.invoke()
    deadline = time.monotonic() + 10
    while db.query("SELECT 1 FROM object WHERE id = ?", [fp["object_id"]]):
        assert time.monotonic() < deadline, "the orphaned object survived the invoked GC"
        time.sleep(0.05)


def test_thumbnail_remover_full_sweep_matches_jax(nodes):
    removed = {}
    for pkg, (node, lib) in nodes.items():
        path_of = thumbnail_path if pkg == "port" else jax_thumbnail_path
        live = lib.db.query("SELECT cas_id FROM file_path WHERE cas_id IS NOT NULL "
                            "ORDER BY cas_id")[0]["cas_id"]
        for cas in (live, "deadbeef00000000", "deadbeef11111111"):
            p = path_of(node.data_dir, cas)
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_bytes(b"RIFFfakeWEBP")
        removed[pkg] = (node.thumbnail_remover.full_sweep(),
                        sorted(p.stem for p in Path(node.data_dir).glob("thumbnails/*/*.webp")),
                        node.thumbnail_remover.full_sweep())
        assert removed[pkg][1] == [live]
    assert removed["port"] == removed["jax"]
    assert removed["port"][0] == 2 and removed["port"][2] == 0
    node = nodes["port"][0]
    assert not (thumbnail_dir(node.data_dir) / "de").exists()  # the emptied shard is gone


def test_thumbnail_remover_marked_deletion_skips_the_liveness_check(nodes):
    node, lib = nodes["port"]
    live = lib.db.query("SELECT cas_id FROM file_path WHERE cas_id IS NOT NULL")[0]["cas_id"]
    p = thumbnail_path(node.data_dir, live)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_bytes(b"RIFFfakeWEBP")
    # the actor's thread races the explicit call: either may take the set
    node.thumbnail_remover.mark_for_deletion([live])
    node.thumbnail_remover.process_marked()
    deadline = time.monotonic() + 5
    while p.exists():
        assert time.monotonic() < deadline
        time.sleep(0.05)


def test_ephemeral_hook_shields_a_thumbnail_until_its_ttl_lapses(tmp_path):
    node = Node(tmp_path / "data", device="cpu", watch_locations=False)
    try:
        remover = node.thumbnail_remover
        p = thumbnail_path(node.data_dir, "feedface00000000")
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(b"RIFFfakeWEBP")
        remover.register_ephemeral(["feedface00000000"])
        assert remover.full_sweep() == 0 and p.exists()
        remover._ephemeral["feedface00000000"] = 0.0  # browsed long ago
        assert remover.full_sweep() == 1 and not p.exists()
    finally:
        node.shutdown()


def test_actors_stop_cleanly_and_a_cold_cache_sweeps_nothing(tmp_path):
    node = Node(tmp_path / "data", device="cpu", watch_locations=False)
    lib = node.libraries.create("stop")
    try:
        assert node.thumbnail_remover.full_sweep() == 0
        assert node.thumbnail_remover.process_marked() == 0
        assert thumbnail_dir(node.data_dir).is_dir()
        remover = ThumbnailRemoverActor(node, batch_interval=0.05, full_interval=0.0)
        remover.stop()
        assert not remover._thread.is_alive()
    finally:
        node.shutdown()
    assert not lib.orphan_remover._thread.is_alive()
    assert not node.thumbnail_remover._thread.is_alive()
