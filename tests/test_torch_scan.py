"""The port's location scan (spacedrive_tpu_torch) against the JAX package's,
on the same tree, with chunk manifests on.

Both packages index and identify the tree; the rows must agree exactly:
``(materialized_path, name, extension, size, cas_id, kind)`` per path, the
grouping of files into objects (object ids are random, so the grouping is
compared), and the manifest rows per cas_id. The JAX side runs the
IndexerJob → FileIdentifierJob head of the chain its ``scan_location``
starts, on its numpy CDC rung; the port's ``scan_location`` also chains its
near-duplicate job, which writes none of these rows (its own rows are
compared in ``tests/test_torch_minhash.py``).

Also: the port's entry points default to the card and raise without one, and
neither the port nor chip_smoke.py imports jax or the JAX package.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from spacedrive_tpu.locations import create_location as jax_create_location
from spacedrive_tpu.locations.indexer_job import IndexerJob as JaxIndexerJob
from spacedrive_tpu.node import Node as JaxNode
from spacedrive_tpu.objects.file_identifier import FileIdentifierJob as JaxIdentifierJob
from spacedrive_tpu_torch.jobs import JobStatus
from spacedrive_tpu_torch.locations import create_location, scan_location
from spacedrive_tpu_torch.node import Node
from tests.torch_scan_cases import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def blob(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, size=n, dtype=np.uint8).tobytes()


def make_tree(root: Path) -> Path:
    """About 40 files: small files of many kinds, 3 over 100 KiB, one
    duplicate pair, one empty file, one over the 4 MiB manifest cap, plus
    paths the default rules reject."""
    exts = ["txt", "jpg", "ts", "bin", "dat", "", "json", "xyz", "mp3", "pdf"]
    seed = 0
    for d in range(4):
        (root / f"d{d}" / "sub").mkdir(parents=True)
        for i in range(8):
            seed += 1
            ext = exts[seed % len(exts)]
            name = f"f{i}.{ext}" if ext else f"f{i}"
            where = root / f"d{d}" / ("sub" if i % 3 == 0 else "") / name
            where.write_bytes(blob(seed, int(np.random.default_rng(seed).integers(1, 20_000))))
    (root / "d0" / "text.xyz").write_bytes(b"plain readable text\n" * 30)
    (root / "d0" / "script.ts").write_bytes(b"const x: number = 1;\n" * 10)
    for i, size in enumerate((102_401, 150_000, 300_007)):
        (root / "d1" / f"big{i}.bin").write_bytes(blob(100 + i, size))
    dup = blob(200, 3000)
    (root / "d2" / "dup_a.txt").write_bytes(dup)
    (root / "d3" / "sub" / "dup_b.txt").write_bytes(dup)
    (root / "d2" / "empty.txt").write_bytes(b"")
    with open(root / "d3" / "huge.bin", "wb") as fh:  # over the manifest cap
        fh.truncate(4 * 1024 * 1024 + 1000)
        fh.write(blob(300, 8192))
    (root / "d1" / ".hidden").write_bytes(b"skipped by No Hidden")
    (root / "d2" / "node_modules").mkdir()
    (root / "d2" / "node_modules" / "x.js").write_bytes(b"skipped")
    return root


def rows_of(db):
    paths = sorted(tuple(r) for r in db.query(
        "SELECT fp.materialized_path, fp.name, fp.extension, fp.size_in_bytes, "
        "fp.cas_id, o.kind FROM file_path fp LEFT JOIN object o ON fp.object_id = o.id"))
    groups: dict = {}
    for r in db.query("SELECT materialized_path, name, extension, object_id FROM file_path "
                      "WHERE object_id IS NOT NULL"):
        groups.setdefault(r["object_id"], []).append(tuple(r)[:3])
    manifests: dict = {}
    for r in db.query("SELECT DISTINCT fp.cas_id, cm.seq, cm.chunk_hash, cm.length "
                      "FROM chunk_manifest cm JOIN file_path fp ON fp.object_id = cm.object_id "
                      "ORDER BY fp.cas_id, cm.seq"):
        manifests.setdefault(r["cas_id"], []).append(tuple(r)[1:])
    return paths, sorted(sorted(g) for g in groups.values()), manifests


def jax_scan(data_dir, tree):
    node = JaxNode(data_dir, probe_accelerator=False, watch_locations=False)
    try:
        lib = node.libraries.create("jax")
        loc = jax_create_location(lib, tree)
        args = {"location_id": loc["id"]}
        node.jobs.spawn(lib, [JaxIndexerJob(args), JaxIdentifierJob(dict(args))])
        assert node.jobs.wait_idle(120)
        return rows_of(lib.db)
    finally:
        node.shutdown()


def port_scan(data_dir, tree):
    node = Node(data_dir, device="cpu", watch_locations=False)
    try:
        lib = node.libraries.create("port")
        loc = create_location(lib, tree)
        scan_location(lib, loc["id"])
        assert node.jobs.wait_idle(120)
        jobs = {r["name"]: r["status"] for r in lib.db.query("SELECT name, status FROM job")}
        # the tree's .jpg files are random bytes: the media processor
        # records a failed thumbnail for each
        assert jobs == {**dict.fromkeys(("indexer", "file_identifier", "dedup_detector"),
                                        JobStatus.COMPLETED),
                        "media_processor": JobStatus.COMPLETED_WITH_ERRORS}
        return rows_of(lib.db)
    finally:
        node.shutdown()


@pytest.fixture(scope="module")
def both_scans(tmp_path_factory):
    """(jax rows, port rows) of one tree, scanned once per module."""
    base = tmp_path_factory.mktemp("scan")
    tree = make_tree(base / "tree")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SD_CHUNK_MANIFESTS", "1")
        mp.setenv("SD_CDC_KERNEL", "numpy")
        mp.setenv("SD_P2P_DISABLED", "1")
        return jax_scan(base / "jax", tree), port_scan(base / "port", tree)


def test_scan_rows_match_jax(both_scans):
    (jax_paths, _, _), (port_paths, _, _) = both_scans
    assert port_paths == jax_paths
    assert len([r for r in port_paths if r[3] and r[4]]) >= 38
    assert not [r for r in port_paths if r[1] in (".hidden", "x")]


def test_object_grouping_matches_jax(both_scans):
    (_, jax_groups, _), (_, port_groups, _) = both_scans
    assert port_groups == jax_groups
    assert [("/d2/", "dup_a", "txt"), ("/d3/sub/", "dup_b", "txt")] in port_groups


def test_manifests_match_jax(both_scans):
    (jax_paths, _, jax_manifests), (port_paths, _, port_manifests) = both_scans
    assert port_manifests == jax_manifests
    sizes = {r[4]: r[3] for r in port_paths if r[4]}
    for cas_id, rows in port_manifests.items():
        assert sum(length for _seq, _hash, length in rows) == sizes[cas_id]
    huge = [r[4] for r in port_paths if r[1] == "huge"]
    assert huge and huge[0] not in port_manifests


def test_node_defaults_to_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Node(tmp_path / "data")


FORBIDDEN = {"jax", "jaxlib", "spacedrive_tpu"}


def _imports(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


PORT_FILES = sorted((REPO / "spacedrive_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tests" / "torch_multihost_worker.py",
    REPO / "tests" / "torch_kill_child.py", REPO / "tests" / "torch_serve_client.py",
    REPO / "tests" / "torch_sync_cases.py", REPO / "tests" / "torch_p2p_cases.py",
    REPO / "tests" / "torch_p2p_peer.py"]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_module_imports_no_jax(path):
    assert not _imports(path) & FORBIDDEN


#: modules a scan must load: the native gather, its fault seams, the media
#: processor with its resize and codecs, and the MinHash stage the scan chains
SCAN_MODULES = ("spacedrive_tpu_torch.faults", "spacedrive_tpu_torch.native",
                "spacedrive_tpu_torch.native.cas_native", "spacedrive_tpu_torch.ops.minhash",
                "spacedrive_tpu_torch.objects.dedup", "spacedrive_tpu_torch.atomic",
                "spacedrive_tpu_torch.objects.media.processor",
                "spacedrive_tpu_torch.objects.media.thumbnail",
                "spacedrive_tpu_torch.objects.media.metadata",
                "spacedrive_tpu_torch.native.images_native", "spacedrive_tpu_torch.ops.resize",
                # the serving path: the router with every sub-router and the shell
                "spacedrive_tpu_torch.api.router", "spacedrive_tpu_torch.api.invalidate",
                "spacedrive_tpu_torch.api.routers.root", "spacedrive_tpu_torch.api.routers.libraries",
                "spacedrive_tpu_torch.api.routers.locations", "spacedrive_tpu_torch.api.routers.search",
                "spacedrive_tpu_torch.api.routers.jobs", "spacedrive_tpu_torch.api.routers.tags",
                "spacedrive_tpu_torch.api.routers.notifications", "spacedrive_tpu_torch.statistics",
                "spacedrive_tpu_torch.notifications", "spacedrive_tpu_torch.objects.tags",
                "spacedrive_tpu_torch.locations.non_indexed", "spacedrive_tpu_torch.server.shell",
                "spacedrive_tpu_torch.server.http",
                # the live library: the watcher, the fs jobs and their
                # routers, backups and the boot gate
                "spacedrive_tpu_torch.locations.watcher", "spacedrive_tpu_torch.objects.fs",
                "spacedrive_tpu_torch.api.routers.files", "spacedrive_tpu_torch.api.routers.backups",
                "spacedrive_tpu_torch.api.routers.nodes", "spacedrive_tpu_torch.api.routers.volumes",
                "spacedrive_tpu_torch.api.routers.preferences",
                "spacedrive_tpu_torch.api.routers.categories", "spacedrive_tpu_torch.backups",
                "spacedrive_tpu_torch.recovery", "spacedrive_tpu_torch.volumes",
                "spacedrive_tpu_torch.preferences",
                # sync: the scan logs its operations, the instance identity
                "spacedrive_tpu_torch.sync", "spacedrive_tpu_torch.sync.manager",
                "spacedrive_tpu_torch.sync.crdt", "spacedrive_tpu_torch.sync.hlc",
                "spacedrive_tpu_torch.sync.apply", "spacedrive_tpu_torch.sync.ingest",
                "spacedrive_tpu_torch.sync.lanes", "spacedrive_tpu_torch.sync.admission",
                "spacedrive_tpu_torch.p2p.identity", "spacedrive_tpu_torch.api.routers.sync",
                # p2p: the node's manager and every module it runs, the router
                "spacedrive_tpu_torch.p2p", "spacedrive_tpu_torch.p2p.proto",
                "spacedrive_tpu_torch.p2p.ed25519_ref", "spacedrive_tpu_torch.p2p.secure",
                "spacedrive_tpu_torch.p2p.mux", "spacedrive_tpu_torch.p2p.spaceblock",
                "spacedrive_tpu_torch.p2p.discovery", "spacedrive_tpu_torch.p2p.manager",
                "spacedrive_tpu_torch.p2p.pairing", "spacedrive_tpu_torch.p2p.nlm",
                "spacedrive_tpu_torch.p2p.delta", "spacedrive_tpu_torch.api.routers.p2p")


def test_port_scan_loads_no_jax(tmp_path):
    """A whole port scan in a fresh interpreter (its native gather, its
    media processor on a PNG and its near-duplicate job on two copies over
    100 KiB included, the location watched, sync logging its operations,
    the node's p2p manager listening),
    then a search served by the server shell over HTTP, leaves jax
    unimported."""
    from PIL import Image

    (tmp_path / "t").mkdir()
    (tmp_path / "t" / "a.txt").write_bytes(b"hello" * 100)
    (tmp_path / "t" / "b.bin").write_bytes(blob(1, 200_000))
    (tmp_path / "t" / "c.bin").write_bytes(blob(1, 200_000))
    pixels = np.frombuffer(blob(2, 600 * 800 * 3), np.uint8).reshape(600, 800, 3)
    Image.fromarray(pixels).save(tmp_path / "t" / "d.png")
    code = (
        "import sys\n"
        "from spacedrive_tpu_torch.node import Node\n"
        "from spacedrive_tpu_torch.locations import create_location, scan_location\n"
        "from spacedrive_tpu_torch.native import cas_native\n"
        "from spacedrive_tpu_torch.server import Server\n"
        "import json, urllib.request\n"
        f"node = Node({str(tmp_path / 'd')!r}, device='cpu', watch_locations=True)\n"
        "assert node.config.toggle_feature('syncEmitMessages')\n"
        "lib = node.libraries.create('x')\n"
        f"loc = create_location(lib, {str(tmp_path / 't')!r})\n"
        "scan_location(lib, loc['id'])\n"
        "assert node.jobs.wait_idle(60)\n"
        "assert node.p2p is not None and node.p2p.port\n"
        "ops = lib.sync.get_ops({}, 1000)[0]\n"
        "assert {o['typ']['kind'] for o in ops} >= {'c', 'u:cas_id', 'u:object_id'}, ops\n"
        "n = lib.db.query('SELECT COUNT(*) AS n FROM chunk_manifest')[0]['n']\n"
        "pairs = lib.db.query('SELECT COUNT(*) AS n FROM near_duplicate')[0]['n']\n"
        "thumbs = len(list(node.data_dir.glob('thumbnails/*/*.webp')))\n"
        "server = Server(node, '127.0.0.1', 0)\n"
        "server.start()\n"
        "body = urllib.request.urlopen(f'http://127.0.0.1:{server.port}/rspc/search.pathsCount'"
        "f'?library_id={lib.id}').read()\n"
        "server.stop()\n"
        "assert json.loads(body) == {'result': 5}, body\n"
        "node.shutdown()\n"
        f"assert all(m in sys.modules for m in {SCAN_MODULES!r})\n"
        "print(n, pairs, thumbs, sum(cas_native.GATHER_BATCHES.values()), 'jax' in sys.modules, "
        "any(m.startswith('spacedrive_tpu.') or m == 'spacedrive_tpu' for m in sys.modules))\n")
    env = {**os.environ, "PYTHONPATH": str(REPO), "SD_CHUNK_MANIFESTS": "1"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=tmp_path, timeout=120)
    assert out.returncode == 0, out.stderr
    n, pairs, thumbs, batches, jax_loaded, ref_loaded = out.stdout.split()
    assert int(n) > 0 and int(pairs) == 1 and int(thumbs) == 1 and int(batches) > 0
    assert jax_loaded == "False" and ref_loaded == "False"
