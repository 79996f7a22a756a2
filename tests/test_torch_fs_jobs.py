"""The port's file-operation jobs (spacedrive_tpu_torch/objects/fs.py)
against the JAX package's, on the CPU.

Each package indexes and identifies its own copy of one seeded tree, then
runs the same jobs on the same paths: copies (a file onto its own name, a
directory into a directory that already has one of its name, so both
collisions resolve to ``name (2)``), moves (a file, a directory, one onto
an existing file, refused, one onto itself), deletes and erases (a file and
a directory each). After each job the two trees hold the same paths with
the same bytes, the rows (path, name, extension, size, cas_id, kind) and
their grouping into objects are equal, and so are the job reports (status,
metadata, error lines with each tree's root replaced). An erase leaves no
file and no row; a cold resume finds every fs job by name. With sync
emitting (``toggleFeatureFlag``), a copy, a move and a delete log the
operations the JAX package's log (``tests/torch_sync_cases.op_log``): the
deletes, and nothing for the rows the light rescan writes.
"""

import json
import os

import pytest

from spacedrive_tpu.locations import create_location as jax_create_location
from spacedrive_tpu.locations.indexer_job import IndexerJob as JaxIndexerJob
from spacedrive_tpu.node import Node as JaxNode
from spacedrive_tpu.objects import fs as jax_fs
from spacedrive_tpu.objects.file_identifier import FileIdentifierJob as JaxIdentifierJob
from spacedrive_tpu_torch.jobs import JOB_REGISTRY
from spacedrive_tpu_torch.locations import create_location
from spacedrive_tpu_torch.locations.indexer_job import IndexerJob
from spacedrive_tpu_torch.node import Node
from spacedrive_tpu_torch.objects import fs
from spacedrive_tpu_torch.objects.file_identifier import FileIdentifierJob
from tests.torch_scan_cases import blob, rows_of, one_torch_thread  # noqa: F401
from tests.torch_sync_cases import op_log, pub_keys


def make_tree(root):
    for d in range(4):
        (root / f"d{d}" / "sub").mkdir(parents=True)
        for i in range(3):
            (root / f"d{d}" / f"f{i}.bin").write_bytes(blob(10 * d + i, 500 + 900 * i))
        (root / f"d{d}" / "sub" / "s.txt").write_bytes(blob(50 + d, 64))
    (root / "d3" / "d1").mkdir()  # a directory named like one copied in
    return root


def tree_bytes(root):
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        for d in dirnames:
            out[os.path.normpath(os.path.join(rel, d))] = None
        for f in filenames:
            if f != ".spacedrive":
                with open(os.path.join(dirpath, f), "rb") as fh:
                    out[os.path.normpath(os.path.join(rel, f))] = fh.read()
    return out


@pytest.fixture()
def sides(tmp_path, monkeypatch):
    monkeypatch.setenv("SD_P2P_DISABLED", "1")
    jnode = JaxNode(tmp_path / "jax", probe_accelerator=False, watch_locations=False)
    pnode = Node(tmp_path / "port", device="cpu", watch_locations=False)
    out = {}
    try:
        for pkg, node, create, jobs, mod in (
                ("jax", jnode, jax_create_location, (JaxIndexerJob, JaxIdentifierJob), jax_fs),
                ("port", pnode, create_location, (IndexerJob, FileIdentifierJob), fs)):
            tree = make_tree(tmp_path / f"tree_{pkg}")
            lib = node.libraries.create(pkg)
            loc = create(lib, tree)
            node.jobs.spawn(lib, [job({"location_id": loc["id"]}) for job in jobs])
            assert node.jobs.wait_idle(120)
            out[pkg] = (node, lib, loc, tree, mod)
        yield out
    finally:
        jnode.shutdown()
        pnode.shutdown()


def fp_id(db, rel, is_dir=False):
    mp, _, leaf = rel.rpartition("/")
    mp = f"/{mp}/" if mp else "/"
    name, ext = (leaf, "") if is_dir or "." not in leaf else leaf.rsplit(".", 1)
    return db.query("SELECT id FROM file_path WHERE materialized_path = ? AND name = ? "
                    "AND extension = ? AND is_dir = ?", [mp, name, ext, int(is_dir)])[0]["id"]


def run_job(sides, job_name, sources, **args):
    """Run the job in both packages on the same sources; returns the port's
    report, after checking it, the trees and the rows against the JAX
    package's."""
    got = {}
    for pkg, (node, lib, loc, tree, mod) in sides.items():
        ids = [fp_id(lib.db, rel, is_dir) for rel, is_dir in sources]
        init = {"sources": ids, **args}
        if "target_dir" in args:
            init["target_location_id"] = loc["id"]
        job_id = node.jobs.spawn(lib, [getattr(mod, job_name)(init)])
        assert node.jobs.wait_idle(60)
        row = dict(lib.db.query("SELECT * FROM job WHERE id = ?", [job_id])[0])
        meta = row["metadata"]
        meta = json.loads(meta) if isinstance(meta, (str, bytes)) else meta
        errors = (row["errors_text"] or "").replace(str(tree), "<tree>")
        got[pkg] = ((row["status"], {k: v for k, v in (meta or {}).items() if k != "trace"},
                     errors), tree_bytes(tree), rows_of(lib.db))
    assert got["port"][1] == got["jax"][1], f"{job_name}: trees differ"
    assert got["port"][2] == got["jax"][2], f"{job_name}: rows differ"
    assert got["port"][0] == got["jax"][0], f"{job_name}: reports differ"
    return got["port"]


def test_copy_with_name_collisions_matches_jax(sides):
    report, tree, _rows = run_job(sides, "FileCopierJob",
                                  [("d0/f0.bin", False), ("d1", True)], target_dir="d3")
    assert report[1]["copied"] == 7  # a file; the directory, its three files, sub/ and s.txt
    assert "d3/f0 (2).bin" in tree and "d3/d1 (2)/sub/s.txt" in tree
    report, tree, rows = run_job(sides, "FileCopierJob", [("d2/f1.bin", False)], target_dir="d2")
    assert "d2/f1 (2).bin" in tree
    assert any(r[0] == "/d2/" and r[1] == "f1 (2)" for r in rows[0])


def test_moves_match_jax(sides):
    report, tree, _rows = run_job(sides, "FileCutterJob",
                                  [("d0/f1.bin", False), ("d2/sub", True)], target_dir="d3/d1")
    assert "d3/d1/f1.bin" in tree and "d3/d1/sub/s.txt" in tree and "d2/sub" not in tree
    # onto an existing file: refused, the rest of the job goes on
    report, tree, _rows = run_job(sides, "FileCutterJob",
                                  [("d2/f1.bin", False), ("d1/f0.bin", False)],
                                  target_dir="d3/d1")
    assert "would overwrite" in report[2] and "d2/f1.bin" in tree and "d3/d1/f0.bin" in tree
    report, _tree, _rows = run_job(sides, "FileCutterJob", [("d0/f2.bin", False)],
                                   target_dir="d0")
    assert report[1]["moved"] == 0


def test_delete_and_erase_match_jax(sides):
    _report, tree, rows = run_job(sides, "FileDeleterJob",
                                  [("d0/f0.bin", False), ("d1", True)])
    assert "d0/f0.bin" not in tree and not any(k.startswith("d1") for k in tree)
    assert not any(r[0].startswith("/d1/") for r in rows[0])
    report, tree, rows = run_job(sides, "FileEraserJob",
                                 [("d2/f2.bin", False), ("d3", True)], passes=1)
    assert report[1]["erased"] == 6  # a file; d3's four files, then d3
    assert "d2/f2.bin" not in tree and not any(k.startswith("d3") for k in tree)
    assert not any(r[0].startswith("/d3/") or (r[0] == "/" and r[1] == "d3") or
                   (r[0] == "/d2/" and r[1] == "f2") for r in rows[0])


def test_create_helpers_and_registry_match_jax(tmp_path):
    for mod, name in ((jax_fs, "jax"), (fs, "port")):
        root = tmp_path / name
        root.mkdir()
        made = [mod.create_file(root, "a.txt", b"x"), mod.create_file(root, "a.txt"),
                mod.create_directory(root, "New Folder"), mod.create_directory(root, "New Folder")]
        assert [p.name for p in made] == ["a.txt", "a (2).txt", "New Folder", "New Folder (2)"]
        assert mod.find_available_name(root / "none.bin") == root / "none.bin"
    for job in ("file_copier", "file_cutter", "file_deleter", "file_eraser"):
        assert job in JOB_REGISTRY


def test_fs_jobs_log_the_ops_jax_logs(sides):
    keys = {}
    for pkg, (node, lib, _loc, _tree, _mod) in sides.items():
        assert node.router.resolve("toggleFeatureFlag", "syncEmitMessages") is True
        keys[pkg] = pub_keys(lib.db)
    run_job(sides, "FileCopierJob", [("d0/f0.bin", False), ("d1", True)], target_dir="d3")
    run_job(sides, "FileCutterJob", [("d0/f1.bin", False), ("d2/sub", True)], target_dir="d3/d1")
    run_job(sides, "FileDeleterJob", [("d0/f2.bin", False), ("d1", True)])
    logs = {}
    for pkg, (_node, lib, _loc, tree, _mod) in sides.items():
        logs[pkg] = op_log(lib.db, {**pub_keys(lib.db), **keys[pkg]}, roots=(tree,),
                           drop=("inode",))
    assert logs["port"] == logs["jax"]
    kinds = [json.loads(k)[3] for k in logs["port"] for _ in range(logs["port"][k])]
    # the deletes of a file and of d1's subtree; the copies' and the moves'
    # rows come from the light rescan, which logs nothing in either package
    assert kinds == ["d"] * 7
