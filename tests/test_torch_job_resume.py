"""Pause, resume, cancel and cold resume of the port's pipelined identify
job on the CPU, held against the JAX Node's uninterrupted scan.

- Pause mid-pipeline at ``SD_COMMIT_GROUP`` 1 and 16 (``tests/test_pipeline.py``
  :210-260): the gather of the third page is held until the pause is sent,
  the job ends Paused with a checkpoint at a committed-page boundary, no
  hash dispatch happens after it, and the resumed job gives the JAX Node's
  rows (cas_ids, kinds, objects, manifests).
- Cancel while a commit group is being gathered (:262-300): only whole
  pages are committed.
- The three scan kill points of ``tests/crash_harness.py``
  (``gather:kill:skip30``, ``hash:kill:skip4``, ``commit:kill:skip3``):
  ``tests/torch_kill_child.py`` runs the port on the CPU in a child process
  until the armed seam SIGKILLs it; a port Node booted on its data dir
  sweeps the stale temporary the child planted and cold-resumes the
  ``Running`` identify job to the JAX Node's rows.
"""

import json
import signal
import sqlite3
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from spacedrive_tpu.locations import create_location as jax_create_location
from spacedrive_tpu.locations.indexer_job import IndexerJob as JaxIndexerJob
from spacedrive_tpu.node import Node as JaxNode
from spacedrive_tpu.objects import file_identifier as jax_fi
from spacedrive_tpu_torch.jobs import JobStatus
from spacedrive_tpu_torch.locations import create_location
from spacedrive_tpu_torch.locations.indexer_job import IndexerJob
from spacedrive_tpu_torch.models import JobRow
from spacedrive_tpu_torch.node import Node
from spacedrive_tpu_torch.objects import file_identifier as fi
from spacedrive_tpu_torch.pipeline import executor
from tests.crash_harness import make_tree as crash_tree
from tests.torch_scan_cases import PAGE, make_tree, page_of, rows_of, one_torch_thread  # noqa: F401

CHILD = Path(__file__).resolve().parent / "torch_kill_child.py"
#: the crash harness's scan shape: 200 files, 24-file pages, 4-page groups
KILL_BATCH, KILL_GROUP = 24, 4
KILL_POINTS = ("gather:kill:skip30", "hash:kill:skip4", "commit:kill:skip3")


def jax_rows(data_dir: Path, tree: Path, batch: int, manifests: bool):
    """The JAX Node's rows of an uninterrupted index + identify."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_fi, "BATCH_SIZE", batch)
        mp.setenv("SD_P2P_DISABLED", "1")
        if manifests:
            mp.setenv("SD_CHUNK_MANIFESTS", "1")
            mp.setenv("SD_CDC_KERNEL", "numpy")
        node = JaxNode(data_dir, probe_accelerator=False, watch_locations=False)
        try:
            lib = node.libraries.create("jax")
            args = {"location_id": jax_create_location(lib, tree)["id"]}
            node.jobs.spawn(lib, [JaxIndexerJob(args), jax_fi.FileIdentifierJob(dict(args))])
            assert node.jobs.wait_idle(120)
            return rows_of(lib.db)
        finally:
            node.shutdown()


def wait_for(pred, timeout: float = 60.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("resume") / "tree")


@pytest.fixture(scope="module")
def reference(tree, tmp_path_factory):
    return jax_rows(tmp_path_factory.mktemp("jax"), tree, PAGE, manifests=True)


class HeldScan:
    """A port Node indexing and identifying ``tree`` with PAGE-file pages,
    the gather of page ``hold`` held until :meth:`release`, and the hash
    dispatches counted."""

    def __init__(self, data_dir: Path, tree: Path, mp, hold: int) -> None:
        mp.setattr(fi, "BATCH_SIZE", PAGE)
        mp.setenv("SD_CHUNK_MANIFESTS", "1")
        mp.setenv("SD_SCAN_SHARDS", "1")
        self.reached, self._release = threading.Event(), threading.Event()
        self.gathers = 0
        real = fi.read_sampled_batch

        def held(paths, sizes):
            self.gathers += 1
            if self.gathers == hold:
                self.reached.set()
                assert self._release.wait(60)
            return real(paths, sizes)

        mp.setattr(fi, "read_sampled_batch", held)
        self.node = Node(data_dir, device="cpu", watch_locations=False)
        self.hashes: list[str] = []
        real_hash = self.node.hasher.hash_gathered

        def counted(messages):
            self.hashes.append(threading.current_thread().name)
            return real_hash(messages)

        self.node.hasher.hash_gathered = counted
        self.lib = self.node.libraries.create("port")
        args = {"location_id": create_location(self.lib, tree)["id"]}
        self.node.jobs.spawn(self.lib, [IndexerJob(args), fi.FileIdentifierJob(dict(args))])
        assert self.reached.wait(60)
        self.job_id = self.lib.db.find_one(JobRow, {"name": "file_identifier"})["id"]

    def job(self) -> dict:
        return self.lib.db.find_one(JobRow, {"id": self.job_id})

    def checkpoint(self) -> dict:
        return json.loads(self.job()["data"])

    def release_after_the_command(self) -> None:
        """Release the held gather once the job's command is queued, so the
        command lands at the committer's next poll."""
        worker = self.node.jobs._running[self.job_id]

        def go():
            wait_for(lambda: not worker._commands.empty())
            self._release.set()

        threading.Thread(target=go).start()

    def identified(self) -> set:
        return {(r["materialized_path"], r["name"]) for r in self.lib.db.query(
            "SELECT materialized_path, name FROM file_path WHERE cas_id IS NOT NULL")}


@pytest.mark.parametrize("group", [1, 16])
def test_pause_mid_pipeline_resumes_to_the_jax_rows(tree, reference, tmp_path, monkeypatch,
                                                     group):
    monkeypatch.setenv("SD_COMMIT_GROUP", str(group))
    scan = HeldScan(tmp_path / "port", tree, monkeypatch, hold=3)
    try:
        # pages 1 and 2 commit (a group of 16 by its linger, the gather
        # being held) and checkpoint
        assert wait_for(lambda: scan.checkpoint()["step_number"] >= 2)
        assert scan.node.jobs.pause(scan.job_id)
        scan.release_after_the_command()
        assert wait_for(lambda: scan.job()["status"] == JobStatus.PAUSED)
        hashes = len(scan.hashes)
        time.sleep(0.5)
        assert len(scan.hashes) == hashes  # no dispatch after the pause
        state = scan.checkpoint()
        committed = state["step_number"]
        pages = page_of(scan.lib.db)
        assert 2 <= committed < 5 and state["data"]["cursor"] > 0
        # whole pages: exactly the non-empty files of the committed pages
        assert scan.identified() == {k for k, p in pages.items()
                                     if p < committed and k[1] != "zz_empty"}
        indexer = scan.lib.db.query("SELECT status FROM job WHERE name = 'indexer'")
        assert [r["status"] for r in indexer] == [JobStatus.COMPLETED]
        assert scan.node.jobs.resume(scan.lib, scan.job_id)
        assert scan.node.jobs.wait_idle(120)
        assert scan.job()["status"] == JobStatus.COMPLETED
        rows = rows_of(scan.lib.db)
    finally:
        scan._release.set()
        scan.node.shutdown()
    assert rows == reference


def test_cancel_mid_group_leaves_whole_pages(tree, tmp_path, monkeypatch):
    monkeypatch.setenv("SD_COMMIT_GROUP", "2")
    monkeypatch.setattr(executor, "GROUP_LINGER_S", 60.0)  # a group waits to fill
    scan = HeldScan(tmp_path / "port", tree, monkeypatch, hold=4)
    try:
        # pages 1-2 committed as one group; page 3 hashed, waiting for its
        # group's second page, whose gather is held
        assert wait_for(lambda: scan.checkpoint()["step_number"] == 2 and len(scan.hashes) == 3)
        assert scan.node.jobs.cancel(scan.job_id)
        scan.release_after_the_command()
        assert scan.node.jobs.wait_idle(60)
        job = scan.job()
        pages = page_of(scan.lib.db)
        identified = scan.identified()
    finally:
        scan._release.set()
        scan.node.shutdown()
    assert job["status"] == JobStatus.CANCELED
    assert json.loads(job["data"])["step_number"] == 2
    assert identified == {k for k, p in pages.items() if p < 2 and k[1] != "zz_empty"}


@pytest.fixture(scope="module")
def kill_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("kill")
    tree = crash_tree(root / "tree")
    return tree, jax_rows(root / "jax", tree, KILL_BATCH, manifests=False)


@pytest.mark.parametrize("spec", KILL_POINTS)
def test_a_killed_scan_cold_resumes_to_the_jax_rows(kill_tree, tmp_path, monkeypatch, spec):
    tree, want = kill_tree
    data_dir = tmp_path / "node"
    proc = subprocess.run([sys.executable, str(CHILD), str(data_dir), str(tree), spec,
                           str(KILL_BATCH), str(KILL_GROUP)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-3000:]
    (db_path,) = (data_dir / "libraries").glob("*.db")
    conn = sqlite3.connect(db_path)
    status, blob = conn.execute(
        "SELECT status, data FROM job WHERE name = 'file_identifier'").fetchone()
    conn.close()
    assert status == JobStatus.RUNNING
    killed_at = json.loads(blob)["step_number"]
    stale = list((data_dir / "thumbnails").glob("*/*.sd-tmp*"))
    assert len(stale) == 1

    monkeypatch.setattr(fi, "BATCH_SIZE", KILL_BATCH)
    monkeypatch.setenv("SD_COMMIT_GROUP", str(KILL_GROUP))
    node = Node(data_dir, device="cpu", watch_locations=False)  # sweeps, then cold-resumes
    try:
        assert not stale[0].exists()
        (lib,) = node.libraries.list()
        assert node.jobs.wait_idle(120)
        job = lib.db.find_one(JobRow, {"name": "file_identifier"})
        rows = rows_of(lib.db)
    finally:
        node.shutdown()
    assert job["status"] == JobStatus.COMPLETED
    if spec.startswith("commit"):
        assert killed_at > 0  # died in the second group's transaction
    assert rows == want
