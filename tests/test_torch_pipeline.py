"""The port's streaming scan pipeline (spacedrive_tpu_torch/pipeline/) against
the JAX package's, on the CPU.

- The parity matrix: port scans under ``SD_PIPELINE=1`` with
  ``SD_SCAN_SHARDS`` in {1, 2, 4} and ``SD_COMMIT_GROUP`` in {1, 4}, and under
  ``SD_PIPELINE=0``, give the JAX Node's rows (cas_id, kind, object grouping,
  manifests) exactly. ``BATCH_SIZE`` is 16 in both packages, so the tree
  spans several pages and groups; it plants copies of one file in two pages
  of one commit group, copies across groups, and an empty file a page.
- ``_page_limit`` replayed against the reference's over fixed stage shares.
- The executor with a fake spec: ordered commits under out-of-order slices,
  stage overlap, a deterministic error, a group attempt that fails.
- A transient slice error ends the job Paused with exactly the earlier
  pages committed, as the JAX job does under the same patch; a RuntimeError
  from the hasher fails the job, with no CPU re-dispatch.
- The WAL reader routing of ``models/base.py``.
"""

import errno
import sqlite3
import threading
import time
from pathlib import Path

import pytest

from spacedrive_tpu.jobs import JobStatus as JaxJobStatus
from spacedrive_tpu.locations import create_location as jax_create_location
from spacedrive_tpu.locations.indexer_job import IndexerJob as JaxIndexerJob
from spacedrive_tpu.node import Node as JaxNode
from spacedrive_tpu.objects import file_identifier as jax_fi
from spacedrive_tpu_torch.jobs import JobPaused, JobState, StatefulJob, StepResult, JobStatus
from spacedrive_tpu_torch.locations import create_location, scan_location
from spacedrive_tpu_torch.models import ALL_MODELS, Database, JobRow
from spacedrive_tpu_torch.node import Node
from spacedrive_tpu_torch.objects import file_identifier as fi
from spacedrive_tpu_torch.pipeline import PipelineExecutor, PipelineSpec, executor
from tests.torch_scan_cases import PAGE, make_tree, page_of, rows_of

def jax_scan(data_dir: Path, tree: Path):
    node = JaxNode(data_dir, probe_accelerator=False, watch_locations=False)
    try:
        lib = node.libraries.create("jax")
        loc = jax_create_location(lib, tree)
        args = {"location_id": loc["id"]}
        node.jobs.spawn(lib, [JaxIndexerJob(args), jax_fi.FileIdentifierJob(dict(args))])
        assert node.jobs.wait_idle(120)
        status = lib.db.query("SELECT status FROM job WHERE name = 'file_identifier'")
        return rows_of(lib.db), status[0]["status"], page_of(lib.db)
    finally:
        node.shutdown()


def port_scan(data_dir: Path, tree: Path):
    """(rows, identify job row, page map) of one port scan on the CPU."""
    node = Node(data_dir, device="cpu")
    try:
        lib = node.libraries.create("port")
        loc = create_location(lib, tree)
        scan_location(lib, loc["id"])
        assert node.jobs.wait_idle(120)
        job = lib.db.find_one(JobRow, {"name": "file_identifier"})
        return rows_of(lib.db), job, page_of(lib.db)
    finally:
        node.shutdown()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("pipeline") / "tree")


def pin_pages(monkeypatch):
    """Fixed 16-file pages in both packages, manifests on, numpy CDC in JAX."""
    monkeypatch.setattr(jax_fi, "BATCH_SIZE", PAGE)
    monkeypatch.setattr(fi, "BATCH_SIZE", PAGE)
    monkeypatch.setenv("SD_CHUNK_MANIFESTS", "1")
    monkeypatch.setenv("SD_CDC_KERNEL", "numpy")
    monkeypatch.setenv("SD_P2P_DISABLED", "1")
    for var in ("SD_PIPELINE", "SD_SCAN_SHARDS", "SD_COMMIT_GROUP", "SD_SCAN_BATCH",
                "SD_SCAN_ADAPT"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


@pytest.fixture()
def pinned_pages(monkeypatch):
    return pin_pages(monkeypatch)


@pytest.fixture(scope="module")
def reference(tree, tmp_path_factory):
    """The JAX Node's rows and page map of the tree, scanned once."""
    with pytest.MonkeyPatch.context() as mp:
        pin_pages(mp)
        rows, status, pages = jax_scan(tmp_path_factory.mktemp("jax"), tree)
    assert status == JaxJobStatus.COMPLETED
    return rows, pages


MATRIX = [("sequential", 0, 0)] + [("pipelined", s, g) for s in (1, 2, 4) for g in (1, 4)]


@pytest.mark.parametrize("schedule,shards,group", MATRIX,
                         ids=[f"{m}-s{s}-g{g}" if s else m for m, s, g in MATRIX])
def test_scan_matches_jax_under_every_schedule(tree, reference, pinned_pages, tmp_path,
                                               schedule, shards, group):
    jax_rows, jax_pages = reference
    if schedule == "sequential":
        pinned_pages.setenv("SD_PIPELINE", "0")
    else:
        pinned_pages.setenv("SD_SCAN_SHARDS", str(shards))
        pinned_pages.setenv("SD_COMMIT_GROUP", str(group))
        # a group fills whatever the CPU hash takes a page
        pinned_pages.setattr(executor, "GROUP_LINGER_S", 60.0)
    rows, job, pages = port_scan(tmp_path, tree)
    assert rows == jax_rows
    assert pages == jax_pages  # the same page boundaries in both packages
    assert job["status"] == JobStatus.COMPLETED
    meta = job["metadata"]
    n_pages = max(pages.values()) + 1
    assert n_pages == 5
    # the planted copies: pages 0 and 1 (one group of 4), pages 2 and 4+
    groups = rows[1]
    for a, b in (("/d0/", "/d1/"), ("/d2/", "/d4/")):
        assert sorted([(a, "dup", "txt"), (b, "dup", "txt")]) in groups
    assert pages[("/d0/", "dup")] // 4 == pages[("/d1/", "dup")] // 4
    assert pages[("/d0/", "dup")] != pages[("/d1/", "dup")]
    assert pages[("/d2/", "dup")] // 4 != pages[("/d4/", "dup")] // 4
    empties = {page for (mp, name), page in pages.items() if name == "zz_empty"}
    assert len(empties) == 5
    if schedule == "sequential":
        assert "pipeline_batches" not in meta
        return
    assert meta["pipeline_batches"] == n_pages
    assert meta["pipeline_shards"] == str(shards)
    assert meta["commit_txns"] == -(-n_pages // group)
    assert all(meta[k] > 0 for k in ("pipeline_page_s", "pipeline_hash_s",
                                     "pipeline_commit_s", "pipeline_wall_s"))


# -- adaptive pages ----------------------------------------------------------

HASH = {"page": 0.1, "hash": 0.8, "commit": 0.1}
GATHER = {"page": 0.9, "hash": 0.05, "commit": 0.05}
COMMIT = {"page": 0.1, "hash": 0.1, "commit": 0.65}
EVEN = {"page": 0.3, "hash": 0.3, "commit": 0.3}
#: down to the floor, back toward BATCH_SIZE, up to the ceiling, back, and
#: shares at the 0.6 threshold
SHARES = ([None] + [HASH] * 6 + [EVEN] * 3 + [GATHER] * 9 + [COMMIT] * 2 + [EVEN] * 4
          + [{"page": 0.6, "hash": 0.2, "commit": 0.1}, {"page": 0.2, "hash": 0.61, "commit": 0.1},
             {"page": 0.5, "hash": 0.5, "commit": 0.0}])


@pytest.mark.parametrize("env", [{}, {"SD_SCAN_BATCH": "300"}, {"SD_SCAN_ADAPT": "0"},
                                 {"SD_SCAN_BATCH": "x"}, {"batch": 16}],
                         ids=["adaptive", "pinned-300", "adapt-off", "bad-pin", "batch-16"])
def test_page_limit_replays_the_reference(monkeypatch, env):
    for var in ("SD_SCAN_BATCH", "SD_SCAN_ADAPT"):
        monkeypatch.delenv(var, raising=False)
    for key, value in env.items():
        if key == "batch":
            monkeypatch.setattr(fi, "BATCH_SIZE", value)
            monkeypatch.setattr(jax_fi, "BATCH_SIZE", value)
        else:
            monkeypatch.setenv(key, value)
    assert fi._adaptive_batching() == jax_fi._adaptive_batching()
    assert fi._env_batch_pin() == jax_fi._env_batch_pin()
    ours: dict = {}
    theirs: dict = {}
    seen = []
    for shares in SHARES:
        for scratch in (ours, theirs):
            if shares is not None:
                scratch["stage_shares"] = dict(shares)
        seen.append(fi._page_limit(ours))
        assert seen[-1] == jax_fi._page_limit(theirs)
        assert ours == theirs
    if env == {}:
        assert min(seen) == fi.ADAPT_MIN_BATCH and max(seen) == fi.ADAPT_MAX_BATCH


# -- the executor with a fake spec -------------------------------------------


class FakeLibrary:
    def __init__(self, db) -> None:
        self.db = db
        self.events: list = []

    def emit(self, kind: str, payload=None) -> None:
        self.events.append((kind, payload))


class FakeCtx:
    def __init__(self, db) -> None:
        self.library = FakeLibrary(db)
        self.progressed: list = []

    def progress(self, completed_task_count=None, task_count=None) -> None:
        self.progressed.append(completed_task_count)


class FakeJob(StatefulJob):
    NAME = "fake"


def db_with_table(path: Path) -> Database:
    db = Database(path, ALL_MODELS)
    db.execute("CREATE TABLE page (n INTEGER PRIMARY KEY)")
    return db


def run_fake(tmp_path, pages: int, *, slice_s=None, hash_s=0.0, commit=None,
             shard_fail=None, hash_fail=None, group=1, shards="1", monkeypatch=None,
             box=None):
    """Run the executor over ``pages`` pages of a fake job whose commit
    writes one row a page; returns (ctx, state, db, commit order). ``box``
    gets the state before the run, for a run that raises."""
    monkeypatch.setenv("SD_SCAN_SHARDS", shards)
    monkeypatch.setenv("SD_COMMIT_GROUP", str(group))
    db = db_with_table(tmp_path / "fake.db")
    order: list[int] = []

    def page(ctx, data, scratch):
        n = scratch.get("cursor", data["cursor"])
        if n >= pages:
            return None
        scratch["cursor"] = n + 1
        return n

    def split(ctx, data, scratch):
        n = scratch.get("cursor", data["cursor"])
        if n >= pages:
            return None
        scratch["cursor"] = n + 1
        return {"n": n, "parts": [(n, k) for k in range(scratch["shards"])]}

    def shard(ctx, data, part):
        if shard_fail is not None and part == shard_fail[0]:
            raise shard_fail[1]
        time.sleep(slice_s(*part) if slice_s else 0.0)
        return part

    def merge(ctx, data, header, results):
        assert results == [(header["n"], k) for k in range(len(results))]
        return header["n"]

    def process(ctx, data, n):
        if hash_fail is not None and n == hash_fail[0]:
            raise hash_fail[1]
        time.sleep(hash_s)
        return n

    def default_commit(ctx, data, n):
        with ctx.library.db.transaction():
            ctx.library.db.execute("INSERT INTO page (n) VALUES (?)", [n])
        data["cursor"] = n + 1
        order.append(n)
        return StepResult(metadata={"pages": 1})

    spec = PipelineSpec(page=page, process=process, commit=commit or default_commit,
                        split=split, shard=shard, merge=merge)
    ctx = FakeCtx(db)
    state = JobState({"cursor": 0}, [{}] * pages)
    if box is not None:
        box["state"] = state
    PipelineExecutor(spec, ctx, FakeJob({}), state, []).run()
    return ctx, state, db, order


def committed(db) -> list[int]:
    return [r["n"] for r in db.query("SELECT n FROM page ORDER BY n")]


def test_commits_follow_page_order_when_slices_finish_out_of_order(tmp_path, monkeypatch):
    # later slices of a page and earlier pages' slices sleep longest
    ctx, state, db, order = run_fake(
        tmp_path, 6, shards="3", group=2, slice_s=lambda n, k: 0.002 * (6 - n) * (3 - k),
        monkeypatch=monkeypatch)
    assert order == list(range(6)) and committed(db) == list(range(6))
    assert state.step_number == 6 and state.data["cursor"] == 6
    meta = state.run_metadata
    assert meta["pipeline_batches"] == 6 and meta["commit_txns"] == 3 and meta["pages"] == 6
    assert meta["pipeline_shards"] == "3"
    assert [e for e in ctx.library.events if e[0] == "db.commit"] == [
        ("db.commit", {"source": "pipeline", "job": "fake", "txns": t}) for t in (1, 2, 3)]


def test_stages_overlap(tmp_path, monkeypatch):
    # overlap shown by order, not by time: page n's process waits until
    # page n + 1 is being paged, and page n's commit until page n + 1 is
    # being processed. Run back to back, every wait would time out.
    pages = 6
    paged = [threading.Event() for _ in range(pages)]
    processed = [threading.Event() for _ in range(pages)]
    seen: list[tuple[str, int, bool]] = []
    monkeypatch.setenv("SD_SCAN_SHARDS", "1")
    monkeypatch.setenv("SD_COMMIT_GROUP", "1")
    db = db_with_table(tmp_path / "fake.db")

    def page(ctx, data, scratch):
        n = scratch.get("cursor", data["cursor"])
        if n >= pages:
            return None
        scratch["cursor"] = n + 1
        paged[n].set()
        return n

    def process(ctx, data, n):
        processed[n].set()
        if n + 1 < pages:
            seen.append(("process", n, paged[n + 1].wait(timeout=10)))
        return n

    def commit(ctx, data, n):
        if n + 1 < pages:
            seen.append(("commit", n, processed[n + 1].wait(timeout=10)))
        with ctx.library.db.transaction():
            ctx.library.db.execute("INSERT INTO page (n) VALUES (?)", [n])
        data["cursor"] = n + 1
        return StepResult()

    state = JobState({"cursor": 0}, [{}] * pages)
    PipelineExecutor(PipelineSpec(page=page, process=process, commit=commit),
                     FakeCtx(db), FakeJob({}), state, []).run()
    assert committed(db) == list(range(pages))
    assert sorted(seen) == sorted([(stage, n, True) for stage in ("process", "commit")
                                   for n in range(pages - 1)])
    meta = state.run_metadata
    assert meta["pipeline_batches"] == pages and meta["commit_txns"] == pages
    assert meta["pipeline_wall_s"] > 0


def test_a_deterministic_stage_error_fails_the_run(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="poisoned"):
        run_fake(tmp_path, 6, hash_fail=(3, ValueError("poisoned page")), group=4,
                 monkeypatch=monkeypatch)
    db = Database(tmp_path / "fake.db", ALL_MODELS)
    # the pages before the failure were committed first
    assert committed(db) == [0, 1, 2]


def test_a_transient_slice_error_pauses_at_the_last_committed_group(tmp_path, monkeypatch):
    # a slow dispatch keeps the queues full when the failure arrives: the
    # reference would drop the oldest queued page to make room for it and
    # commit the next one past the gap
    with pytest.raises(JobPaused) as info:
        run_fake(tmp_path, 6, shards="2", shard_fail=((4, 1), OSError(errno.EIO, "flaky")),
                 group=3, hash_s=0.05, monkeypatch=monkeypatch)
    db = Database(tmp_path / "fake.db", ALL_MODELS)
    assert committed(db) == [0, 1, 2, 3]
    assert "transiently" in info.value.errors[-1]


@pytest.mark.parametrize("error,attempts", [(sqlite3.OperationalError("database is locked"), 2),
                                            (KeyError("boom"), 1)],
                         ids=["transient-retried", "fatal"])
def test_a_failed_group_rolls_back_every_page_and_restores_data(tmp_path, monkeypatch, error,
                                                                attempts):
    monkeypatch.setattr(executor, "COMMIT_RETRY", executor.RetryPolicy(
        attempts=4, base_s=0.001, max_s=0.002, budget_s=5.0))
    calls = {"n": 0}

    def commit(ctx, data, n):
        with ctx.library.db.transaction():
            ctx.library.db.execute("INSERT INTO page (n) VALUES (?)", [n])
        data["cursor"] = n + 1
        data[f"seen{n}"] = True
        if n == 5:
            calls["n"] += 1
            if calls["n"] == 1:
                # the group holds pages 3, 4, 5 (the owner's view, inside
                # the open group): all three roll back
                assert committed(ctx.library.db) == [0, 1, 2, 3, 4, 5]
                raise error
        return StepResult()

    state_box: dict = {}
    if attempts == 1:
        with pytest.raises(KeyError):
            run_fake(tmp_path, 6, group=3, commit=commit, monkeypatch=monkeypatch,
                     box=state_box)
        db = Database(tmp_path / "fake.db", ALL_MODELS)
        assert committed(db) == [0, 1, 2]
        data = state_box["state"].data
        assert data == {"cursor": 3, "seen0": True, "seen1": True, "seen2": True}
        assert state_box["state"].step_number == 3
    else:
        _ctx, state, db, _ = run_fake(tmp_path, 6, group=3, commit=commit,
                                      monkeypatch=monkeypatch)
        assert committed(db) == list(range(6))
        assert state.data["cursor"] == 6 and state.run_metadata["commit_txns"] == 2
    assert calls["n"] == attempts


# -- job-level failures against the JAX job ----------------------------------


def poison_gather(monkeypatch, module, target: str):
    """Make the gather of the slice holding ``target`` raise EIO."""
    orig = module.FileIdentifierJob._gather_rows

    def gather(self, *args):
        rows = args[-1]
        if any(r["name"] == target for r in rows):
            raise OSError(errno.EIO, f"injected read error at {target}")
        return orig(self, *args)

    monkeypatch.setattr(module.FileIdentifierJob, "_gather_rows", gather)


def test_a_transient_slice_error_pauses_the_job_like_jax(tree, pinned_pages, tmp_path):
    pinned_pages.delenv("SD_CHUNK_MANIFESTS")
    # queues deep enough that the JAX executor never drops a queued page to
    # forward the failure (the fake-spec test above holds the port there)
    pinned_pages.setenv("SD_PIPELINE_DEPTH", "8")
    pinned_pages.setenv("SD_SCAN_SHARDS", "2")
    pinned_pages.setenv("SD_COMMIT_GROUP", "4")
    pinned_pages.setattr(executor, "GROUP_LINGER_S", 60.0)
    poison_gather(pinned_pages, fi, "f99")
    poison_gather(pinned_pages, jax_fi, "f99")
    jax_rows, jax_status, pages = jax_scan(tmp_path / "jax", tree)
    node = Node(tmp_path / "port", device="cpu")
    try:
        lib = node.libraries.create("port")
        loc = create_location(lib, tree)
        scan_location(lib, loc["id"])
        assert node.jobs.wait_idle(120)
        jobs = {r["name"]: r for r in lib.db.query("SELECT * FROM job")}
        port_rows = rows_of(lib.db)
    finally:
        node.shutdown()
    jax_cas_pages = {pages[(r[0], r[1])] for r in jax_rows[0] if r[4]}
    cas_pages = {pages[(r[0], r[1])] for r in port_rows[0] if r[4]}
    assert jax_status == JaxJobStatus.PAUSED
    assert jobs["file_identifier"]["status"] == JobStatus.PAUSED
    assert "injected read error" in jobs["file_identifier"]["errors_text"]
    assert port_rows == jax_rows
    # exactly the pages before the poisoned one hold cas_ids
    poisoned = pages[("/d3/", "f99")]
    assert poisoned >= 2 and cas_pages == jax_cas_pages == set(range(poisoned))


def test_a_hasher_error_fails_the_job_with_no_cpu_redispatch(tree, pinned_pages, tmp_path):
    pinned_pages.delenv("SD_CHUNK_MANIFESTS")
    pinned_pages.setenv("SD_SCAN_SHARDS", "2")
    node = Node(tmp_path / "port", device="cpu")
    calls = []
    orig = node.hasher.hash_gathered

    def hash_gathered(messages):
        calls.append((threading.current_thread().name, len(messages)))
        if len(calls) == 3:
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return orig(messages)

    node.hasher.hash_gathered = hash_gathered
    try:
        lib = node.libraries.create("port")
        loc = create_location(lib, tree)
        scan_location(lib, loc["id"])
        assert node.jobs.wait_idle(120)
        job = lib.db.query("SELECT * FROM job WHERE name = 'file_identifier'")[0]
        hashed = lib.db.query("SELECT COUNT(*) AS n FROM file_path WHERE cas_id IS NOT NULL")
    finally:
        node.shutdown()
    assert job["status"] == JobStatus.FAILED
    assert "illegal memory access" in job["errors_text"]
    assert len(calls) == 3 and {name for name, _ in calls} == {"pipeline-dispatch"}
    # two pages committed; the failed page's files got no cas_id from anywhere
    assert hashed[0]["n"] == sum(n for _, n in calls[:2])


# -- the WAL reader ----------------------------------------------------------


def test_reader_routing_sees_committed_snapshot_off_the_owner(tmp_path):
    db = db_with_table(tmp_path / "r.db")
    db.execute("INSERT INTO page (n) VALUES (1)")
    seen: dict = {}
    entered, checked = threading.Event(), threading.Event()

    def other():
        entered.wait(5)
        seen["other"] = [r["n"] for r in db.query("SELECT n FROM page ORDER BY n")]
        checked.set()

    t = threading.Thread(target=other)
    t.start()
    with db.transaction():
        db.execute("INSERT INTO page (n) VALUES (2)")
        seen["owner"] = [r["n"] for r in db.query("SELECT n FROM page ORDER BY n")]
        entered.set()
        # the other thread's read does not wait on the open transaction
        assert checked.wait(5)
    t.join(5)
    assert seen == {"owner": [1, 2], "other": [1]}
    assert [r["n"] for r in db.query("SELECT n FROM page ORDER BY n")] == [1, 2]
    with pytest.raises(sqlite3.OperationalError, match="readonly"):
        db.query("DELETE FROM page")
    db.close()
    with pytest.raises(sqlite3.ProgrammingError):
        db.query("SELECT 1")


def test_memory_database_reads_through_the_writer():
    db = Database(":memory:", ALL_MODELS)
    db.execute("CREATE TABLE page (n INTEGER PRIMARY KEY)")
    db.execute("INSERT INTO page (n) VALUES (7)")
    out = {}
    t = threading.Thread(target=lambda: out.update(rows=db.query("SELECT n FROM page")))
    t.start()
    t.join(5)
    assert [r["n"] for r in out["rows"]] == [7]
    assert db._read_conn is None
