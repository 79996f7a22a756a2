"""The port's reader pool (``spacedrive_tpu_torch/server/pool.py``) on the
CPU, case for case with ``tests/test_serving_pool.py``: byte identity with
the in-process answer (typed errors included), the spliced wire bytes,
watermark invalidation under live CRDT ingest and under a live pipelined
scan, a worker's SIGKILL with failover and respawn, the gate
``SD_SERVE_WORKERS=0``, the shell owning the pool, and a restore advancing
the reader epoch. The reference's ``test_request_stats_folds_pool_state``
reads telemetry (``telemetry.requestStats``), which the port has not yet:
it is left out, and ``pool.STATS`` / ``status()`` stand in for the
families. Then the port's pool pages are held byte-equal to a JAX
``ReaderPool``'s for every pool-marked procedure, on two libraries that
ingested the same operations.

The port's workers are forked from a forkserver (the pool's docstring says
why); the first pool a process starts pays the server's start, a few
seconds, once.
"""

import json
import os
import signal
import threading
import time

import pytest

from spacedrive_tpu_torch.api.router import ApiError, RawJson, last_rung
from spacedrive_tpu_torch.models import FilePath, Location
from spacedrive_tpu_torch.node import Node
from spacedrive_tpu_torch.server import pool as pool_mod
from spacedrive_tpu_torch.server.pool import ReaderPool, configured_workers
from tests.torch_scan_cases import one_torch_thread  # noqa: F401


def _canon(value) -> str:
    return json.dumps(value, sort_keys=True, default=str)


def _hlc(unix: float) -> int:
    sec = int(unix)
    frac = int((unix - sec) * (1 << 32))
    return (sec << 32) | (frac & 0xFFFFFFFF)


@pytest.fixture()
def node(tmp_path, monkeypatch):
    monkeypatch.setenv("SD_P2P_DISABLED", "1")
    monkeypatch.setenv("SD_SERVE_HEALTH_S", "0.3")
    n = Node(tmp_path / "data", device="cpu", watch_locations=False)
    yield n
    n.shutdown()  # stops a pool still attached


def _seed_library(node, n_files=80):
    lib = node.libraries.create("pool")
    loc_id = lib.db.insert(Location, {
        "pub_id": "loc-pool", "name": "pool", "path": "/nonexistent",
        "instance_id": lib.instance_id})
    lib.db.insert_many(FilePath, [
        {"pub_id": f"fp-{i:04d}", "location_id": loc_id,
         "materialized_path": "/" if i % 3 else "/sub/",
         "name": f"f{i:04d}", "extension": "dat", "is_dir": 0,
         "size_in_bytes": i * 10} for i in range(n_files)])
    return lib, loc_id


def _start_pool(node, workers=2) -> ReaderPool:
    pool = ReaderPool(node, workers=workers).start()
    node.reader_pool = pool
    return pool


def test_pool_results_byte_identical_to_in_process(node):
    lib, loc_id = _seed_library(node)
    pool = _start_pool(node)
    cases = [
        ("search.paths", {"take": 50}),
        ("search.paths", {"materialized_path": "/sub/", "dirs_first": True, "take": 200}),
        ("search.paths", {"search": "f00", "take": 64}),
        ("search.pathsCount", {"location_id": loc_id}),
        ("search.pathsCount", None),
        ("search.objects", {}),
        ("search.objectsCount", None),
        ("search.duplicates", {}),
        ("tags.list", None),
        ("categories.list", None),
        ("nodes.listLocations", None),
        ("locations.get", loc_id),
        ("files.get", {"file_path_id": 1}),
    ]
    for key, arg in cases:
        via_pool = node.router.resolve(key, arg, lib.id)
        assert last_rung() == "pool", key
        pool.set_enabled(False)
        in_proc = node.router.resolve(key, arg, lib.id)
        assert last_rung() == "in_process", key
        pool.set_enabled(True)
        assert _canon(via_pool) == _canon(in_proc), key
    # libraries.statistics: equal but for the two live-volume fields,
    # which the OS may move between the calls
    via_pool = node.router.resolve("libraries.statistics", None, lib.id)
    pool.set_enabled(False)
    in_proc = node.router.resolve("libraries.statistics", None, lib.id)
    pool.set_enabled(True)
    assert via_pool.keys() == in_proc.keys()
    volatile = {"total_bytes_free", "total_bytes_capacity"}
    assert _canon({k: v for k, v in via_pool.items() if k not in volatile}) \
        == _canon({k: v for k, v in in_proc.items() if k not in volatile})
    assert pool.status()["cache_misses"] > len(cases)
    # typed-error parity: the worker's ApiError is the in-process one
    with pytest.raises(ApiError) as pool_err:
        node.router.resolve("locations.get", 999_999, lib.id)
    pool.set_enabled(False)
    with pytest.raises(ApiError) as in_err:
        node.router.resolve("locations.get", 999_999, lib.id)
    assert str(pool_err.value) == str(in_err.value)
    assert pool_err.value.code == in_err.value.code == 404


def test_preferences_get_pool_byte_identical(node):
    lib, _loc_id = _seed_library(node)
    node.router.resolve("preferences.update", {
        "ui": {"theme": "dark", "density": 3},
        "explorer": {"sort": "name", "show_hidden": True},
        "flat": "value",
    }, lib.id)
    pool = _start_pool(node)
    via_pool = node.router.resolve("preferences.get", None, lib.id)
    pool.set_enabled(False)
    in_proc = node.router.resolve("preferences.get", None, lib.id)
    pool.set_enabled(True)
    assert via_pool["ui"]["theme"] == "dark"
    assert _canon(via_pool) == _canon(in_proc)
    assert pool.status()["cache_misses"] > 0


def test_chunk_duplicates_pool_byte_identical(node):
    lib, _loc_id = _seed_library(node)
    from spacedrive_tpu_torch.models import ChunkManifest, Object

    with lib.db.transaction():
        oids = [lib.db.insert(Object, {"pub_id": f"ob-{i}", "kind": 0}) for i in range(3)]
        rows = []
        for i, oid in enumerate(oids):
            rows.append({"object_id": oid, "seq": 0, "chunk_hash": "aa" * 16, "length": 4096})
            rows.append({"object_id": oid, "seq": 1, "chunk_hash": f"{i:02x}" * 16,
                         "length": 100})
        lib.db.insert_many(ChunkManifest, rows)
    pool = _start_pool(node)
    via_pool = node.router.resolve("search.chunkDuplicates", {}, lib.id)
    pool.set_enabled(False)
    in_proc = node.router.resolve("search.chunkDuplicates", {}, lib.id)
    pool.set_enabled(True)
    assert via_pool and via_pool[0]["objects"] == 3
    assert via_pool[0]["duplicated_bytes"] == 2 * 4096
    assert _canon(via_pool) == _canon(in_proc)


def test_pool_preencoded_wire_bytes_byte_identical(node):
    from spacedrive_tpu_torch.server.http import Response

    lib, loc_id = _seed_library(node)
    pool = _start_pool(node)
    cases = [
        ("search.paths", {"take": 50}),
        ("search.paths", {"materialized_path": "/sub/", "dirs_first": True, "take": 200}),
        ("search.paths", {"search": "f00", "take": 64}),
        ("search.pathsCount", {"location_id": loc_id}),
    ]
    for key, arg in cases:
        raw = node.router.resolve(key, arg, lib.id, raw=True)
        assert isinstance(raw, RawJson), key
        spliced = b'{"result": ' + raw.data + b"}"
        pool.set_enabled(False)
        in_proc = node.router.resolve(key, arg, lib.id, raw=True)
        pool.set_enabled(True)
        assert not isinstance(in_proc, RawJson), key
        assert spliced == Response.json({"result": in_proc}).body, key
    # a cache hit replays the same bytes
    first = node.router.resolve("search.paths", {"take": 50}, lib.id, raw=True)
    again = node.router.resolve("search.paths", {"take": 50}, lib.id, raw=True)
    assert isinstance(first, RawJson) and again.data == first.data
    assert pool.status()["cache_hits"] >= 1
    decoded = node.router.resolve("search.paths", {"take": 50}, lib.id)
    assert not isinstance(decoded, RawJson)
    pool.set_enabled(False)
    assert _canon(decoded) == _canon(node.router.resolve("search.paths", {"take": 50}, lib.id))


def test_ingest_invalidation_never_serves_pre_watermark_rows(node):
    """A read after a CRDT ingest at watermark W never returns rows from
    before W, while concurrent reads keep the workers' pages cached."""
    from spacedrive_tpu_torch.sync.ingest import Ingester

    lib, _loc = _seed_library(node, n_files=10)
    pool = _start_pool(node)
    ingester = Ingester(lib)
    stop = threading.Event()
    reader_errors: list[str] = []

    def hammer():
        while not stop.is_set():
            try:
                node.router.resolve("tags.list", None, lib.id)
            except Exception as e:  # noqa: BLE001 — surfaced below
                reader_errors.append(repr(e))
                return

    threads = [threading.Thread(target=hammer, daemon=True) for _ in range(2)]
    for t in threads:
        t.start()
    base = time.time() - 200.0  # inside the HLC drift bound
    try:
        for i in range(24):
            ingester.receive([{
                "instance": "pool-peer", "timestamp": _hlc(base + i * 0.01),
                "id": f"pool-op-{i:04d}",
                "typ": {"_t": "shared", "model": "tag", "record_id": f"pool-tag-{i:04d}",
                        "kind": "c", "data": {"name": f"t{i:04d}"}}}])
            names = {t["name"] for t in node.router.resolve("tags.list", None, lib.id)}
            assert f"t{i:04d}" in names, f"stale read after ingest {i}"
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    assert not reader_errors, reader_errors[:3]
    status = pool.status()
    assert status["cache_hits"] > 0
    assert status["restarts"] == 0


def test_scan_commit_invalidation_and_convergence(node, tmp_path, monkeypatch):
    """A pipelined identify scan runs while pool reads hammer the library;
    once it is idle the pool serves the post-scan state exactly."""
    from spacedrive_tpu_torch.locations import create_location
    from spacedrive_tpu_torch.locations.indexer_job import IndexerJob
    from spacedrive_tpu_torch.objects import file_identifier as fi
    from spacedrive_tpu_torch.objects.file_identifier import FileIdentifierJob

    monkeypatch.setenv("SD_PIPELINE", "1")
    monkeypatch.setattr(fi, "BATCH_SIZE", 32)
    tree = tmp_path / "tree"
    tree.mkdir()
    for i in range(120):
        (tree / f"g{i:03d}.dat").write_bytes(bytes([i % 251]) * (100 + i))
    lib = node.libraries.create("scanpool")
    loc = create_location(lib, str(tree))
    node.jobs.spawn(lib, [IndexerJob({"location_id": loc["id"]})])
    assert node.jobs.wait_idle(120)
    pool = _start_pool(node)
    stop = threading.Event()
    errors: list[str] = []

    def hammer():
        while not stop.is_set():
            try:
                node.router.resolve("search.pathsCount", {"location_id": loc["id"]}, lib.id)
                node.router.resolve("search.paths", {"take": 40}, lib.id)
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))
                return

    threads = [threading.Thread(target=hammer, daemon=True) for _ in range(3)]
    for t in threads:
        t.start()
    node.jobs.spawn(lib, [FileIdentifierJob({"location_id": loc["id"]})])
    assert node.jobs.wait_idle(180)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    assert not errors, errors[:3]
    via_pool = node.router.resolve("search.paths", {"take": 500}, lib.id)
    assert last_rung() == "pool"
    pool.set_enabled(False)
    in_proc = node.router.resolve("search.paths", {"take": 500}, lib.id)
    pool.set_enabled(True)
    assert _canon(via_pool) == _canon(in_proc)
    assert all(item["cas_id"] for item in via_pool["items"] if not item["is_dir"])


def test_worker_sigkill_failover_and_recovery(node):
    """A SIGKILL of a worker under load drops no request and corrupts no
    answer, and the pool is whole again within a few health intervals."""
    lib, loc_id = _seed_library(node)
    pool = _start_pool(node, workers=2)
    pool_mod.reset_counts()
    expected = _canon(node.router.resolve("search.paths", {"take": 7}, lib.id))
    stop = threading.Event()
    errors: list[str] = []

    def traffic():
        while not stop.is_set():
            try:
                got = node.router.resolve("search.paths", {"take": 7}, lib.id)
                if _canon(got) != expected:
                    errors.append("response drift")
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))

    threads = [threading.Thread(target=traffic, daemon=True) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    victim = next(w for w in pool._slots if w is not None)
    os.kill(victim.proc.pid, signal.SIGKILL)
    deadline = time.monotonic() + 5 * pool.health_s + 2.0
    while time.monotonic() < deadline:
        st = pool.status()
        if st["alive"] == 2 and st["restarts"] >= 1:
            break
        time.sleep(0.05)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    st = pool.status()
    assert st["alive"] == 2, st
    assert st["restarts"] >= 1, st
    assert victim.proc.pid not in pool.worker_pids()
    assert not errors, errors[:3]
    assert sum(v for k, v in pool_mod.STATS.items() if k.startswith("restarts_")) >= 1
    assert node.router.resolve("search.pathsCount", {"location_id": loc_id}, lib.id) == 80


def test_degraded_mode_and_env_gate(node, monkeypatch):
    lib, loc_id = _seed_library(node, n_files=5)
    monkeypatch.setenv("SD_SERVE_WORKERS", "0")
    assert configured_workers() == 0
    assert ReaderPool.maybe_start(node) is None
    assert node.reader_pool is None
    assert node.router.resolve("search.pathsCount", {"location_id": loc_id}, lib.id) == 5
    assert last_rung() == "in_process"
    monkeypatch.setenv("SD_SERVE_WORKERS", "3")
    assert configured_workers() == 3


def test_shell_owns_pool_lifecycle(node, monkeypatch):
    from spacedrive_tpu_torch.server import Server

    monkeypatch.setenv("SD_SERVE_WORKERS", "1")
    srv = Server(node, port=0)
    srv.start()
    try:
        # the bind does not wait for the pool: it comes up after it
        assert srv.wait_pool() is node.reader_pool is not None
        assert node.reader_pool.status()["alive"] == 1
    finally:
        srv.stop()
    assert node.reader_pool is None
    monkeypatch.setenv("SD_SERVE_WORKERS", "0")
    srv2 = Server(node, port=0)
    srv2.start()
    try:
        assert node.reader_pool is None
    finally:
        srv2.stop()


def test_shell_pool_start_after_the_bind(node, monkeypatch):
    """A server stopped while its pool starts leaves no pool and no worker;
    a pool that cannot start raises from ``wait_pool`` and the ladder
    serves in process."""
    from spacedrive_tpu_torch.server import Server

    lib, loc_id = _seed_library(node, n_files=5)
    monkeypatch.setenv("SD_SERVE_WORKERS", "1")
    started: list = []
    real_start = ReaderPool.start

    def slow_start(self):
        time.sleep(0.3)  # the server stops meanwhile
        started.append(real_start(self))
        return started[-1]

    monkeypatch.setattr(ReaderPool, "start", slow_start)
    srv = Server(node, port=0)
    srv.start()
    srv.stop()
    assert node.reader_pool is None and len(started) == 1
    assert started[0].status()["running"] is False and started[0].worker_pids() == []

    def broken_start(self):
        raise OSError("no forkserver here")

    monkeypatch.setattr(ReaderPool, "start", broken_start)
    srv = Server(node, port=0)
    srv.start()
    try:
        with pytest.raises(OSError, match="no forkserver"):
            srv.wait_pool()
        assert node.reader_pool is None
        assert node.router.resolve("search.pathsCount", {"location_id": loc_id}, lib.id) == 5
        assert last_rung() == "in_process"
    finally:
        srv.stop()


def test_restore_advances_reader_epoch(node):
    """A restore swaps the database file: ``library.reload`` advances the
    reader epoch and the worker reopens before its next read."""
    from spacedrive_tpu_torch import backups
    from spacedrive_tpu_torch.models import Tag

    lib, _loc = _seed_library(node, n_files=3)
    lib.db.insert(Tag, {"pub_id": "t-base", "name": "base"})
    backup_id = backups.do_backup(node, lib.id)
    pool = _start_pool(node)

    def pool_tags():
        return {t["name"] for t in node.router.resolve("tags.list", None, lib.id)}

    assert pool_tags() == {"base"}  # the worker now holds the old inode
    lib.db.insert(Tag, {"pub_id": "t-post", "name": "post"})
    lib.emit("db.commit", {"source": "test"})
    assert pool_tags() == {"base", "post"}
    backups.do_restore(node, backups.backups_dir(node) / f"{backup_id}.bkp")
    assert pool_tags() == {"base"}
    assert pool.status()["restarts"] == 0  # reopened, not respawned


def _wait(pred, timeout=10.0, step=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(step)
    return pred()


def _queue_behind_a_held_worker(node, pool, lib, loc_id, hold_s: float):
    """Check the pool's only worker out for ``hold_s`` while a dispatch
    queues behind it: that dispatch's wait lands in the pool's queue-wait
    buckets. Returns the queued dispatch's answer and rung."""
    held = pool._checkout()
    out: dict = {}

    def queued():
        out["n"] = node.router.resolve("search.pathsCount", {"location_id": loc_id}, lib.id)
        out["rung"] = last_rung()

    t = threading.Thread(target=queued)
    t.start()
    time.sleep(hold_s)
    pool._checkin(held)
    t.join(10)
    return out


def test_autosizer_grows_on_queue_wait_then_shrinks_when_idle(node, monkeypatch):
    """Between ``SD_SERVE_WORKERS_MIN`` and ``_MAX`` the supervisor grows
    the pool when the windowed queue-wait p95 passes
    ``SD_SERVE_GROW_WAIT_S`` and, after ``SD_SERVE_AUTOSIZE_COOLDOWN_S``,
    shrinks it when a window's p95 falls under ``SD_SERVE_SHRINK_WAIT_S``
    (no checkout at all)."""
    for k, v in {"SD_SERVE_WORKERS_MIN": "1", "SD_SERVE_WORKERS_MAX": "2",
                 "SD_SERVE_GROW_WAIT_S": "0.05", "SD_SERVE_SHRINK_WAIT_S": "0.005",
                 "SD_SERVE_AUTOSIZE_COOLDOWN_S": "1.0", "SD_SERVE_HEALTH_S": "0.1"}.items():
        monkeypatch.setenv(k, v)
    lib, loc_id = _seed_library(node, n_files=20)
    pool = _start_pool(node, workers=1)
    pool_mod.reset_counts()
    st = pool.status()
    assert (st["workers"], st["min_workers"], st["max_workers"]) == (1, 1, 2)
    out = _queue_behind_a_held_worker(node, pool, lib, loc_id, hold_s=0.3)
    assert out == {"n": 20, "rung": "pool"}
    grown = _wait(lambda: pool.status()["workers"] == 2 and pool.status()["alive"] == 2)
    assert grown, pool.status()
    assert pool_mod.STATS["resizes_grow"] == 1 and pool.status()["resizes"] >= 1
    # both workers serve the same page
    pages = {node.router.resolve("search.pathsCount", {"location_id": loc_id}, lib.id)
             for _ in range(4)}
    assert pages == {20} and last_rung() == "pool"
    # idle windows: the top slot goes once the cooldown has passed
    assert _wait(lambda: pool.status()["workers"] == 1, timeout=10), pool.status()
    assert pool_mod.STATS["resizes_shrink"] == 1
    assert len(pool.worker_pids()) == 1
    assert node.router.resolve("search.pathsCount", {"location_id": loc_id}, lib.id) == 20


def test_autosizer_off_without_a_range(node, monkeypatch):
    """With the range closed (the default: both ends are the configured
    count) the same queue wait resizes nothing."""
    monkeypatch.setenv("SD_SERVE_HEALTH_S", "0.1")
    monkeypatch.setenv("SD_SERVE_GROW_WAIT_S", "0.05")
    lib, loc_id = _seed_library(node, n_files=20)
    pool = _start_pool(node, workers=1)
    pool_mod.reset_counts()
    assert _queue_behind_a_held_worker(node, pool, lib, loc_id, hold_s=0.3)["n"] == 20
    time.sleep(0.5)  # several supervisor ticks
    st = pool.status()
    assert (st["workers"], st["min_workers"], st["max_workers"], st["resizes"]) == (1, 1, 1, 0)
    assert not any(k.startswith("resizes_") for k in pool_mod.STATS)


def test_queue_wait_quantiles_equal_the_reference():
    """The autosizer's bucket quantile estimate is the reference's
    ``telemetry/registry.py`` one, on the same buckets."""
    import importlib

    import numpy as np

    # the package's ``registry`` name is a function: import the module
    registry = importlib.import_module("spacedrive_tpu.telemetry.registry")

    assert pool_mod.REQUEST_BUCKETS == registry.REQUEST_BUCKETS
    rng = np.random.default_rng(19)
    cases = [[0] * (len(registry.REQUEST_BUCKETS) + 1)]
    cases += [list(rng.integers(0, 50, len(registry.REQUEST_BUCKETS) + 1)) for _ in range(40)]
    cases += [[0] * 14 + [7], [3] + [0] * 14]  # all in +Inf, all in the first bucket
    for counts in cases:
        counts = [int(c) for c in counts]
        for qs in ((0.5, 0.95, 0.99), (0.95,)):
            assert pool_mod.estimate_quantiles(pool_mod.REQUEST_BUCKETS, counts, qs) == \
                registry.estimate_quantiles(registry.REQUEST_BUCKETS, counts, qs), counts


@pytest.mark.parametrize("knob", ["SD_SERVE_CACHE", "SD_SERVE_QUEUE_WAIT_S",
                                  "SD_SERVE_REQUEST_TIMEOUT_S"])
def test_pool_knobs(node, monkeypatch, knob):
    """``SD_SERVE_CACHE=0`` turns the workers' page cache off;
    ``SD_SERVE_QUEUE_WAIT_S`` bounds a checkout's wait, past which the
    query is served in process; ``SD_SERVE_REQUEST_TIMEOUT_S`` retires a
    worker that does not answer (here a stopped one) and serves in
    process."""
    lib, loc_id = _seed_library(node, n_files=20)
    arg = {"location_id": loc_id}
    if knob == "SD_SERVE_CACHE":
        monkeypatch.setenv(knob, "0")
        pool = _start_pool(node, workers=1)
        for _ in range(3):
            assert node.router.resolve("search.pathsCount", arg, lib.id) == 20
        st = pool.status()
        assert (pool.cache_size, st["cache_hits"], st["cache_misses"]) == (0, 0, 3)
    elif knob == "SD_SERVE_QUEUE_WAIT_S":
        monkeypatch.setenv(knob, "0.05")
        pool = _start_pool(node, workers=1)
        pool_mod.reset_counts()
        t0 = time.monotonic()
        out = _queue_behind_a_held_worker(node, pool, lib, loc_id, hold_s=1.0)
        assert out == {"n": 20, "rung": "in_process"}
        assert pool_mod.STATS["requests_failover"] == 1 and pool.status()["failovers"] == 1
        assert time.monotonic() - t0 < 5
    else:
        monkeypatch.setenv(knob, "0.5")
        monkeypatch.setenv("SD_SERVE_HEALTH_S", "30")  # no health ping races the dispatch
        pool = _start_pool(node, workers=1)
        pool_mod.reset_counts()
        pid = pool.worker_pids()[0]
        os.kill(pid, signal.SIGSTOP)
        try:
            t0 = time.monotonic()
            assert node.router.resolve("search.pathsCount", arg, lib.id) == 20
            assert last_rung() == "in_process" and time.monotonic() - t0 < 5
        finally:
            try:
                os.kill(pid, signal.SIGCONT)
            except ProcessLookupError:
                pass  # retired and reaped already
        assert pool_mod.STATS["restarts_timeout"] == 1
        assert _wait(lambda: pool.status()["alive"] == 1 and pid not in pool.worker_pids())
        assert node.router.resolve("search.pathsCount", arg, lib.id) == 20
        assert last_rung() == "pool"


def test_readonly_database_refuses_writes(tmp_path):
    import sqlite3

    from spacedrive_tpu_torch.models import ALL_MODELS, Database, Tag

    db = Database(tmp_path / "lib.db", ALL_MODELS)
    db.insert(Tag, {"pub_id": "t1", "name": "one"})
    ro = Database(tmp_path / "lib.db", ALL_MODELS, readonly=True)
    assert [r["name"] for r in ro.find(Tag)] == ["one"]
    for write in (lambda: ro.insert(Tag, {"pub_id": "t2", "name": "two"}),
                  lambda: ro.executemany("DELETE FROM tag WHERE id = ?", [(1,)]),
                  lambda: ro.transaction()):
        with pytest.raises(sqlite3.ProgrammingError):
            write()
    # every SELECT reads the last commit: no snapshot held between reads
    db.insert(Tag, {"pub_id": "t3", "name": "three"})
    assert {r["name"] for r in ro.find(Tag)} == {"one", "three"}
    ro.close()
    db.close()


# -- the port's pool pages against a JAX ReaderPool's ----------------------------


def _pool_cases(lib) -> list:
    """Every pool-marked procedure with arguments naming this library's
    rows (the same ids in both packages: both ingested the same ops)."""
    loc = lib.db.query("SELECT id FROM location ORDER BY id")[0]["id"]
    fp = lib.db.query("SELECT id FROM file_path WHERE is_dir = 0 ORDER BY id")[3]["id"]
    obj = lib.db.query("SELECT fp.object_id FROM file_path fp JOIN tag_on_object t ON "
                       "t.object_id = fp.object_id ORDER BY fp.id")[0]["object_id"]
    tag = lib.db.query("SELECT id FROM tag ORDER BY id")[0]["id"]
    # the ingested libraries hold no indexer rule: both answer its 404
    rule = 1
    return [
        ("search.paths", {"take": 50}),
        ("search.paths", {"search": "f0", "take": 20}),
        ("search.paths", {"materialized_path": "/d1/", "dirs_first": True, "take": 100}),
        ("search.paths", {"extensions": ["bin"], "order_by": "size_in_bytes", "take": 30}),
        ("search.pathsCount", {"location_id": loc}),
        ("search.pathsCount", None),
        ("search.objects", {}),
        ("search.objects", {"tags": [tag]}),
        ("search.objectsCount", None),
        ("search.duplicates", {}),
        ("search.chunkDuplicates", {}),
        ("search.nearDuplicates", {}),
        ("preferences.get", None),
        ("files.get", {"file_path_id": fp}),
        ("files.getPath", fp),
        ("files.getMediaData", obj),
        ("tags.list", None),
        ("tags.get", tag),
        ("tags.getForObject", obj),
        ("tags.getWithObjects", tag),
        ("locations.get", loc),
        ("locations.getWithRules", loc),
        ("locations.indexer_rules.get", rule),
        ("locations.indexer_rules.listForLocation", loc),
        ("categories.list", None),
        ("nodes.listLocations", None),
        ("libraries.statistics", None),
    ]


#: columns a library writes for itself when it is made (its default
#: indexer rules' times) and the node's disk figures: not part of the
#: ingested operations, so they differ between any two libraries
_LOCAL = {"date_created", "date_modified", "total_bytes_free", "total_bytes_capacity",
          "library_db_size", "total_bytes_used"}


def _local_blanked(key: str, page: bytes) -> bytes:
    if key not in ("locations.indexer_rules.get", "locations.getWithRules",
                   "libraries.statistics"):
        return page

    def blank(v):
        if isinstance(v, dict):
            return {k: ("<local>" if k in _LOCAL else blank(x)) for k, x in v.items()}
        if isinstance(v, list):
            return [blank(x) for x in v]
        return v

    return json.dumps(blank(json.loads(page))).encode()


def _served_and_local(node, key: str, arg, lib_id: str) -> bytes:
    """The pool's page (or its error) for one query, after holding it
    equal to the in-process answer of the same node."""
    pages = []
    for enabled in (True, False):
        node.reader_pool.set_enabled(enabled)
        try:
            served = node.router.resolve(key, arg, lib_id, raw=True)
            page = served.data if enabled else json.dumps(served, default=str).encode()
            assert enabled or not hasattr(served, "data"), key
        except Exception as e:  # noqa: BLE001 — the ApiError is the answer
            page = json.dumps({"error": str(e), "code": getattr(e, "code", None)}).encode()
        pages.append(page)
    node.reader_pool.set_enabled(True)
    if key != "libraries.statistics":  # its disk figures move between calls
        assert pages[0] == pages[1], key
    return pages[0]


def test_pool_pages_equal_a_jax_reader_pools(tmp_path, monkeypatch):
    """A port library and a JAX library ingest the same operations (a
    scanned tree, tags, a note, a favorite, preferences, from a third,
    port, library); every pool-marked procedure answers the same bytes
    through each package's pool and in each package's process."""
    from spacedrive_tpu.node import Node as JaxNode
    from spacedrive_tpu.server.pool import ReaderPool as JaxReaderPool
    from spacedrive_tpu.sync.ingest import Ingester as JaxIngester
    from spacedrive_tpu_torch import preferences as port_preferences
    from spacedrive_tpu_torch.locations import create_location, scan_location
    from spacedrive_tpu_torch.models import Object
    from spacedrive_tpu_torch.objects import tags as port_tags
    from spacedrive_tpu_torch.sync.ingest import Ingester
    from tests.torch_p2p_cases import small_tree
    from tests.torch_sync_cases import pair_libraries, synced_rows

    monkeypatch.setenv("SD_P2P_DISABLED", "1")
    monkeypatch.setenv("SD_SERVE_HEALTH_S", "0.3")
    port = Node(tmp_path / "port", device="cpu", watch_locations=False)
    jax = JaxNode(tmp_path / "jax", probe_accelerator=False, watch_locations=False)
    pools = []
    try:
        port.config.toggle_feature("syncEmitMessages")
        src = port.libraries.create("source")
        dst = {"port": port.libraries.create("dst"), "jax": jax.libraries.create("dst")}
        for lib in dst.values():
            pair_libraries(src, lib)
        tree = small_tree(tmp_path / "tree", 5, "f")
        loc = create_location(src, str(tree))
        scan_location(src, loc["id"])
        assert port.jobs.wait_idle(60)
        red = port_tags.create_tag(src, "red", "#f00")
        objs = [r["object_id"] for r in src.db.query(
            "SELECT object_id FROM file_path WHERE object_id IS NOT NULL "
            "ORDER BY materialized_path, name LIMIT 3")]
        port_tags.assign_tag(src, red["id"], objs)
        for field, value in (("note", "seen"), ("favorite", True)):
            obj = src.db.find_one(Object, {"id": objs[1]})
            src.sync.write_ops([src.sync.shared_update(Object, obj["pub_id"], field, value)],
                               lambda db, f=field, v=value: db.update(Object, {"id": objs[1]},
                                                                      {f: v}))
        port_preferences.update_preferences(src, {"explorer": {"view": "grid", "size": 3}})
        for pkg, ingester in (("port", Ingester), ("jax", JaxIngester)):
            lib = dst[pkg]
            while True:
                ops, more = src.sync.get_ops(lib.sync.timestamps(), 64)
                ingester(lib).receive(ops)
                if not more:
                    break
        assert synced_rows(dst["port"].db) == synced_rows(dst["jax"].db) != {}
        pools = [ReaderPool(port, workers=2).start(), JaxReaderPool(jax, workers=1).start()]
        port.reader_pool, jax.reader_pool = pools
        cases = _pool_cases(dst["port"])
        assert {k for k, _ in cases} == {k for k, p in port.router.procedures.items() if p.pool}
        for key, arg in cases:
            pages = {}
            for pkg, node in (("port", port), ("jax", jax)):
                pages[pkg] = _served_and_local(node, key, arg, dst[pkg].id)
            assert _local_blanked(key, pages["port"]) == _local_blanked(key, pages["jax"]), key
    finally:
        for p in pools:
            p.stop()
        port.reader_pool = jax.reader_pool = None
        port.shutdown()
        jax.shutdown()
