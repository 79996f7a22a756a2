"""The port's job control (spacedrive_tpu_torch/jobs/) against the JAX
package's, on the CPU.

Each scenario of ``tests/test_jobs.py`` (metadata merge, early finish, soft
errors, a failed init, hash dedup, pause and resume, cancel, chaining and a
failure that cancels the chain, shutdown and cold resume, an unknown job
name) runs on both packages' ``Jobs`` over a node-less library, with a toy
job of the same name in each; the job rows must agree. A pause lands where
a test holds the job (an event at one step), never on timing. The lanes:
a media-lane job runs while a default-lane job is held, capacity is per
library, and a scan's identify job warm-starts one media-lane job per
top-level directory of thumbnailable files, as the JAX Node's does; the
thumbnails and ``media_data`` rows then equal the JAX Node's as sets keyed
by cas_id. A full scan chain shut down mid-identify cold-resumes on a
second port Node to the JAX Node's rows; the ``job`` rows of a scan equal
the JAX Node's apart from ids, dates and timings, and their checkpoints
decode to the same keys.
"""

import json
import sqlite3
import threading
import time
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from spacedrive_tpu import jobs as jax_jobs
from spacedrive_tpu.config import BackendFeature
from spacedrive_tpu.library import Libraries as JaxLibraries
from spacedrive_tpu.locations import create_location as jax_create_location
from spacedrive_tpu.locations import scan_location as jax_scan_location
from spacedrive_tpu.models import JobRow as JaxJobRow
from spacedrive_tpu.node import Node as JaxNode
from spacedrive_tpu.objects.media import thumbnail as jax_thumbnail
from spacedrive_tpu_torch import jobs as port_jobs
from spacedrive_tpu_torch.library import Libraries
from spacedrive_tpu_torch.locations import create_location, scan_location
from spacedrive_tpu_torch.models import JobRow
from spacedrive_tpu_torch.node import Node
from spacedrive_tpu_torch.objects import file_identifier as fi
from tests.torch_scan_cases import make_tree, rows_of, one_torch_thread  # noqa: F401

PACKAGES = {"jax": (jax_jobs, JaxLibraries, JaxJobRow), "port": (port_jobs, Libraries, JobRow)}
EXECUTED: dict[str, list] = {"jax": [], "port": []}
#: (package, gate) -> [reached, release]
GATES: dict[tuple[str, str], list[threading.Event]] = {}


def gate(pkg: str, name: str) -> list[threading.Event]:
    return GATES.setdefault((pkg, name), [threading.Event(), threading.Event()])


def toy_jobs(pkg: str, jobs_mod):
    """The toy jobs of ``tests/test_jobs.py`` for one package: ``hold_at``
    holds a step until the test releases its gate."""

    class Toy(jobs_mod.StatefulJob):
        NAME = "torch_jobs_toy"

        def init(self, ctx):
            n = self.init_args.get("steps", 3)
            if n == 0:
                raise jobs_mod.EarlyFinish("nothing to do")
            return {"tag": self.init_args.get("tag", "t")}, list(range(n)), {"inited": 1}

        def execute_step(self, ctx, data, step, step_number):
            EXECUTED[pkg].append((data["tag"], step))
            if self.init_args.get("hold_at") == step:
                reached, release = gate(pkg, self.init_args["gate"])
                reached.set()
                assert release.wait(30)
            if self.init_args.get("fail_on") == step:
                return jobs_mod.StepResult(metadata={"done": 1}, errors=[f"boom at {step}"])
            if self.init_args.get("fatal_on") == step:
                raise RuntimeError("fatal")
            return jobs_mod.StepResult(metadata={"done": 1})

    class MediaToy(Toy):
        NAME = "torch_jobs_media_toy"
        LANE = "media"

    class FatalInit(jobs_mod.StatefulJob):
        NAME = "torch_jobs_fatal_init"

        def init(self, ctx):
            raise RuntimeError("init exploded")

    return Toy, MediaToy, FatalInit


TOYS = {pkg: toy_jobs(pkg, mod) for pkg, (mod, _libs, _row) in PACKAGES.items()}


@pytest.fixture(autouse=True)
def _fresh():
    for log in EXECUTED.values():
        log.clear()
    yield
    for _reached, release in GATES.values():
        release.set()
    GATES.clear()


@pytest.fixture()
def libraries(tmp_path):
    """A node-less library of each package."""
    out = {}
    for pkg, (_mod, libs_cls, _row) in PACKAGES.items():
        libs = libs_cls(tmp_path / pkg, node=None)
        out[pkg] = (libs, libs.create(f"{pkg}-lib"))
    yield out
    for libs, _lib in out.values():
        libs.close()


def row(pkg: str, lib, job_id: str) -> dict:
    """The job's row; empty while a head job's worker has not written it."""
    return lib.db.find_one(PACKAGES[pkg][2], {"id": job_id}) or {}


def summary(r: dict) -> tuple:
    """A row without its ids and dates, and without the JAX job's telemetry
    ``trace`` (not ported)."""
    meta = {k: v for k, v in (r["metadata"] or {}).items() if k != "trace"} or None
    return (r["name"], r["status"], meta, r["errors_text"], r["task_count"],
            r["completed_task_count"])


def wait_for(pred, timeout: float = 30.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def both(libraries, scenario) -> dict:
    """``scenario(pkg, jobs_module, library)`` on each package; returns
    {pkg: result}."""
    return {pkg: scenario(pkg, PACKAGES[pkg][0], libraries[pkg][1]) for pkg in PACKAGES}


@pytest.mark.parametrize("args,status", [
    ({"steps": 4, "tag": "a"}, "COMPLETED"),
    ({"steps": 0}, "COMPLETED"),
    ({"steps": 3, "fail_on": 1}, "COMPLETED_WITH_ERRORS"),
    (None, "FAILED"),
], ids=["metadata-merge", "early-finish", "soft-errors", "init-failure"])
def test_a_job_ends_as_the_reference_does(libraries, args, status):
    def scenario(pkg, mod, lib):
        Toy, _media, FatalInit = TOYS[pkg]
        jobs = mod.Jobs()
        jid = jobs.spawn(lib, [Toy(args) if args is not None else FatalInit({})])
        assert jobs.wait_idle(30)
        return summary(row(pkg, lib, jid)), list(EXECUTED[pkg])

    got = both(libraries, scenario)
    assert got["port"] == got["jax"]
    assert got["port"][0][1] == getattr(port_jobs.JobStatus, status)
    if args == {"steps": 4, "tag": "a"}:
        assert got["port"][0][2] == {"inited": 1, "done": 4}


def test_dedup_rejects_the_same_hash_and_queues_another(libraries):
    def scenario(pkg, mod, lib):
        Toy = TOYS[pkg][0]
        jobs = mod.Jobs()
        args = {"steps": 3, "tag": "d", "hold_at": 0, "gate": "d"}
        held = jobs.spawn(lib, [Toy(args)])
        assert gate(pkg, "d")[0].wait(30)
        with pytest.raises(mod.JobAlreadyRunning):
            jobs.spawn(lib, [Toy(dict(args))])
        other = jobs.spawn(lib, [Toy({"steps": 1, "tag": "other"})])
        queued = row(pkg, lib, other)["status"]
        gate(pkg, "d")[1].set()
        assert jobs.wait_idle(30)
        return queued, summary(row(pkg, lib, held)), summary(row(pkg, lib, other))

    got = both(libraries, scenario)
    assert got["port"] == got["jax"]
    assert got["port"][0] == port_jobs.JobStatus.QUEUED


def test_pause_checkpoints_and_resume_runs_every_step_once(libraries):
    def scenario(pkg, mod, lib):
        Toy = TOYS[pkg][0]
        jobs = mod.Jobs()
        jid = jobs.spawn(lib, [Toy({"steps": 20, "tag": "p", "hold_at": 5, "gate": "p"})])
        reached, release = gate(pkg, "p")
        assert reached.wait(30)
        assert jobs.pause(jid)
        release.set()
        assert wait_for(lambda: row(pkg, lib, jid).get("status") == mod.JobStatus.PAUSED)
        # the row says Paused before the worker leaves the running set (in
        # both packages): a resume before that is refused as a duplicate
        assert jobs.wait_idle(30)
        paused = row(pkg, lib, jid)
        at_pause = list(EXECUTED[pkg])
        checkpoint = json.loads(paused["data"])
        assert jobs.resume(lib, jid)
        assert jobs.wait_idle(30)
        return (at_pause, checkpoint["step_number"], sorted(checkpoint),
                summary(row(pkg, lib, jid)), list(EXECUTED[pkg]))

    got = both(libraries, scenario)
    assert got["port"] == got["jax"]
    at_pause, step_number, _keys, final, executed = got["port"]
    assert at_pause == [("p", s) for s in range(6)] and step_number == 6
    assert final[1] == port_jobs.JobStatus.COMPLETED
    assert executed == [("p", s) for s in range(20)]


def test_cancel_stops_at_the_next_step(libraries):
    def scenario(pkg, mod, lib):
        Toy = TOYS[pkg][0]
        jobs = mod.Jobs()
        jid = jobs.spawn(lib, [Toy({"steps": 20, "tag": "c", "hold_at": 2, "gate": "c"}),
                               Toy({"steps": 2, "tag": "never"})])
        reached, release = gate(pkg, "c")
        assert reached.wait(30)
        assert jobs.cancel(jid)
        release.set()
        assert jobs.wait_idle(30)
        child = lib.db.find(PACKAGES[pkg][2], {"parent_id": jid})[0]
        return row(pkg, lib, jid)["status"], child["status"], list(EXECUTED[pkg])

    got = both(libraries, scenario)
    assert got["port"] == got["jax"]
    assert got["port"] == (port_jobs.JobStatus.CANCELED, port_jobs.JobStatus.CANCELED,
                           [("c", 0), ("c", 1), ("c", 2)])


def test_chaining_runs_in_order_and_a_failure_cancels_the_chain(libraries):
    def scenario(pkg, mod, lib):
        Toy = TOYS[pkg][0]
        jobs = mod.Jobs()
        head = jobs.spawn(lib, [Toy({"steps": 2, "tag": "one"}), Toy({"steps": 2, "tag": "two"})])
        assert jobs.wait_idle(30)
        good = [summary(r) for r in lib.db.find(PACKAGES[pkg][2], {"parent_id": head})]
        bad = jobs.spawn(lib, [Toy({"steps": 2, "fatal_on": 0, "tag": "bad"}),
                               Toy({"steps": 2, "tag": "never"})])
        assert jobs.wait_idle(30)
        children = [r["status"] for r in lib.db.find(PACKAGES[pkg][2], {"parent_id": bad})]
        return good, row(pkg, lib, bad)["status"], children, list(EXECUTED[pkg])

    got = both(libraries, scenario)
    assert got["port"] == got["jax"]
    good, bad, children, executed = got["port"]
    assert [g[1] for g in good] == [port_jobs.JobStatus.COMPLETED]
    assert bad == port_jobs.JobStatus.FAILED and children == [port_jobs.JobStatus.CANCELED]
    assert executed == [("one", 0), ("one", 1), ("two", 0), ("two", 1), ("bad", 0)]


def test_shutdown_checkpoints_then_cold_resume_finishes_the_chain(libraries):
    def scenario(pkg, mod, lib):
        Toy = TOYS[pkg][0]
        jobs = mod.Jobs()
        jid = jobs.spawn(lib, [Toy({"steps": 10, "tag": "s", "hold_at": 3, "gate": "s"}),
                               Toy({"steps": 2, "tag": "s2"})])
        reached, release = gate(pkg, "s")
        assert reached.wait(30)
        worker = jobs._running[jid]

        def release_after_the_command():
            assert wait_for(lambda: not worker._commands.empty())
            release.set()

        threading.Thread(target=release_after_the_command).start()
        jobs.shutdown()
        paused = [r["status"] for r in lib.db.query(
            "SELECT status FROM job ORDER BY date_created")]
        at_shutdown = list(EXECUTED[pkg])
        jobs2 = mod.Jobs()  # a new process
        revived = jobs2.cold_resume(lib)
        assert jobs2.wait_idle(30)
        final = [r["status"] for r in lib.db.query("SELECT status FROM job ORDER BY date_created")]
        return paused, at_shutdown, revived, final, list(EXECUTED[pkg])

    got = both(libraries, scenario)
    assert got["port"] == got["jax"]
    paused, at_shutdown, revived, final, executed = got["port"]
    assert paused == [port_jobs.JobStatus.PAUSED] * 2 and revived == 1
    assert at_shutdown == [("s", s) for s in range(4)]
    assert final == [port_jobs.JobStatus.COMPLETED] * 2
    assert executed == [("s", s) for s in range(10)] + [("s2", 0), ("s2", 1)]


def test_cold_resume_fails_an_unknown_job_loudly(libraries):
    def scenario(pkg, mod, lib):
        report = mod.JobReport.new("does_not_exist")
        report.status = mod.JobStatus.PAUSED
        report.data = b'{"bad": "state"}'
        report.errors_text = "an earlier soft error"
        report.create(lib.db)
        revived = mod.Jobs().cold_resume(lib)
        r = row(pkg, lib, report.id)
        return revived, r["status"], r["errors_text"]

    got = both(libraries, scenario)
    assert got["port"] == got["jax"]
    assert got["port"][:2] == (0, port_jobs.JobStatus.FAILED)
    assert got["port"][2].startswith("an earlier soft error\n\ncold resume failed")


# -- lanes ---------------------------------------------------------------------


def test_a_media_lane_job_runs_while_the_default_lane_is_held(libraries):
    def scenario(pkg, mod, lib):
        Toy, MediaToy, _fatal = TOYS[pkg]
        jobs = mod.Jobs()
        held = jobs.spawn(lib, [Toy({"steps": 2, "tag": "scan", "hold_at": 0, "gate": "l"})])
        reached, release = gate(pkg, "l")
        assert reached.wait(30)
        media = jobs.spawn(lib, [MediaToy({"steps": 3, "tag": "media"})])
        ran = wait_for(lambda: row(pkg, lib, media).get("status") == mod.JobStatus.COMPLETED)
        still_held = row(pkg, lib, held)["status"]
        release.set()
        assert jobs.wait_idle(30)
        return ran, still_held, row(pkg, lib, held)["status"]

    got = both(libraries, scenario)
    assert got["port"] == got["jax"]
    assert got["port"] == (True, port_jobs.JobStatus.RUNNING, port_jobs.JobStatus.COMPLETED)


def test_lane_capacity_is_per_library(tmp_path):
    def scenario(pkg):
        mod, libs_cls, _row = PACKAGES[pkg]
        Toy = TOYS[pkg][0]
        libs = libs_cls(tmp_path / pkg, node=None)
        a, b = libs.create("a"), libs.create("b")
        try:
            jobs = mod.Jobs()
            jobs.spawn(a, [Toy({"steps": 1, "tag": "a", "hold_at": 0, "gate": "a"})])
            jobs.spawn(b, [Toy({"steps": 1, "tag": "b", "hold_at": 0, "gate": "b"})])
            both_running = gate(pkg, "a")[0].wait(30) and gate(pkg, "b")[0].wait(30)
            second = jobs.spawn(a, [Toy({"steps": 1, "tag": "a2"})])
            queued = row(pkg, a, second)["status"]
            for name in ("a", "b"):
                gate(pkg, name)[1].set()
            assert jobs.wait_idle(30)
            return both_running, queued, row(pkg, a, second)["status"]
        finally:
            libs.close()

    assert scenario("port") == scenario("jax") == (
        True, port_jobs.JobStatus.QUEUED, port_jobs.JobStatus.COMPLETED)


# -- scans on both Nodes -----------------------------------------------------------


def photo_tree(root: Path) -> Path:
    """Small PNGs in three top-level directories (one nested), one at the
    root, a corrupt .jpg and a text file."""
    rng = np.random.default_rng(5)
    for i, rel in enumerate(["a/p0.png", "a/p1.png", "b/c/p2.png", "b/p3.png", "d/p4.png",
                             "p5.png"]):
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        h, w = 40 + 8 * i, 64 + 4 * i
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(path)
    (root / "d" / "bad.jpg").write_bytes(rng.bytes(3000))
    (root / "a" / "notes.txt").write_bytes(b"not an image\n")
    return root


def media_state(node, lib) -> dict:
    db = lib.db
    rows = {r["cas_id"]: (r["dimensions"], r["media_date"], r["camera_data"]) for r in db.query(
        "SELECT fp.cas_id, md.dimensions, md.media_date, md.camera_data FROM media_data md "
        "JOIN file_path fp ON fp.object_id = md.object_id")}
    warm = sorted(json.loads(r["data"])["init_args"]["sub_path"] for r in db.query(
        "SELECT data FROM job WHERE action = 'media_warm_start'"))
    return {"thumbs": {p.stem for p in Path(node.data_dir).glob("thumbnails/*/*.webp")},
            "rows": rows, "warm": warm,
            "jobs": sorted((r["name"], r["status"]) for r in db.query(
                "SELECT name, status FROM job WHERE action IS NULL OR action != "
                "'media_warm_start'"))}


def test_warm_start_media_lane_matches_the_jax_node(tmp_path, monkeypatch):
    tree = photo_tree(tmp_path / "tree")
    monkeypatch.setenv("SD_P2P_DISABLED", "1")
    monkeypatch.setitem(jax_thumbnail._DEVICE_VERDICT, "value", True)
    jnode = JaxNode(tmp_path / "jax", probe_accelerator=False, watch_locations=False)
    try:
        features = jnode.config.get().get("features", [])
        jnode.config.write(features=[*features, BackendFeature.TPU_THUMBNAILS])
        jlib = jnode.libraries.create("jax")
        jax_scan_location(jlib, jax_create_location(jlib, tree)["id"])
        assert jnode.jobs.wait_idle(120)
        want = media_state(jnode, jlib)
    finally:
        jnode.shutdown()
    node = Node(tmp_path / "port", device="cpu", watch_locations=False)
    try:
        lib = node.libraries.create("port")
        scan_location(lib, create_location(lib, tree)["id"])
        assert node.jobs.wait_idle(120)
        got = media_state(node, lib)
    finally:
        node.shutdown()
    assert got["warm"] == want["warm"] == ["a", "b", "d"]  # one job a prefix, none for the root
    assert got == want
    assert len(got["thumbs"]) == 6 and len(got["rows"]) == 6


#: metadata keys that are timings, or that one package alone writes: the
#: JAX job's telemetry ``trace`` and its CPU re-dispatch count (the port has
#: neither), and the JAX indexer's walk statistics
TIMING_OR_ONE_SIDED = {"trace", "recovered_batches", "hash_time", "media_time",
                       "scan_read_time", "db_write_time"}


def job_rows(db) -> list:
    out = []
    for r in db.query("SELECT * FROM job ORDER BY date_created"):
        meta = {k: v for k, v in json.loads(r["metadata"] or "{}").items()
                if not k.endswith("_s") and k not in TIMING_OR_ONE_SIDED}
        state = json.loads(r["data"]) if r["data"] else {}
        out.append({"name": r["name"], "action": r["action"], "status": r["status"],
                    "errors_text": r["errors_text"], "task_count": r["task_count"],
                    "completed_task_count": r["completed_task_count"],
                    "is_child": r["parent_id"] is not None, "metadata": meta,
                    "state_keys": sorted(state), "data_keys": sorted(state.get("data") or {}),
                    "step_number": state.get("step_number")})
    return out


def scan_tree(tmp_path_factory):
    root = make_tree(tmp_path_factory.mktemp("jobs") / "tree")
    for d in range(2):
        (root / f"d{d}" / "nested").mkdir()
        (root / f"d{d}" / "nested" / "n.txt").write_bytes(b"nested %d" % d)
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return scan_tree(tmp_path_factory)


@pytest.fixture(scope="module")
def jax_scan(tree, tmp_path_factory):
    """The JAX Node's rows and job rows of one uninterrupted scan."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SD_P2P_DISABLED", "1")
        node = JaxNode(tmp_path_factory.mktemp("jaxscan"), probe_accelerator=False,
                       watch_locations=False)
        try:
            lib = node.libraries.create("jax")
            jax_scan_location(lib, jax_create_location(lib, tree)["id"])
            assert node.jobs.wait_idle(120)
            return rows_of(lib.db), job_rows(lib.db)
        finally:
            node.shutdown()


def test_job_rows_of_a_scan_equal_the_jax_nodes(tree, jax_scan, tmp_path):
    node = Node(tmp_path / "port", device="cpu", watch_locations=False)
    try:
        lib = node.libraries.create("port")
        scan_location(lib, create_location(lib, tree)["id"])
        assert node.jobs.wait_idle(120)
        rows, jobs = rows_of(lib.db), job_rows(lib.db)
    finally:
        node.shutdown()
    assert rows == jax_scan[0]
    chain = [j["name"] for j in jobs if j["action"] != "media_warm_start"]
    assert chain == ["indexer", "file_identifier", "media_processor", "dedup_detector"]
    assert jobs == jax_scan[1]


def test_a_scan_chain_shut_down_mid_identify_cold_resumes_on_a_new_node(tree, jax_scan,
                                                                        tmp_path, monkeypatch):
    monkeypatch.setattr(fi, "BATCH_SIZE", 16)
    monkeypatch.setenv("SD_COMMIT_GROUP", "1")
    monkeypatch.setenv("SD_SCAN_SHARDS", "1")
    reached, release = threading.Event(), threading.Event()
    calls = []
    real = fi.read_sampled_batch

    def held_gather(paths, sizes):
        calls.append(len(paths))
        if len(calls) == 3:  # two pages committed (or on their way)
            reached.set()
            assert release.wait(30)
        return real(paths, sizes)

    monkeypatch.setattr(fi, "read_sampled_batch", held_gather)
    data_dir = tmp_path / "port"
    node = Node(data_dir, device="cpu", watch_locations=False)
    lib = node.libraries.create("port")
    lib_id = lib.id
    loc_id = create_location(lib, tree)["id"]
    assert node.locations.online_ids(lib_id) == [loc_id]
    scan_location(lib, loc_id)
    assert reached.wait(60)
    identify = lib.db.find_one(JobRow, {"name": "file_identifier"})
    # the pages before the held gather commit and checkpoint
    assert wait_for(lambda: json.loads(lib.db.find_one(
        JobRow, {"name": "file_identifier"})["data"])["step_number"] >= 1)
    worker = node.jobs._running[identify["id"]]
    threading.Thread(target=lambda: wait_for(lambda: not worker._commands.empty())
                     and release.set()).start()
    node.shutdown()
    monkeypatch.setattr(fi, "read_sampled_batch", real)
    conn = sqlite3.connect(data_dir / "libraries" / f"{lib_id}.db")
    paused = dict(conn.execute("SELECT name, status FROM job WHERE action LIKE 'scan%'"))
    checkpoint = json.loads(conn.execute(
        "SELECT data FROM job WHERE name = 'file_identifier'").fetchone()[0])
    conn.close()
    assert paused == {"indexer": port_jobs.JobStatus.COMPLETED,
                      **dict.fromkeys(("file_identifier", "media_processor", "dedup_detector"),
                                      port_jobs.JobStatus.PAUSED)}
    assert 0 < checkpoint["step_number"] < len(checkpoint["steps"]) == 6
    assert checkpoint["data"]["cursor"] > 0

    node2 = Node(data_dir, device="cpu", watch_locations=False)  # cold resume at boot
    try:
        lib2 = node2.libraries.get(lib_id)
        assert node2.locations.is_online(lib_id, loc_id)  # marked at boot
        assert node2.jobs.wait_idle(120)
        rows = rows_of(lib2.db)
        statuses = {r["name"]: r["status"] for r in lib2.db.query(
            "SELECT * FROM job WHERE action LIKE 'scan%'")}
    finally:
        node2.shutdown()
    assert rows == jax_scan[0]
    assert statuses == {"indexer": port_jobs.JobStatus.COMPLETED,
                        "file_identifier": port_jobs.JobStatus.COMPLETED,
                        "media_processor": port_jobs.JobStatus.COMPLETED_WITH_ERRORS,
                        "dedup_detector": port_jobs.JobStatus.COMPLETED}


def test_counters_bumped_from_many_threads_lose_no_count():
    """The launch counters and the media job's counters are bumped from
    several threads at once (a scan's dispatch thread beside a media-lane
    job): more threads than cores, a short switch interval, every count
    kept."""
    import collections
    import os
    import sys

    from spacedrive_tpu_torch.ops import _kernels

    counter: collections.Counter = collections.Counter()
    n_threads, rounds = 2 * (os.cpu_count() or 1) + 2, 2000

    def bump(k: int) -> None:
        for i in range(rounds):
            _kernels.count(counter, i % 3)
            _kernels.count(counter, ("thread", k % 2), 2)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert sum(counter[i] for i in range(3)) == n_threads * rounds
    assert counter[("thread", 0)] + counter[("thread", 1)] == 2 * n_threads * rounds
