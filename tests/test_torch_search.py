"""The port's device search serving (spacedrive_tpu_torch/search,
api/routers/search.py) against the JAX package's, on the CPU.

- the plain PyTorch scorers equal the JAX ``*_np`` scorers (and, for a few
  needle lengths, the Pallas kernels in interpret mode) on seeded inputs;
- the port's ``ColumnarIndex`` holds the same columns as the JAX one, after
  a build and after an upsert/delete sequence;
- the port's device masks (mirror on the CPU) equal the JAX
  ``eval_mask_cpu`` over the query matrix of tests/test_search.py, overflow
  rows included, and SQLite on sizes past 2 GiB;
- the row journal buffers notes until the transaction closes, sniffs raw
  writes and floods;
- ``search.paths`` / ``search.pathsCount`` of a port Node equal those of a
  JAX Node on the same 400 rows, and the port's engine equals its own SQL
  path, never serving pre-watermark rows;
- an error in a scorer propagates out of the handler.

Every comparison is exact: the outputs are bits, ints and JSON.
"""

import json
import sqlite3
import threading

import numpy as np
import pytest
import torch

from spacedrive_tpu.models import FilePath as JaxFilePath
from spacedrive_tpu.models import Location as JaxLocation
from spacedrive_tpu.models import Object as JaxObject
from spacedrive_tpu.node import Node as JaxNode
from spacedrive_tpu.search import columnar as jax_columnar
from spacedrive_tpu.search import kernels as jax_kernels
from spacedrive_tpu_torch.api import ApiError
from spacedrive_tpu_torch.api.routers.search import paths, paths_count
from spacedrive_tpu_torch.jobs import StatefulJob, StepResult
from spacedrive_tpu_torch.models import ALL_MODELS, Database, FilePath, Location, Object
from spacedrive_tpu_torch.models.base import RowJournal
from spacedrive_tpu_torch.node import Node
from spacedrive_tpu_torch.search import columnar, kernels
from spacedrive_tpu_torch.search.engine import SearchEngine
from tests.torch_search_cases import seeded_values, value_rows
from tests.torch_scan_cases import one_torch_thread  # noqa: F401

MATRIX = [
    {"search": "file000", "take": 50},
    {"search": "FILE", "take": 20, "order_by": "size_in_bytes",
     "order_desc": True},
    {"search": "%x"},  # wildcard → SQLite fallback, still identical
    {"search": "long"},  # matches the overflow (truncated) rows
    {"extensions": [".MOV", "png"]},
    {"materialized_path": "/sub/dir/", "dirs_first": True},
    {"kinds": [1, 2]},
    {"favorite": True},
    {"include_hidden": True, "search": "weird"},
    {"date_range": ["2026-03-01T00:00:00+00:00",
                    "2026-05-30T00:00:00+00:00"]},
    {"size_range": [100, 9000]},
    {"search": "file", "skip": 10, "take": 5},
    {"search": "zzz-no-such"},
    {},
]


def canon(value) -> str:
    return json.dumps(value, sort_keys=True, default=str)


# -- kernels -----------------------------------------------------------------


NEEDLES = [b"a", b"ab", b"c.-", "ü".encode(), b"abcab" * 9 + b"abc",  # L = 48
           b"zz", b"a" * 49]


@pytest.mark.parametrize("needle", NEEDLES, ids=lambda n: f"L{len(n)}")
def test_substring_plain_matches_jax(needle):
    values = [kernels.fold(v) for v in seeded_values(64, 1)]
    values[7] = b"x" * (64 - len(needle)) + needle  # needle at the last offset
    values[8] = needle[:-1] + b"\x00"  # a prefix of the needle, then padding
    rows = value_rows(values, 64)
    want = jax_kernels.substring_np(np.ascontiguousarray(rows.T), needle)
    if not 1 <= len(needle) <= kernels.MAX_NEEDLE:
        want[:] = False  # the device entry points' contract (substring_jnp)
    got = kernels.substring(torch.from_numpy(rows), needle)
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want)
    if 1 <= len(needle) <= 48:
        assert got[7]


@pytest.mark.parametrize("width", [12, 96])
def test_exact_plain_matches_jax(width):
    values = seeded_values(width, 2)
    rows = value_rows(values, width)
    planes = np.ascontiguousarray(rows.T)
    for needle in (values[3], values[10], values[0][:width], b"", b"x" * (width + 1)):
        got = kernels.exact(torch.from_numpy(rows), needle)
        assert np.array_equal(got.numpy(), jax_kernels.exact_np(planes, needle)), needle


@pytest.mark.parametrize("bound", [b"", b"b", b"abc", b"\xc3", b"c" * 40, b"a" * 41],
                         ids=lambda b: f"len{len(b)}")
def test_lex_cmp_plain_matches_jax(bound):
    values = seeded_values(40, 3)
    values[1] = bound[:40]
    rows = value_rows(values, 40)
    got = kernels.lex_cmp(torch.from_numpy(rows), bound)
    assert got.dtype == torch.int8
    want = jax_kernels.lex_cmp_np(np.ascontiguousarray(rows.T), bound)
    assert np.array_equal(got.numpy(), want)


def padded_planes(rows: np.ndarray):
    import jax.numpy as jnp

    cap = kernels.pad_cap(rows.shape[0])
    out = np.zeros((rows.shape[1], cap), dtype=np.uint8)
    out[:, : rows.shape[0]] = rows.T
    return jnp.asarray(out)


@pytest.mark.parametrize("which", ["substring", "exact", "lex"])
def test_plain_matches_pallas_interpret(which):
    """The Pallas kernels themselves, run in interpret mode, at one needle
    length each (each (L, W) is its own trace)."""
    width = {"substring": 64, "exact": 12, "lex": 40}[which]
    values = [kernels.fold(v) for v in seeded_values(width, 4, n=200)]
    rows = value_rows(values, width)
    dev = padded_planes(rows)
    n = rows.shape[0]
    if which == "substring":
        got = kernels.substring(torch.from_numpy(rows), b"ab")
        want = jax_kernels.substring_jnp(dev, b"ab", "pallas")[:n]
    elif which == "exact":
        got = kernels.exact(torch.from_numpy(rows), values[5])
        want = jax_kernels.exact_jnp(dev, values[5], "pallas")[:n]
    else:
        got = kernels.lex_cmp(torch.from_numpy(rows), b"b.")
        want = jax_kernels.lex_cmp_jnp(dev, b"b.", "pallas")[:n]
    assert np.array_equal(got.numpy(), want)


def test_pad_cap_and_fold_match_jax():
    for n in (0, 1, 4095, 4096, 4097, 1_000_000):
        assert kernels.pad_cap(n) == jax_kernels.pad_cap(n)
    for raw in (b"ABCxyz", "ÜBER.Png".encode(), b"", b"\xff@[`{"):
        assert kernels.fold(raw) == jax_kernels.fold(raw)


# -- the index and the masks ---------------------------------------------------

LOADER_ROWS = 400


def loader_rows(n: int = LOADER_ROWS, big_sizes: bool = False) -> list[dict]:
    """Rows as LOADER_SQL returns them: the test_search.py recipe, with
    kind/favorite inlined, and optionally sizes past 2 GiB."""
    rows = []
    for i in range(n):
        size = i * 100 if i % 5 else None
        if big_sizes and size is not None:
            size = [100, 3 << 30, (4 << 30) + 5, 5 << 30, 16 << 30][(i // 5) % 5]
        rows.append({
            "id": i + 1, "location_id": 1,
            "materialized_path": "/" if i % 3 else "/sub/dir/",
            "name": ("very-" * 30 + f"long{i}.dat") if i % 97 == 0
            else f"File{i:05d}.MOV" if i % 7 else f"weird_{i}%x",
            "extension": ["dat", "mov", "png", None][i % 4],
            "hidden": [None, 0, 1][i % 3], "size_in_bytes": size,
            "date_created": f"2026-0{1 + i % 9}-11T00:00:{i % 60:02d}+00:00",
            "kind": (i % 24) % 6 if i % 2 else None,
            "favorite": (i % 24) % 4 == 0 if i % 2 else None,
        })
    return rows


COLUMNS = ("ids", "alive", "name_planes", "name_len", "path_planes", "path_len",
           "ext_planes", "ext_len", "date_planes", "date_len", "location",
           "hidden", "kind", "favorite", "size")


def assert_same_index(port, ref):
    """Column for column; the port keeps byte rows ``(CAP, W)`` where the JAX
    index keeps planes ``(W, CAP)``."""
    assert (port.n, port.cap) == (ref.n, ref.cap)
    for name in COLUMNS:
        a, b = getattr(port, name), getattr(ref, name)
        if name.endswith("_planes"):
            a = a.T
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert port.overflow == ref.overflow


def test_index_columns_match_jax_after_build_and_updates():
    rows = loader_rows()
    ref, port = jax_columnar.ColumnarIndex(), columnar.ColumnarIndex()
    ref.build(rows)
    port.build(rows)
    assert_same_index(port, ref)
    assert_same_index(columnar.index_from_jax(ref), ref)
    assert port.consume_delta() is None  # a build resyncs the whole mirror
    changes = [dict(rows[5], name="renamed-" + "x" * 70),  # now overflows
               dict(rows[97], name="short.dat"),  # no longer overflows
               dict(rows[0], id=LOADER_ROWS + 1, name="appended.txt"),
               dict(rows[1], id=LOADER_ROWS + 5000, size_in_bytes=6 << 30)]
    for idx in (ref, port):
        for row in changes:
            assert idx.upsert(row)
        idx.delete_id(10)
        idx.delete_id(195)  # an overflow row
        assert not idx.upsert(dict(rows[2], id=LOADER_ROWS + 2))  # out of order
    assert_same_index(port, ref)
    assert sorted(set(port.consume_delta())) == [5, 9, 97, 194, 400, 401]


@pytest.mark.parametrize("arg", MATRIX, ids=lambda a: canon(a)[:40])
def test_device_mask_matches_jax_cpu_mask(arg):
    pred, _why = columnar.parse_predicate(arg)
    ref_pred, _ = jax_columnar.parse_predicate(arg)
    assert pred == columnar.Predicate(**vars(ref_pred)) if pred else ref_pred is None
    if pred is None:
        return
    ref = jax_columnar.ColumnarIndex()
    ref.build(loader_rows())
    assert ref.overflow  # the rows include truncated names
    port = columnar.index_from_jax(ref)
    got = columnar.eval_mask_device(port, columnar.DeviceMirror("cpu"), pred)
    assert np.array_equal(got, jax_columnar.eval_mask_cpu(ref, ref_pred))


def sqlite_count(rows: list[dict], lo, hi) -> int:
    conn = sqlite3.connect(":memory:")
    conn.execute("CREATE TABLE f (id INTEGER, size_in_bytes INTEGER)")
    conn.executemany("INSERT INTO f VALUES (?, ?)",
                     [(r["id"], r["size_in_bytes"]) for r in rows])
    where = " AND ".join(["1=1"] + (["size_in_bytes >= ?"] if lo is not None else [])
                         + (["size_in_bytes <= ?"] if hi is not None else []))
    params = [v for v in (lo, hi) if v is not None]
    return conn.execute(f"SELECT COUNT(*) FROM f WHERE {where}", params).fetchone()[0]


@pytest.mark.parametrize("bounds", [(1000, None), (2 ** 31, None), (3 << 30, 3 << 30),
                                    (None, (4 << 30) + 4), (2 ** 33, 2 ** 35)])
def test_sizes_past_2gib_match_sqlite(bounds):
    """Sizes of 3 GiB, 4 GiB + 5, 5 GiB and 16 GiB. The JAX device mask is not the
    reference here: its mirror copies the int64 size column with
    jnp.asarray, which narrows it to int32 when 64-bit mode is off (the
    repo's default), so it wraps these sizes. The JAX CPU mask and SQLite
    keep them whole, and so does the port."""
    rows = loader_rows(big_sizes=True)
    pred, _ = columnar.parse_predicate({"size_range": list(bounds), "include_hidden": True})
    ref = jax_columnar.ColumnarIndex()
    ref.build(rows)
    port = columnar.ColumnarIndex()
    port.build(rows)
    got = columnar.eval_mask_device(port, columnar.DeviceMirror("cpu"), pred)
    assert np.array_equal(got, jax_columnar.eval_mask_cpu(ref, pred))
    assert int(got.sum()) == sqlite_count(rows, *bounds) > 0


def test_mirror_patches_in_place_and_matches_a_fresh_upload():
    idx = columnar.ColumnarIndex()
    idx.build(loader_rows())
    mirror = columnar.DeviceMirror("cpu")
    mirror.sync(idx)
    idx.upsert(dict(loader_rows()[3], name="patched.bin", size_in_bytes=7 << 30))
    idx.delete_id(20)
    mirror.sync(idx)
    assert (mirror.uploads, mirror.patches) == (1, 1)
    fresh = columnar.DeviceMirror("cpu")
    idx.generation += 1
    idx._delta_slots = None
    fresh.sync(idx)
    for key, tensor in fresh.arrays.items():
        assert torch.equal(mirror.arrays[key], tensor), key
    assert mirror.arrays["size"].dtype == torch.int64
    assert int(mirror.arrays["size"][3]) == 7 << 30


# -- the row journal -----------------------------------------------------------


def test_row_journal_txn_buffering_and_flood(tmp_path):
    db = Database(tmp_path / "j.db", ALL_MODELS)
    journal = db.attach_row_journal(("file_path", "object"),
                                    flood_on_delete=("object",))
    loc = db.insert(Location, {"pub_id": "l", "name": "l", "path": "/"})
    journal.drain()
    with db.transaction():
        fid = db.insert(FilePath, {"pub_id": "fp-1", "location_id": loc,
                                   "name": "a", "materialized_path": "/"})
        # mid-txn: the note must NOT be drainable yet
        assert not journal.drain()["ids"].get("file_path")
    drained = journal.drain()
    assert fid in drained["ids"]["file_path"]
    # update by pub_id notes the pub_id; by arbitrary where floods
    db.update(FilePath, {"pub_id": "fp-1"}, {"name": "b"})
    db.update(FilePath, {"materialized_path": "/"}, {"hidden": 0})
    drained = journal.drain()
    assert "fp-1" in drained["pub_ids"]["file_path"]
    assert "file_path" in drained["flood"]
    # raw SQL writes are sniffed into a flood
    db.execute("UPDATE file_path SET name = 'raw' WHERE id = 1")
    assert "file_path" in journal.drain()["flood"]
    db.executemany("UPDATE file_path SET name = ? WHERE id = ?", [("raw2", 1)])
    assert "file_path" in journal.drain()["flood"]
    # ... including writes routed through query() inside a transaction, and
    # those notes wait for the transaction to close
    with db.transaction():
        db.query("DELETE FROM object WHERE id = -1")
        db.query("SELECT COUNT(*) FROM file_path")  # reads never note
        assert not journal.drain()["flood"]
    assert journal.drain()["flood"] == {"object"}
    # model-helper batch inserts of fresh ids ride the append scan: no note
    db.insert_many(FilePath, [{"pub_id": "fp-2", "location_id": loc, "name": "c"}])
    drained = journal.drain()
    assert not drained["ids"] and not drained["flood"]
    # object deletes flood (the FK cascade SETs NULL on file_path rows the
    # statement never names)
    oid = db.insert(Object, {"pub_id": "ob-1", "kind": 0})
    journal.drain()
    db.delete(Object, {"id": oid})
    assert "object" in journal.drain()["flood"]
    # cap overflow floods instead of growing
    for i in range(RowJournal.CAP + 2):
        journal.publish_one("file_path", "id", i)
    assert "file_path" in journal.drain()["flood"]
    db.close()


# -- the slice as a whole: a port Node against a JAX Node ----------------------


def seed(db, location_model, object_model, filepath_model, instance_id=None):
    """The rows of tests/test_search.py's ``_seed``, through model helpers."""
    loc = {"pub_id": "loc-s", "name": "s", "path": "/x"}
    if instance_id is not None:
        loc["instance_id"] = instance_id
    loc_id = db.insert(location_model, loc)
    obj_ids = [db.insert(object_model, {"pub_id": f"ob-{i}", "kind": i % 6,
                                        "favorite": i % 4 == 0})
               for i in range(24)]
    rows = []
    for i in range(400):
        rows.append({
            "pub_id": f"fp-{i:05d}", "location_id": loc_id,
            "materialized_path": "/" if i % 3 else "/sub/dir/",
            "name": ("very-" * 30 + f"long{i}.dat") if i % 97 == 0
            else f"File{i:05d}.MOV" if i % 7 else f"weird_{i}%x",
            "extension": ["dat", "mov", "png", None][i % 4],
            "is_dir": int(i % 29 == 0), "hidden": [None, 0, 1][i % 3],
            "size_in_bytes": i * 100 if i % 5 else None,
            "object_id": obj_ids[i % 24] if i % 2 else None,
            "date_created": f"2026-0{1 + i % 9}-11T00:00:{i % 60:02d}+00:00",
        })
    db.insert_many(filepath_model, rows)
    return loc_id


@pytest.fixture(scope="module")
def both_nodes(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("SD_SEARCH_ENGINE", "device")
    mp.setenv("SD_P2P_DISABLED", "1")
    base = tmp_path_factory.mktemp("search")
    jax_node = JaxNode(base / "jax", probe_accelerator=False, watch_locations=False)
    port_node = Node(base / "port", device="cpu", watch_locations=False)
    try:
        jax_lib = jax_node.libraries.create("search")
        seed(jax_lib.db, JaxLocation, JaxObject, JaxFilePath, jax_lib.instance_id)
        jax_node.emit("db.commit", None, jax_lib.id)
        jax_node.search_engine.refresh_now(jax_lib)
        port_lib = port_node.libraries.create("search")
        seed(port_lib.db, Location, Object, FilePath)
        port_node.emit("db.commit", None, port_lib.id)
        port_node.search_engine.refresh_now(port_lib)
        yield (jax_node, jax_lib), (port_node, port_lib)
    finally:
        port_node.shutdown()
        jax_node.shutdown()
        mp.undo()


def shared(value, keys):
    """A paths answer cut to the columns both schemas have."""
    if isinstance(value, dict) and "items" in value:
        return {"cursor": value["cursor"],
                "items": [{k: item[k] for k in sorted(keys)} for item in value["items"]]}
    return value


@pytest.mark.parametrize("arg", MATRIX, ids=lambda a: canon(a)[:40])
def test_port_search_matches_jax(both_nodes, arg):
    (jax_node, jax_lib), (port_node, port_lib) = both_nodes
    want = jax_node.router.resolve("search.paths", arg, jax_lib.id)
    got = paths(port_node, port_lib, arg)
    keys = set(got["items"][0]) & set(want["items"][0]) if got["items"] else set()
    assert len(keys) >= 20 or not got["items"]
    assert canon(shared(got, keys)) == canon(shared(want, keys))
    assert paths_count(port_node, port_lib, arg) \
        == jax_node.router.resolve("search.pathsCount", arg, jax_lib.id)


def test_port_engine_served_the_matrix(both_nodes):
    _jax, (port_node, port_lib) = both_nodes
    engine = port_node.search_engine
    before = engine.status()["served"]
    for arg in MATRIX:
        engine.set_enabled(False)
        sql, sql_n = paths(port_node, port_lib, arg), paths_count(port_node, port_lib, arg)
        engine.set_enabled(True)
        assert canon(paths(port_node, port_lib, arg)) == canon(sql), arg
        assert paths_count(port_node, port_lib, arg) == sql_n, arg
    # every query but the wildcard one was answered by the engine, twice
    assert engine.status()["served"] - before == 2 * (len(MATRIX) - 1)


# -- the port's engine against its own SQL path -------------------------------


@pytest.fixture()
def port_node(tmp_path, monkeypatch):
    monkeypatch.setenv("SD_SEARCH_ENGINE", "device")
    node = Node(tmp_path / "data", device="cpu", watch_locations=False)
    yield node
    node.shutdown()


def test_engine_is_off_unless_armed(tmp_path, monkeypatch):
    monkeypatch.delenv("SD_SEARCH_ENGINE", raising=False)
    node = Node(tmp_path / "data", device="cpu", watch_locations=False)
    try:
        assert node.search_engine is None
    finally:
        node.shutdown()


def compare(node, lib, arg):
    engine = node.search_engine
    engine.set_enabled(False)
    sql, sql_n = paths(node, lib, arg), paths_count(node, lib, arg)
    engine.set_enabled(True)
    assert canon(paths(node, lib, arg)) == canon(sql), arg
    assert paths_count(node, lib, arg) == sql_n, arg


def test_post_commit_search_never_returns_pre_watermark_rows(port_node):
    node = port_node
    lib = node.libraries.create("s")
    loc_id = seed(lib.db, Location, Object, FilePath)
    node.emit("db.commit", None, lib.id)
    engine = node.search_engine
    engine.refresh_now(lib)
    for round_no in range(8):
        marker = f"fresh-{round_no:02d}"
        lib.db.insert(FilePath, {
            "pub_id": f"fp-{marker}", "location_id": loc_id,
            "materialized_path": "/", "name": f"{marker}.bin",
            "extension": "bin", "is_dir": 0})
        if round_no % 3 == 0 and round_no:
            lib.db.update(FilePath, {"pub_id": f"fp-fresh-{round_no - 1:02d}"},
                          {"name": f"renamed-{round_no - 1:02d}.bin"})
        node.emit("db.commit", None, lib.id)
        # IMMEDIATELY post-commit: the engine's answer must equal SQL's
        assert paths_count(node, lib, {"search": marker}) == 1, round_no
        if round_no % 2:
            engine.refresh_now(lib)
            compare(node, lib, {"search": "fresh"})
    engine.refresh_now(lib)
    before = engine.status()
    compare(node, lib, {"search": "fresh"})
    after = engine.status()
    assert after["served"] == before["served"] + 2  # non-vacuous
    assert after["refreshes"]["incremental"] >= 1
    state = after["libraries"][lib.id]
    assert state["mirror_patches"] >= 1 and state["fresh"]


class InsertPerStep(StatefulJob):
    """Two steps, each committing five file_path rows in one transaction.
    Each step announces itself and waits for the test's go-ahead first."""

    NAME = "insert_per_step"

    def __init__(self, loc_id: int) -> None:
        super().__init__({"loc_id": loc_id})
        self.started = [threading.Event(), threading.Event()]
        self.go = [threading.Event(), threading.Event()]

    def init(self, ctx):
        return {}, [0, 1], {}

    def execute_step(self, ctx, data, step, step_number):
        self.started[step].set()
        assert self.go[step].wait(30)
        with ctx.library.db.transaction():
            for i in range(5):
                ctx.library.db.insert(FilePath, {
                    "pub_id": f"fp-job-{step}-{i}",
                    "location_id": self.init_args["loc_id"],
                    "materialized_path": "/", "name": f"jobrow-{step}-{i}.bin",
                    "extension": "bin", "is_dir": 0})
        return StepResult()


def test_running_job_step_commits_reach_the_index(port_node):
    """A job's committed step moves the watermark before the job exits: a
    query made while the job still runs equals SQL, and once refreshed the
    engine serves it with the step's rows."""
    node = port_node
    lib = node.libraries.create("s")
    loc_id = seed(lib.db, Location, Object, FilePath)
    engine = node.search_engine
    job = InsertPerStep(loc_id)
    node.jobs.spawn(lib, [job])
    try:
        assert job.started[0].wait(30)
        engine.refresh_now(lib)  # past the job's init, before its rows
        assert engine.status()["libraries"][lib.id]["fresh"]
        assert paths_count(node, lib, {"search": "jobrow"}) == 0
        job.go[0].set()
        assert job.started[1].wait(30)  # step 0 committed, job running
        assert paths_count(node, lib, {"search": "jobrow"}) == 5
        compare(node, lib, {"search": "jobrow"})
        engine.refresh_now(lib)
        served = engine.status()["served"]
        compare(node, lib, {"search": "jobrow"})
        assert engine.status()["served"] == served + 2  # non-vacuous
    finally:
        for go in job.go:
            go.set()
    assert node.jobs.wait_idle(30)
    assert paths_count(node, lib, {"search": "jobrow"}) == 10
    engine.refresh_now(lib)
    compare(node, lib, {"search": "jobrow"})


def test_raw_write_and_object_change_reach_the_index(port_node):
    node = port_node
    lib = node.libraries.create("s")
    seed(lib.db, Location, Object, FilePath)
    engine = node.search_engine
    engine.refresh_now(lib)
    full = engine.status()["refreshes"]["full"]
    lib.db.execute("UPDATE file_path SET name = 'rawhit.xyz' WHERE id = 5")
    node.emit("db.commit", None, lib.id)
    engine.refresh_now(lib)
    assert engine.status()["refreshes"]["full"] > full  # flood → rebuild
    compare(node, lib, {"search": "rawhit"})
    obj = lib.db.query("SELECT id FROM object LIMIT 1")[0]["id"]
    lib.db.update(Object, {"id": obj}, {"favorite": 1, "kind": 5})
    node.emit("db.commit", None, lib.id)
    engine.refresh_now(lib)
    compare(node, lib, {"kinds": [5]})
    compare(node, lib, {"favorite": True})


def test_toolarge_candidate_set_serves_sql(port_node, monkeypatch):
    node = port_node
    lib = node.libraries.create("s")
    seed(lib.db, Location, Object, FilePath)
    engine = node.search_engine
    engine.refresh_now(lib)
    monkeypatch.setattr(SearchEngine, "MAX_HYDRATE", 10)
    assert engine.candidate_ids(lib, {"search": "file"}) is None
    assert engine.count(lib, {"search": "file"}) > 10
    compare(node, lib, {"search": "file"})
    with pytest.raises(ApiError):
        paths(node, lib, {"dirs_first": True, "cursor": ["a", 1]})


def test_scorer_error_propagates(port_node, monkeypatch):
    node = port_node
    lib = node.libraries.create("s")
    seed(lib.db, Location, Object, FilePath)
    node.search_engine.refresh_now(lib)

    def boom(*_a, **_k):
        raise RuntimeError("kernel failed")

    monkeypatch.setattr(kernels, "substring_plain", boom)
    with pytest.raises(RuntimeError, match="kernel failed"):
        paths(node, lib, {"search": "file0"})
    with pytest.raises(RuntimeError, match="kernel failed"):
        paths_count(node, lib, {"search": "file0"})
    # a predicate that needs no substring is still served
    assert paths_count(node, lib, {"extensions": ["png"]}) > 0
