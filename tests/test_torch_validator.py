"""The port's object validator (spacedrive_tpu_torch.objects.validator) and
its long-message BLAKE3 route (ops.blake3.blake3_long_hex) against the JAX
package and the Python oracle, on the CPU (the kernels' plain versions).

- The long route over an edge set of lengths at 4-chunk windows merged 4 at
  a time (three levels above the chunks at 16 KiB + 1), against the port's
  ``blake3_ref``; a 2.5 MiB file at the default window against the JAX
  package's ``full_file_hash``.
- Chunk counters past 2**32: the plain chunk CVs of windows at offsets
  2**32 - 1 ... 2**32 + 1 against ``blake3_ref._chunk_output``.
- Both Nodes index and identify one seeded tree and run their
  ``ObjectValidatorJob``: ``integrity_checksum`` equal row for row; then two
  tampered files and one deleted file, revalidated with and without
  ``sub_path``: mismatch counts, metadata and error lines equal (the
  ``validate`` line up to the exception text); ``EarlyFinish`` when nothing
  is left to validate.
"""

import random

import numpy as np
import pytest
import torch

from spacedrive_tpu.locations import create_location as jax_create_location
from spacedrive_tpu.locations.indexer_job import IndexerJob as JaxIndexerJob
from spacedrive_tpu.node import Node as JaxNode
from spacedrive_tpu.objects.file_identifier import FileIdentifierJob as JaxIdentifierJob
from spacedrive_tpu.objects.validator import ObjectValidatorJob as JaxValidatorJob
from spacedrive_tpu.objects.validator import full_file_hash as jax_full_file_hash
from spacedrive_tpu_torch.api.routers.jobs import object_validator
from spacedrive_tpu_torch.jobs import EarlyFinish
from spacedrive_tpu_torch.locations import create_location
from spacedrive_tpu_torch.locations.indexer_job import IndexerJob
from spacedrive_tpu_torch.node import Node
from spacedrive_tpu_torch.objects import blake3_ref
from spacedrive_tpu_torch.objects.file_identifier import FileIdentifierJob
from spacedrive_tpu_torch.objects.validator import ObjectValidatorJob, full_file_hashes
from spacedrive_tpu_torch.ops import blake3 as b3
from tests.torch_scan_cases import blob, one_torch_thread  # noqa: F401

W, F = 4, 4
K = 1024
EDGES = (0, 1, K, K + 1, W * K - 1, W * K, W * K + 1, 2 * W * K, W * F * K + 1, W * F * K + 17)


@pytest.fixture(scope="module")
def edge_files(tmp_path_factory):
    """The edge set as files, their bytes, and the long route's digests of
    them at W = 4, F = 4 (one call, through the validator's file reader)."""
    root = tmp_path_factory.mktemp("edges")
    datas = [blob(n + 1, n) for n in EDGES]
    paths = []
    for n, data in zip(EDGES, datas):
        paths.append(root / f"e{n}.bin")
        paths[-1].write_bytes(data)
    got = full_file_hashes(paths + [root / "missing.bin"], "cpu", window_chunks=W, fan_in=F,
                           staging_bytes=16 * K)
    return datas, got


@pytest.mark.parametrize("k", range(len(EDGES)), ids=[str(n) for n in EDGES])
def test_long_route_edges_match_the_oracle(edge_files, k):
    datas, got = edge_files
    assert got[k] == blake3_ref.blake3(datas[k]).hex()


def test_long_route_reports_an_unreadable_file_in_place(edge_files):
    _datas, got = edge_files
    assert isinstance(got[-1], FileNotFoundError)


def test_long_route_levels_and_bytes_messages():
    """Pairs merged two at a time (seven levels over 65 windows), and
    staging that holds one full window a batch, give the same digests."""
    msgs = [random.Random(n).randbytes(n) for n in (0, 5, W * K + 3, 64 * W * K + 5)]
    want = [blake3_ref.blake3(m).hex() for m in msgs]
    stats: dict = {}
    got = b3.blake3_long_hex([b3.BytesMessage(m) for m in msgs], "cpu", window_chunks=W,
                             fan_in=2, staging_bytes=16 * W * K, stats=stats)
    assert got == want
    assert stats["levels"] == 7 and stats["bytes"] == sum(map(len, msgs))
    stats = {}
    got = b3.blake3_long_hex([b3.BytesMessage(m) for m in msgs[:3]], "cpu", window_chunks=W,
                             fan_in=F, staging_bytes=W * K, stats=stats)
    assert got == want[:3] and stats["batches"] == 2  # the full window, then 3 one-chunk rows
    with pytest.raises(ValueError, match="power of two"):
        b3.blake3_long_hex([b3.BytesMessage(b"")], "cpu", fan_in=3)


def test_default_window_matches_the_jax_full_file_hash(tmp_path):
    data = random.Random(9).randbytes(2 * 1024 * 1024 + 512 * 1024 + 777)
    path = tmp_path / "big.bin"
    path.write_bytes(data)
    assert full_file_hashes([path], "cpu") == [jax_full_file_hash(path)]


@pytest.mark.parametrize("base, C, total", [
    (2**32 - 1, 3, (2**32 + 4) * K),       # counters across the high word
    (2**32, 2, (2**32 + 1) * K + 77),      # the message's short final chunk
    (2**32 - 1, 4, (2**32 + 1) * K),       # chunks past the end are zero
], ids=["across", "final", "past-end"])
def test_chunk_counters_past_2_32_match_the_oracle(base, C, total):
    n_total = -(-total // K)
    # the row's bytes past the message's end are zero, as the route leaves them
    data = blob(base % 97, C * K)[: max(0, min(C * K, total - base * K))].ljust(C * K, b"\0")
    rows = torch.from_numpy(np.frombuffer(data, np.int32).copy()).reshape(1, C * 256)
    got = b3.chunk_cvs(rows, torch.tensor([C * K], dtype=torch.int32),
                       torch.tensor([base]), torch.tensor([total]))
    for c in range(C):
        g = base + c
        if g >= n_total:
            assert not got[0, c].any()
            continue
        chunk = data[c * K : c * K + min(K, total - g * K)]
        want = blake3_ref.compress(*blake3_ref._chunk_output(chunk, g))[:8]
        assert got[0, c].tolist() == want


def test_full_file_hashes_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        full_file_hashes([tmp_path / "x"])


def make_tree(root):
    """Small files of many kinds in three directories, two files past the
    default 2 MiB window, an empty file and a copy."""
    sizes = [0, 1, 777, 1024, 1025, 5000, 64 * K + 3, 120_000, 2 * 1024 * K + 1]
    for d in range(3):
        (root / f"d{d}" / "sub").mkdir(parents=True)
        for i, n in enumerate(sizes):
            where = root / f"d{d}" / ("sub" if i % 3 == 0 else "") / f"f{i}.bin"
            where.write_bytes(blob(100 * d + i, n))
    (root / "d1" / "copy.bin").write_bytes(blob(3, 5000))
    return root


def jobs_of(db, name):
    return [dict(r) for r in db.query("SELECT * FROM job WHERE name = ? ORDER BY date_created",
                                      [name])]


def checksums(db):
    return sorted(tuple(r) for r in db.query(
        "SELECT materialized_path, name, extension, integrity_checksum FROM file_path "
        "WHERE is_dir = 0"))


def run_jax(node, lib, args):
    node.jobs.spawn(lib, [JaxValidatorJob(dict(args))])
    assert node.jobs.wait_idle(120)


def run_port(node, lib, args):
    object_validator(node, lib, args)
    assert node.jobs.wait_idle(120)


def report(job):
    """(status, metadata without the JAX job's telemetry ``trace``, error
    lines with each validate line cut before its exception text)."""
    import json

    errors = sorted(e if not e.startswith("validate ") else e.split(": ")[0]
                    for e in (job["errors_text"] or "").split("\n\n") if e)
    meta = job["metadata"]
    meta = json.loads(meta) if isinstance(meta, (str, bytes)) else meta
    return job["status"], {k: v for k, v in (meta or {}).items() if k != "trace"}, errors


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The JAX and the port Node, each with one library holding the same
    tree, indexed and identified; the tree stays shared."""
    base = tmp_path_factory.mktemp("validate")
    tree = make_tree(base / "tree")
    jnode = JaxNode(base / "jax", probe_accelerator=False, watch_locations=False)
    pnode = Node(base / "port", device="cpu", watch_locations=False)
    jlib, plib = jnode.libraries.create("jax"), pnode.libraries.create("port")
    jloc, ploc = jax_create_location(jlib, tree), create_location(plib, tree)
    for node, lib, loc, jobs in ((jnode, jlib, jloc, (JaxIndexerJob, JaxIdentifierJob)),
                                 (pnode, plib, ploc, (IndexerJob, FileIdentifierJob))):
        node.jobs.spawn(lib, [job({"location_id": loc["id"]}) for job in jobs])
        assert node.jobs.wait_idle(120)
    yield tree, (jnode, jlib, jloc), (pnode, plib, ploc)
    jnode.shutdown()
    pnode.shutdown()


def test_validator_rows_and_revalidation_match_jax(both):
    tree, (jnode, jlib, jloc), (pnode, plib, ploc) = both
    run_jax(jnode, jlib, {"location_id": jloc["id"]})
    run_port(pnode, plib, {"location_id": ploc["id"]})
    rows = checksums(plib.db)
    assert rows == checksums(jlib.db)
    hashed = plib.db.query("SELECT COUNT(*) n FROM file_path WHERE cas_id IS NOT NULL")[0]["n"]
    assert len([r for r in rows if r[3]]) == hashed == 25  # every file but the 3 empty ones
    assert report(jobs_of(plib.db, "object_validator")[0]) == report(
        jobs_of(jlib.db, "object_validator")[0])

    # nothing left: both finish early, without a step
    run_jax(jnode, jlib, {"location_id": jloc["id"]})
    run_port(pnode, plib, {"location_id": ploc["id"]})
    assert [report(j)[0] for j in jobs_of(plib.db, "object_validator")] == [
        report(j)[0] for j in jobs_of(jlib.db, "object_validator")]

    # one byte changed in a small file and in the mid window of a large
    # one, one file deleted; revalidate d1 alone, then the whole location
    with open(tree / "d1" / "f5.bin", "r+b") as fh:
        byte = fh.read(1)[0]
        fh.seek(0)
        fh.write(bytes([byte ^ 0xFF]))
    with open(tree / "d2" / "f8.bin", "r+b") as fh:
        fh.seek(1024 * K + 5)
        byte = fh.read(1)[0]
        fh.seek(1024 * K + 5)
        fh.write(bytes([byte ^ 1]))
    (tree / "d0" / "f4.bin").unlink()
    for args in ({"sub_path": "d1", "revalidate": True}, {"revalidate": True}):
        run_jax(jnode, jlib, {"location_id": jloc["id"], **args})
        run_port(pnode, plib, {"location_id": ploc["id"], **args})
        port, ref = (report(jobs_of(db, "object_validator")[-1]) for db in (plib.db, jlib.db))
        assert port == ref
    assert port[1] == {"validated": 22, "mismatched": 2}
    assert [e for e in port[2] if "MISMATCH" in e] == [
        e for e in ref[2] if "MISMATCH" in e] and len(port[2]) == 3
    assert checksums(plib.db) == checksums(jlib.db)


def test_validator_early_finish_and_a_missing_location(both):
    _tree, _j, (pnode, plib, ploc) = both
    from spacedrive_tpu_torch.jobs import DynJob, JobError, JobReport, Worker, WorkerContext

    job = ObjectValidatorJob({})
    ctx = WorkerContext(Worker(pnode.jobs, plib, DynJob(job, JobReport(id="x", name=job.NAME))))
    with pytest.raises(EarlyFinish, match="no file paths to validate"):
        ObjectValidatorJob({"location_id": ploc["id"], "sub_path": "nowhere"}).init(ctx)
    with pytest.raises(JobError, match="location 999 not found"):
        ObjectValidatorJob({"location_id": 999}).init(ctx)
