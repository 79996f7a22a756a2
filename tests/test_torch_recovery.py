"""The port's backups (spacedrive_tpu_torch/backups.py) and boot gate
(recovery.py) against the JAX package's, on the CPU.

- A backup round trip: a library scanned, backed up, changed, restored
  (its rows come back, the library is loaded again); ``backups.getAll``.
- Refusals equal to the reference's, message for message: garbage, a torn
  archive, a flipped byte, and a backup of another library.
- The format both ways: a backup written by the JAX package's
  ``do_backup`` passes the port's ``read_header``, ``validate_backup`` and
  ``find_latest_backup``, and the reverse.
- The boot gate: a database with overwritten pages is quarantined and
  restored from the newest backup (its rows come back, the node
  notification says so), or started fresh when there is no backup; both
  as the JAX node does. A sound database with a WAL left over is counted.
- ``note_cold_resumed``: a job a dead process left Running is counted once
  at the next boot.
- The ``backup`` and ``restore`` fault seams: a full disk leaves no
  ``.bkp``, a read error before the renames leaves the live database.
- A whole restore across the packages: a JAX backup restored into a port
  node.
"""

import json
import os
import shutil

import pytest

from spacedrive_tpu import backups as jax_backups
from spacedrive_tpu import telemetry as jax_telemetry
from spacedrive_tpu.locations import create_location as jax_create_location
from spacedrive_tpu.locations.indexer_job import IndexerJob as JaxIndexerJob
from spacedrive_tpu.node import Node as JaxNode
from spacedrive_tpu.objects.file_identifier import FileIdentifierJob as JaxIdentifierJob
from spacedrive_tpu_torch import backups, recovery
from spacedrive_tpu_torch import telemetry as port_telemetry
from spacedrive_tpu_torch.jobs import JobStatus
from spacedrive_tpu_torch.locations import create_location
from spacedrive_tpu_torch.locations.indexer_job import IndexerJob
from spacedrive_tpu_torch.node import Node
from spacedrive_tpu_torch.objects.file_identifier import FileIdentifierJob
from tests.torch_scan_cases import blob, rows_of, one_torch_thread  # noqa: F401

PKGS = {
    "jax": (lambda d: JaxNode(d, probe_accelerator=False, watch_locations=False),
            jax_create_location, (JaxIndexerJob, JaxIdentifierJob), jax_backups),
    "port": (lambda d: Node(d, device="cpu", watch_locations=False),
             create_location, (IndexerJob, FileIdentifierJob), backups),
}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("SD_P2P_DISABLED", "1")
    # each node's alert rules read its package's process-wide registry (a
    # corrupt boot's counter fires an alert into the node notifications on
    # the evaluator's next tick): both start from zero before any node
    # boots, run their default rules, and their notifications compare
    jax_telemetry.reset()
    port_telemetry.reset()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("rec") / "tree"
    for d in range(3):
        (root / f"d{d}").mkdir(parents=True)
        for i in range(4):
            (root / f"d{d}" / f"f{i}.bin").write_bytes(blob(7 * d + i, 400 + 300 * i))
    return root


def scanned(pkg, data_dir, tree):
    make, create, jobs, _mod = PKGS[pkg]
    node = make(data_dir)
    lib = node.libraries.create(f"{pkg}-lib")
    loc = create(lib, tree)
    node.jobs.spawn(lib, [job({"location_id": loc["id"]}) for job in jobs])
    assert node.jobs.wait_idle(120)
    return node, lib


def corrupt(db_path):
    """Overwrite pages past the header: quick_check fails on them."""
    with open(db_path, "r+b") as fh:
        fh.seek(4096)
        fh.write(blob(1, 3 * 4096))


def test_backup_round_trip_restores_the_rows(tmp_path, tree):
    node, lib = scanned("port", tmp_path / "data", tree)
    try:
        want = rows_of(lib.db)
        backup_id = node.router.resolve("backups.backup", lib.id)
        listed = node.router.resolve("backups.getAll")
        assert [b["id"] for b in listed["backups"]] == [backup_id]
        assert listed["backups"][0]["library_id"] == lib.id
        assert lib.db.query("SELECT COUNT(*) n FROM statistics")[0]["n"] == 1
        lib.db.execute("DELETE FROM file_path WHERE name = 'f1'")
        assert rows_of(lib.db) != want
        path = listed["backups"][0]["path"]
        assert node.router.resolve("backups.restore", path) == lib.id
        restored = node.libraries.get(lib.id)
        assert restored is not lib and rows_of(restored.db) == want
        node.router.resolve("backups.delete", backup_id)
        assert node.router.resolve("backups.getAll")["backups"] == []
    finally:
        node.shutdown()


def refusal(mod, path, expect=None):
    try:
        mod.validate_backup(path, expect_library_id=expect)
    except ValueError as e:
        return str(e)
    return None


def test_refusals_match_the_reference(tmp_path, tree):
    node, lib = scanned("port", tmp_path / "data", tree)
    try:
        good = backups.backups_dir(node) / f"{backups.do_backup(node, lib.id)}.bkp"
    finally:
        node.shutdown()
    raw = good.read_bytes()
    cases = {"garbage": blob(2, 4000), "torn": raw[: len(raw) // 2],
             "flipped": raw[:-40] + bytes([raw[-40] ^ 0xFF]) + raw[-39:],
             "headerless": raw[backups.HEADER_LEN:]}
    for name, data in cases.items():
        bad = tmp_path / f"{name}.bkp"
        bad.write_bytes(data)
        got, want = refusal(backups, bad), refusal(jax_backups, bad)
        assert got is not None and got == want, name
    got = refusal(backups, good, expect="another-library")
    assert got == refusal(jax_backups, good, expect="another-library")
    assert "does not match the restore target" in got
    assert refusal(backups, good, expect=lib.id) is None


def test_the_format_crosses_both_ways(tmp_path, tree):
    made = {}
    for pkg, (_make, _create, _jobs, mod) in PKGS.items():
        node, lib = scanned(pkg, tmp_path / pkg, tree)
        try:
            made[pkg] = (mod.backups_dir(node) / f"{mod.do_backup(node, lib.id)}.bkp", lib.id)
        finally:
            node.shutdown()
    for writer, reader in (("jax", backups), ("port", jax_backups)):
        path, lib_id = made[writer]
        header = reader.read_header(path)
        assert header["library_id"] == lib_id and header["library_name"] == f"{writer}-lib"
        assert reader.validate_backup(path, expect_library_id=lib_id) == header
        assert reader.find_latest_backup(path.parent, lib_id) == path
    for pkg in PKGS:  # each package's own view of the other's header
        path, _ = made[pkg]
        assert backups.read_header(path) == jax_backups.read_header(path)


def repaired_boot(pkg, data_dir, tree, with_backup):
    """Scan, optionally back up, change a row, shut down, overwrite pages of
    the database, boot again: (rows before the change, rows after the boot,
    the node notifications, the quarantine's files)."""
    node, lib = scanned(pkg, data_dir, tree)
    lib_id = lib.id
    want = rows_of(lib.db)
    if with_backup:
        PKGS[pkg][3].do_backup(node, lib_id)
    lib.db.execute("DELETE FROM file_path WHERE name = 'f2'")
    node.shutdown()
    corrupt(data_dir / "libraries" / f"{lib_id}.db")
    node = PKGS[pkg][0](data_dir)
    try:
        got = rows_of(node.libraries.get(lib_id).db)
        notes = [n["data"] for n in node.config.get()["notifications"]]
    finally:
        node.shutdown()
    quarantined = sorted(p.name.split(".corrupt-")[0]
                         for p in (data_dir / "libraries" / "quarantine").iterdir())
    for n in notes:
        n["library_id"] = n["library_id"] == lib_id
        if n.get("backup"):
            n["backup"] = os.path.dirname(n["backup"]) == str(data_dir / "backups")
    return want, got, notes, quarantined


@pytest.mark.parametrize("with_backup", [True, False], ids=["restored", "fresh"])
def test_a_corrupt_database_is_repaired_like_jax(tmp_path, tree, with_backup):
    recovery.reset_counts()
    out = {pkg: repaired_boot(pkg, tmp_path / pkg, tree, with_backup) for pkg in PKGS}
    want, got, notes, quarantined = out["port"]
    assert notes == out["jax"][2] == [{"kind": "library_db_repaired", "library_id": True,
                      "action": "restored_from_backup" if with_backup else "fresh_db",
                      "backup": True if with_backup else None}]
    # the same files quarantined: "<library id>.db" (and its sidecars)
    assert [q.split(".", 1)[1] for q in quarantined] == \
        [q.split(".", 1)[1] for q in out["jax"][3]] and "db" in [q.split(".", 1)[1]
                                                               for q in quarantined]
    if with_backup:
        assert got == want and out["jax"][1] == out["jax"][0]
        assert recovery.REPAIRS == {"quarantine": 1, "restore_backup": 1}
    else:
        assert got == ([], [], {}) and out["jax"][1] == got
        assert recovery.REPAIRS == {"quarantine": 1, "fresh_db": 1}
    assert recovery.BOOT_CHECKS["corrupt"] == 1


def instance_after_repair(pkg, data_dir, tree, with_backup):
    """The library's own instance row across a repaired boot: (the same
    pub_id as before, the same row id, a row at all)."""
    node, lib = scanned(pkg, data_dir, tree)
    lib_id, before, before_id = lib.id, lib.instance()["pub_id"], lib.instance_id
    if with_backup:
        PKGS[pkg][3].do_backup(node, lib_id)
    node.shutdown()
    corrupt(data_dir / "libraries" / f"{lib_id}.db")
    node = PKGS[pkg][0](data_dir)
    try:
        lib = node.libraries.get(lib_id)
        row = lib.instance()
        out = (row is not None and row["pub_id"] == before, lib.instance_id == before_id,
               row is not None, lib.sync.instance_pub_id == (row or {}).get("pub_id"))
    finally:
        node.shutdown()
    # the next boot reads the sidecar the repair left: the same row again
    node = PKGS[pkg][0](data_dir)
    try:
        again = node.libraries.get(lib_id).instance()
        return out + (again is not None and again["pub_id"] == row["pub_id"],)
    finally:
        node.shutdown()


@pytest.mark.parametrize("with_backup", [True, False], ids=["restored", "fresh"])
def test_the_instance_row_survives_a_repair_like_jax(tmp_path, tree, with_backup):
    """A restored backup keeps the library's instance row; a fresh database
    gets a new one, which the sidecar then names."""
    out = {pkg: instance_after_repair(pkg, tmp_path / pkg, tree, with_backup) for pkg in PKGS}
    assert out["port"] == out["jax"]
    assert out["port"] == ((True, True, True, True, True) if with_backup
                           else (False, True, True, True, True))


def test_gate_outcomes_match_the_reference(tmp_path):
    from spacedrive_tpu import recovery as jax_recovery

    libs = tmp_path / "libraries"
    libs.mkdir()
    assert recovery.ensure_library_integrity(libs, "none") == \
        jax_recovery.ensure_library_integrity(libs, "none") == {"outcome": "missing"}
    import sqlite3

    conn = sqlite3.connect(libs / "x.db")
    conn.execute("PRAGMA journal_mode=WAL")
    conn.execute("PRAGMA wal_autocheckpoint=0")
    conn.execute("CREATE TABLE t (a)")
    conn.execute("INSERT INTO t VALUES (1)")
    conn.commit()
    shutil.copy(libs / "x.db-wal", tmp_path / "wal")
    conn.close()
    for mod in (recovery, jax_recovery):
        shutil.copy(tmp_path / "wal", libs / "x.db-wal")
        assert mod.ensure_library_integrity(libs, "x") == {"outcome": "ok",
                                                          "wal_recovered": True}
    assert recovery.quick_check_file(libs / "x.db") == jax_recovery.quick_check_file(
        libs / "x.db") == []
    (libs / "junk.db").write_bytes(b"not a database" * 100)
    assert recovery.quick_check_file(libs / "junk.db") == jax_recovery.quick_check_file(
        libs / "junk.db")


def test_a_job_left_running_is_counted_at_boot(tmp_path, tree):
    node, lib = scanned("port", tmp_path / "data", tree)
    lib_id = lib.id
    jid = lib.db.query("SELECT id FROM job WHERE name = 'indexer'")[0]["id"]
    node.shutdown()
    from spacedrive_tpu_torch.models import Database, JobRow

    db = Database(tmp_path / "data" / "libraries" / f"{lib_id}.db", [JobRow])
    db.update(JobRow, {"id": jid}, {"status": JobStatus.RUNNING})
    db.close()
    recovery.reset_counts()
    node = Node(tmp_path / "data", device="cpu", watch_locations=False)
    try:
        assert node.jobs.wait_idle(120)
        assert recovery.RECOVERED["cold_resumed"] == 1
        row = node.libraries.get(lib_id).db.query("SELECT status FROM job WHERE id = ?", [jid])
        assert row[0]["status"] == JobStatus.COMPLETED
    finally:
        node.shutdown()
    recovery.reset_counts()
    Node(tmp_path / "data", device="cpu", watch_locations=False).shutdown()
    assert recovery.RECOVERED["cold_resumed"] == 0  # a clean restart revives nothing


def test_the_whole_restore_across_packages(tmp_path, tree):
    """A JAX backup restored into a port node: the port's tables carry the
    rows over (its columns are a subset of the reference's)."""
    jnode, jlib = scanned("jax", tmp_path / "jax", tree)
    try:
        path = jax_backups.backups_dir(jnode) / f"{jax_backups.do_backup(jnode, jlib.id)}.bkp"
        want = rows_of(jlib.db)
    finally:
        jnode.shutdown()
    node = Node(tmp_path / "port", device="cpu", watch_locations=False)
    try:
        assert backups.do_restore(node, path) == jlib.id
        lib = node.libraries.get(jlib.id)
        assert lib.name == "jax-lib" and rows_of(lib.db) == want
        assert json.loads((node.libraries.dir / f"{jlib.id}.sdlibrary").read_text())["name"] \
            == "jax-lib"
    finally:
        node.shutdown()


def test_the_backup_and_restore_fault_seams_match_the_reference(tmp_path, tree):
    """A full disk at the backup seam leaves no .bkp; a read error at the
    restore seam, after the extraction and before the renames, leaves the
    live database as it was and no temporary directory; in both packages."""
    from spacedrive_tpu import faults as jax_faults
    from spacedrive_tpu_torch import faults

    out = {}
    for pkg, arm in (("jax", lambda spec: jax_faults.install(spec, seed=0)),
                     ("port", faults.install)):
        mod = PKGS[pkg][3]
        node, lib = scanned(pkg, tmp_path / pkg, tree)
        libs = node.libraries.dir
        try:
            arm("backup:enospc:once")
            with pytest.raises(OSError) as full:
                mod.do_backup(node, lib.id)
            no_bkp = not list(mod.backups_dir(node).glob("*.bkp"))
            (jax_faults if pkg == "jax" else faults).clear()
            path = mod.backups_dir(node) / f"{mod.do_backup(node, lib.id)}.bkp"
            lib.db.execute("DELETE FROM file_path WHERE name = 'f0'")
            lib.db.execute("PRAGMA wal_checkpoint(TRUNCATE)")
            before = (libs / f"{lib.id}.db").read_bytes()
            arm("restore:eio:once")
            with pytest.raises(OSError) as eio:
                mod.do_restore(node, path)
            (jax_faults if pkg == "jax" else faults).clear()
            out[pkg] = (full.value.errno, no_bkp, eio.value.errno,
                        (libs / f"{lib.id}.db").read_bytes() == before,
                        sorted(p.name for p in libs.iterdir() if ".sd-tmp" in p.name))
        finally:
            (jax_faults if pkg == "jax" else faults).clear()
            node.shutdown()
    assert out["port"] == out["jax"]
    assert out["port"][1] and out["port"][3] and out["port"][4] == []
