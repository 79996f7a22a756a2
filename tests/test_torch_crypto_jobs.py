"""The port's crypto jobs, keys router and shell gate against the JAX
package's, on the CPU.

One tree (numpy, seeded: files below and above 100 KiB, one of 2 MiB +
12,345 B) goes through a JAX Node (``hasher="cpu"``) and a port
``Node(device="cpu")``: scan, ``keys.setup`` / ``add`` / ``mount`` /
``setDefault``, then ``files.encryptFiles`` three times (a password with
AES-256-GCM, a ``key_uuid`` with XChaCha20-Poly1305, both erasing the
originals; a ``key_uuid`` with AES-256-GCM and the sealed metadata, keeping
them), a rescan, a decrypt with a wrong password, ``files.decryptFiles``
with the same keys, a rescan. The randomness is seeded in both packages
(``tests/torch_crypto_cases.seed_crypto``) and Argon2id runs at
``CHEAP_ARGON2`` in both. After each step the rows (every file_path column
but ids, pub_ids, inode, device and times; the object's kind; the grouping
into objects) equal the JAX node's, and so do the job reports. The
``.bytes`` files without metadata are byte-equal; those with it differ only
in the object's pub_id each node seals, so their cas_ids are compared for
presence only, and each header's metadata opens to its own node's cas_id
and object pub_id. Each package decrypts the other's ``.bytes`` files. A
wrong password leaves no plaintext and no partial file.

Besides: every ``keys.*`` procedure answers as the JAX router does, errors
included; an encrypt job paused and cold-resumed with a ``key_uuid``
finishes, and no checkpoint of a password job holds the password; the
port's server shell refuses each of the five ``SECRET_PROCEDURES`` without
auth over GET, POST and the websocket, and serves them with it.
"""

import base64
import io
import json
import threading
import time
import urllib.request
from pathlib import Path

import pytest

from spacedrive_tpu.crypto import header as jax_header
from spacedrive_tpu.crypto import primitives as jax_primitives
from spacedrive_tpu.crypto import stream as jax_stream
from spacedrive_tpu.locations import create_location as jax_create_location
from spacedrive_tpu.locations.indexer_job import IndexerJob as JaxIndexerJob
from spacedrive_tpu.node import Node as JaxNode
from spacedrive_tpu.objects.file_identifier import FileIdentifierJob as JaxIdentifierJob
from spacedrive_tpu_torch.api.routers.keys import SECRET_PROCEDURES
from spacedrive_tpu_torch.crypto import header, primitives, stream
from spacedrive_tpu_torch.jobs import JobStatus
from spacedrive_tpu_torch.locations import create_location
from spacedrive_tpu_torch.locations.indexer_job import IndexerJob
from spacedrive_tpu_torch.models import JobRow
from spacedrive_tpu_torch.node import Node
from spacedrive_tpu_torch.objects import crypto_jobs
from spacedrive_tpu_torch.objects.file_identifier import FileIdentifierJob
from spacedrive_tpu_torch.server import Server
from tests.torch_crypto_cases import cheap_argon2, seed_crypto
from tests.torch_scan_cases import blob, one_torch_thread  # noqa: F401
from tests.torch_serve_client import WsClient, get, post

#: (path, size); the groups below encrypt all but the last
TREE = [("a.txt", 700), ("b.bin", 40 << 10), ("f.json", 5 << 10), ("big.bin", (2 << 20) + 12345),
        ("sub/c.jpg", 90 << 10), ("sub/d.bin", 150 << 10), ("sub/e.pdf", 600 << 10),
        ("sub/g.mp3", 300 << 10), ("sub/plain.txt", 333)]
#: name -> (sources, encryptFiles arguments, key: "password" or "key_uuid")
GROUPS = {
    "password": (["a.txt", "sub/d.bin", "big.bin"],
                 {"algorithm": "Aes256Gcm", "erase_original": True}, "password"),
    "key": (["b.bin", "sub/e.pdf"],
            {"algorithm": "XChaCha20Poly1305", "erase_original": True}, "key_uuid"),
    "metadata": (["f.json", "sub/g.mp3"],
                 {"algorithm": "Aes256Gcm", "metadata": True, "erase_original": False},
                 "key_uuid"),
}
PASSWORD = "hunter2-s3cret"


def make_tree(root: Path) -> Path:
    for i, (rel, size) in enumerate(TREE):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_bytes(blob(100 + i, size))
    return root


def original(rel: str) -> bytes:
    i = [r for r, _ in TREE].index(rel)
    return blob(100 + i, TREE[i][1])


def rows(db, masked: set) -> tuple:
    """Every file_path column but ids, pub_ids, inode, device and times,
    the object's kind, and the grouping into objects; the cas_id of a
    path in ``masked`` is compared for presence only."""
    out = []
    for r in db.query(
            "SELECT fp.is_dir, fp.cas_id, fp.integrity_checksum, fp.materialized_path, "
            "fp.name, fp.extension, fp.hidden, fp.size_in_bytes, fp.key_id, o.kind "
            "FROM file_path fp LEFT JOIN object o ON fp.object_id = o.id"):
        r = list(tuple(r))
        rel = f"{r[3].strip('/')}/{r[4]}.{r[5]}".lstrip("/")
        if rel in masked:
            r[1] = r[1] is not None
        out.append(tuple(r))
    groups: dict = {}
    for r in db.query("SELECT materialized_path, name, extension, object_id FROM file_path "
                      "WHERE object_id IS NOT NULL"):
        groups.setdefault(r["object_id"], []).append(tuple(r)[:3])
    return sorted(out, key=repr), sorted(sorted(g) for g in groups.values())


def fp_id(db, rel: str) -> int:
    mp, _, leaf = rel.rpartition("/")
    name, ext = leaf.rsplit(".", 1)
    return db.query("SELECT id FROM file_path WHERE materialized_path = ? AND name = ? "
                    "AND extension = ?", [f"/{mp}/" if mp else "/", name, ext])[0]["id"]


def scan(node, lib, loc, jobs) -> None:
    node.jobs.spawn(lib, [job({"location_id": loc["id"]}) for job in jobs])
    assert node.jobs.wait_idle(120)


def last_job(lib) -> tuple:
    row = dict(lib.db.query("SELECT * FROM job ORDER BY rowid DESC LIMIT 1")[0])
    meta = row["metadata"]
    meta = json.loads(meta) if isinstance(meta, (str, bytes)) else (meta or {})
    return row["name"], row["status"], {k: v for k, v in meta.items() if k != "trace"}, \
        row["errors_text"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both packages through the whole flow; returns what each step left."""
    base = tmp_path_factory.mktemp("crypto_jobs")
    got = {"steps": {}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SD_P2P_DISABLED", "1")
        cheap_argon2(mp)
        jnode = JaxNode(base / "jax", probe_accelerator=False, watch_locations=False)
        pnode = Node(base / "port", device="cpu", watch_locations=False)
        sides = {}
        try:
            for pkg, node, create, jobs, kw in (
                    ("jax", jnode, jax_create_location, (JaxIndexerJob, JaxIdentifierJob),
                     {"hasher": "cpu"}),
                    ("port", pnode, create_location, (IndexerJob, FileIdentifierJob), {})):
                tree = make_tree(base / f"tree_{pkg}")
                lib = node.libraries.create(pkg)
                loc = create(lib, tree, **kw)
                scan(node, lib, loc, jobs)
                sides[pkg] = {"node": node, "lib": lib, "loc": loc, "tree": tree, "jobs": jobs}
            got["sides"] = sides

            def step(name: str, masked: set = frozenset()) -> None:
                got["steps"][name] = {pkg: rows(s["lib"].db, masked) for pkg, s in sides.items()}

            step("scan")
            before = {pkg: {r["name"] + "." + r["extension"]: dict(r) for r in s["lib"].db.query(
                "SELECT fp.name, fp.extension, fp.cas_id, fp.integrity_checksum, "
                "o.pub_id AS object_pub_id FROM file_path fp "
                "LEFT JOIN object o ON o.id = fp.object_id WHERE fp.is_dir = 0")}
                for pkg, s in sides.items()}
            got["before"] = before

            seed_crypto(mp, 1)
            keys = {}
            for pkg, s in sides.items():
                r = s["node"].router.resolve
                assert r("keys.setup", "master-pw") is True
                kid = r("keys.add", {"name": "files"})
                assert r("keys.mount", kid) is True and r("keys.setDefault", kid) is True
                keys[pkg] = (kid, s["node"].key_manager.get_key(kid).expose())
            assert keys["jax"][1] == keys["port"][1]
            got["keys"] = keys

            reports = {}
            for n, (name, (sources, args, how)) in enumerate(GROUPS.items()):
                seed_crypto(mp, 10 + n)
                for pkg, s in sides.items():
                    secret = PASSWORD if how == "password" else keys[pkg][0]
                    s["node"].router.resolve("files.encryptFiles", {
                        "sources": [fp_id(s["lib"].db, rel) for rel in sources],
                        how: secret, **args}, library_id=s["lib"].id)
                    assert s["node"].jobs.wait_idle(120)
                    reports.setdefault(pkg, []).append(last_job(s["lib"]))
            got["encrypt_reports"] = reports
            sealed = {f"{rel}.bytes" for rel in GROUPS["metadata"][0]}
            step("encrypted", sealed)
            got["bytes"] = {pkg: {f"{rel}.bytes": (s["tree"] / f"{rel}.bytes").read_bytes()
                                  for g in GROUPS.values() for rel in g[0]}
                            for pkg, s in sides.items()}
            got["left"] = {pkg: sorted(str(p.relative_to(s["tree"]))
                                       for p in s["tree"].rglob("*") if p.is_file()
                                       and p.name != ".spacedrive")
                           for pkg, s in sides.items()}

            for pkg, s in sides.items():
                scan(s["node"], s["lib"], s["loc"], s["jobs"])
            step("rescanned", sealed)

            reports = {}
            for pkg, s in sides.items():
                s["node"].router.resolve("files.decryptFiles", {
                    "sources": [fp_id(s["lib"].db, "a.txt.bytes")], "password": "wrong"},
                    library_id=s["lib"].id)
                assert s["node"].jobs.wait_idle(120)
                reports[pkg] = [last_job(s["lib"])]
                got.setdefault("after_wrong", {})[pkg] = sorted(
                    p.name for p in s["tree"].iterdir() if p.is_file())
                for name, (sources, args, how) in GROUPS.items():
                    secret = PASSWORD if how == "password" else keys[pkg][0]
                    s["node"].router.resolve("files.decryptFiles", {
                        "sources": [fp_id(s["lib"].db, f"{rel}.bytes") for rel in sources],
                        how: secret, "erase_original": args["erase_original"]},
                        library_id=s["lib"].id)
                    assert s["node"].jobs.wait_idle(120)
                    reports[pkg].append(last_job(s["lib"]))
            got["decrypt_reports"] = reports
            step("decrypted", sealed)
            for pkg, s in sides.items():
                scan(s["node"], s["lib"], s["loc"], s["jobs"])
            step("final", sealed)
            got["final"] = {pkg: {str(p.relative_to(s["tree"])): p.read_bytes()
                                  for p in s["tree"].rglob("*")
                                  if p.is_file() and p.name != ".spacedrive"}
                            for pkg, s in sides.items()}
            got["after"] = {pkg: {r["name"] + "." + r["extension"]: r["cas_id"]
                                  for r in s["lib"].db.query(
                                      "SELECT name, extension, cas_id FROM file_path "
                                      "WHERE is_dir = 0")}
                            for pkg, s in sides.items()}
            yield got
        finally:
            jnode.shutdown()
            pnode.shutdown()


@pytest.mark.parametrize("step", ["scan", "encrypted", "rescanned", "decrypted", "final"])
def test_rows_match_jax(run, step):
    assert run["steps"][step]["port"] == run["steps"][step]["jax"]


def test_reports_match_jax(run):
    for what in ("encrypt_reports", "decrypt_reports"):
        reports = {pkg: [(n, st, meta, (err or "").replace(str(run["sides"][pkg]["tree"]),
                                                           "<tree>"))
                         for n, st, meta, err in rs]
                   for pkg, rs in run[what].items()}
        assert reports["port"] == reports["jax"], what
    wrong = run["decrypt_reports"]["port"][0]
    assert wrong[1] == JobStatus.COMPLETED_WITH_ERRORS and "incorrect password" in wrong[3]
    # a tag a 1 MiB block, an empty file one block
    payload = [sum(n + 16 * max(1, -(-n // primitives.BLOCK_LEN))
                   for rel, n in TREE if rel in sources) for sources, _a, _h in GROUPS.values()]
    assert [r[2] for r in run["encrypt_reports"]["port"]] == [
        {"encrypted": len(g[0]), "bytes": n} for g, n in zip(GROUPS.values(), payload)]


def test_bytes_files_equal_without_metadata(run):
    for rel, data in run["bytes"]["port"].items():
        assert data[:7] == b"sdtpenc", rel
        if rel[:-len(".bytes")] not in GROUPS["metadata"][0]:
            assert data == run["bytes"]["jax"][rel], rel
        else:
            assert len(data) == len(run["bytes"]["jax"][rel]), rel
    assert run["left"]["port"] == run["left"]["jax"]
    assert "a.txt" not in run["left"]["port"] and "f.json" in run["left"]["port"]


def test_metadata_opens_to_each_nodes_own_row(run):
    for pkg, mods in (("port", (header, primitives)), ("jax", (jax_header, jax_primitives))):
        hmod, prim = mods
        for rel in GROUPS["metadata"][0]:
            h, _off = hmod.FileHeader.from_bytes(run["bytes"][pkg][f"{rel}.bytes"])
            master = h.decrypt_master_key(prim.Protected(run["keys"][pkg][1]))
            meta = h.decrypt_metadata(master)
            leaf = rel.rsplit("/", 1)[-1]
            row = run["before"][pkg][leaf]
            assert meta == {"name": leaf, "size": len(original(rel)),
                            "cas_id": row["cas_id"], "object_pub_id": row["object_pub_id"]}
    assert run["before"]["port"]["f.json"]["object_pub_id"] != \
        run["before"]["jax"]["f.json"]["object_pub_id"]


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_each_package_decrypts_the_others_files(run, reader):
    writer = "jax" if reader == "port" else "port"
    hmod, smod, prim = ((header, stream, primitives) if reader == "port"
                        else (jax_header, jax_stream, jax_primitives))
    for name, (sources, _args, how) in GROUPS.items():
        secret = PASSWORD.encode() if how == "password" else run["keys"][writer][1]
        for rel in sources:
            buf = io.BytesIO(run["bytes"][writer][f"{rel}.bytes"])
            h = hmod.FileHeader.from_reader(buf)
            master = h.decrypt_master_key(prim.Protected(secret))
            out = io.BytesIO()
            smod.Decryptor.decrypt_streams(master, h.nonce, h.algorithm, buf, out, h.aad())
            assert out.getvalue() == original(rel), (name, rel)


def test_rescan_identifies_the_bytes_files(run):
    rows_, _groups = run["steps"]["rescanned"]["port"]
    enc = [r for r in rows_ if r[5] == "bytes"]
    assert len(enc) == sum(len(g[0]) for g in GROUPS.values())
    assert all(r[1] for r in enc)  # a cas_id each (True where masked)
    plain_ids = {r["cas_id"] for r in run["before"]["port"].values()}
    unmasked = [r[1] for r in enc if r[1] is not True]
    assert unmasked and not set(unmasked) & plain_ids
    # the light rescan of the job inserts rows without a cas_id
    rows_e, _ = run["steps"]["encrypted"]["port"]
    assert all(r[1] in (None, False) for r in rows_e if r[5] == "bytes")


def test_wrong_password_leaves_no_plaintext(run):
    for pkg in ("port", "jax"):
        names = run["after_wrong"][pkg]
        assert "a.txt" not in names and "a.txt.bytes" in names, names


def test_decrypted_files_round_trip(run):
    final = run["final"]["port"]
    assert final.keys() == run["final"]["jax"].keys()
    for name, (sources, args, _how) in GROUPS.items():
        for rel in sources:
            assert final[rel] == original(rel)
            assert (f"{rel}.bytes" in final) is (not args["erase_original"])
            if not args["erase_original"]:  # the original stayed: a second name
                stem, ext = rel.rsplit(".", 1)
                assert final[f"{stem} (2).{ext}"] == original(rel)
    for leaf, cas in run["before"]["port"].items():
        assert run["after"]["port"][leaf] == cas["cas_id"], leaf


# ---------------------------------------------------------------------------
# the keys router against the JAX router
# ---------------------------------------------------------------------------

def _answers(node, keystore_dir: Path) -> list:
    """A script of keys.* calls in every state; answers and errors, the
    stored keys' uuids replaced by their order of creation."""
    uuids: list[str] = []
    out = []

    def call(key, arg=None):
        try:
            value = node.router.resolve(key, arg)
        except Exception as e:  # both packages' ApiError
            value = ("error", type(e).__name__, str(e))
        text = json.dumps(value, sort_keys=True, default=str).replace(str(keystore_dir), "<dir>")
        if key == "keys.add" and isinstance(value, str):
            uuids.append(value)
        for i, u in enumerate(uuids):
            text = text.replace(u, f"<key{i}>")
        out.append((key, text))
        return value

    ghost = "00000000-0000-4000-8000-000000000000"
    call("keys.isSetup")
    call("keys.isUnlocked")
    call("keys.unlockKeyManager", "pw")
    call("keys.list")
    call("keys.add", {"name": "too early"})
    call("keys.setup", "master-pw")
    call("keys.setup", "again")
    call("keys.isSetup")
    k1 = call("keys.add", {"name": "one"})
    k2 = call("keys.add", "two")
    call("keys.list")
    call("keys.mount", ghost)
    call("keys.setDefault", ghost)
    call("keys.updateAutomountStatus", {"uuid": ghost, "status": True})
    call("keys.setDefault", k2)
    call("keys.getDefault")
    call("keys.updateAutomountStatus", {"uuid": k1, "status": True})
    call("keys.getKey", k1)
    call("keys.listMounted")
    call("keys.unmount", k2)
    call("keys.listMounted")
    call("keys.unmountAll")
    call("keys.isKeyManagerUnlocking")
    call("keys.lockKeyManager")
    call("keys.isUnlocked")
    call("keys.getKey", k1)
    call("keys.unlockKeyManager", "wrong")
    call("keys.unlockKeyManager", "master-pw")
    call("keys.listMounted")
    call("keys.changeMasterPassword", {"current": "wrong", "new": "x"})
    call("keys.changeMasterPassword", {"current": "master-pw", "new": "new-pw"})
    call("keys.clearMasterPassword")
    call("keys.isUnlocked")
    call("keys.getKey", k1)
    call("keys.add", "needs the root")
    call("keys.unlockKeyManager", "new-pw")
    call("keys.backupKeystore", str(keystore_dir / "backup.json"))
    call("keys.deleteFromLibrary", k2)
    call("keys.list")
    call("keys.restoreKeystore", {"path": str(keystore_dir / "backup.json"), "password": "x"})
    call("keys.restoreKeystore", {"path": str(keystore_dir / "backup.json"),
                                  "password": "new-pw"})
    call("keys.restoreKeystore", {"path": str(keystore_dir / "missing.json"),
                                  "password": "new-pw"})
    call("keys.list")
    call("keys.disableAutoUnlock")
    return out


def test_every_keys_procedure_answers_as_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("SD_P2P_DISABLED", "1")
    cheap_argon2(monkeypatch)
    jnode = JaxNode(tmp_path / "jax", probe_accelerator=False, watch_locations=False)
    pnode = Node(tmp_path / "port", device="cpu", watch_locations=False)
    try:
        keys = sorted(k for k in pnode.router.procedures if k.startswith("keys."))
        assert keys == sorted(k for k in jnode.router.procedures if k.startswith("keys."))
        assert len(keys) == 23
        seed_crypto(monkeypatch, 5)
        want = _answers(jnode, tmp_path / "jax")
        got = _answers(pnode, tmp_path / "port")
        assert got == want
        assert {k for k, _ in got} == set(keys) - {"keys.enableAutoUnlock"}
        for node in (jnode, pnode):
            assert node.router.resolve("keys.enableAutoUnlock") in ("kernel-keyring", "file")
            assert node.router.resolve("keys.disableAutoUnlock") is True
    finally:
        jnode.shutdown()
        pnode.shutdown()


def test_procedures_without_a_key_manager(tmp_path, monkeypatch):
    monkeypatch.setenv("SD_P2P_DISABLED", "1")
    node = Node(tmp_path / "port", device="cpu", watch_locations=False)
    try:
        node.key_manager = None
        with pytest.raises(Exception, match="no key manager on this node"):
            node.router.resolve("keys.isSetup")
    finally:
        node.shutdown()


# ---------------------------------------------------------------------------
# pause, cold resume and checkpoints
# ---------------------------------------------------------------------------

class _Gate:
    """Holds the encrypt job's second file until released."""

    def __init__(self, monkeypatch) -> None:
        self.entered, self.release, self.calls = threading.Event(), threading.Event(), 0
        real = crypto_jobs.Encryptor.encrypt_streams.__func__

        def held(cls, *a, **kw):
            self.calls += 1
            if self.calls == 2:
                self.entered.set()
                assert self.release.wait(30)
            return real(cls, *a, **kw)

        monkeypatch.setattr(crypto_jobs.Encryptor, "encrypt_streams", classmethod(held))


def _paused(node, lib, job_id: str, gate: _Gate) -> dict:
    assert gate.entered.wait(30)
    assert node.jobs.pause(job_id)
    gate.release.set()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        row = lib.db.find_one(JobRow, {"id": job_id})
        if row["status"] == JobStatus.PAUSED:
            return row
        time.sleep(0.02)
    raise AssertionError(f"job not paused: {row['status']}")


def _job_blobs(db) -> bytes:
    out = b""
    for row in db.query("SELECT data, metadata, errors_text FROM job"):
        for value in row:
            if value:
                out += value if isinstance(value, bytes) else str(value).encode()
    return out


def test_paused_job_cold_resumes_with_a_key_and_never_keeps_a_password(tmp_path, monkeypatch):
    monkeypatch.setenv("SD_P2P_DISABLED", "1")
    cheap_argon2(monkeypatch)
    tree = tmp_path / "tree"
    tree.mkdir()
    for i in range(4):
        (tree / f"k{i}.bin").write_bytes(blob(200 + i, 3000 + i))
        (tree / f"p{i}.bin").write_bytes(blob(300 + i, 2000 + i))
    data = tmp_path / "data"
    node = Node(data, device="cpu", watch_locations=False)
    try:
        lib = node.libraries.create("enc")
        loc = create_location(lib, tree)
        scan(node, lib, loc, (IndexerJob, FileIdentifierJob))
        r = node.router.resolve
        r("keys.setup", "master-pw")
        kid = r("keys.add", {"name": "k"})
        r("keys.updateAutomountStatus", {"uuid": kid, "status": True})
        r("keys.enableAutoUnlock")
        key = node.key_manager.get_key(kid).expose()

        gate = _Gate(monkeypatch)
        job_id = r("files.encryptFiles", {
            "sources": [fp_id(lib.db, f"p{i}.bin") for i in range(4)],
            "password": PASSWORD, "erase_original": True}, library_id=lib.id)
        row = _paused(node, lib, job_id, gate)
        assert PASSWORD.encode() not in _job_blobs(lib.db)
        checkpoint = json.loads(row["data"])
        assert checkpoint["step_number"] == 2 and "password" not in checkpoint["init_args"]
        assert node.jobs.resume(lib, job_id)
        assert node.jobs.wait_idle(60)
        row = lib.db.find_one(JobRow, {"id": job_id})
        assert row["status"] == JobStatus.FAILED and "needs a password" in row["errors_text"]
        assert PASSWORD.encode() not in _job_blobs(lib.db)

        monkeypatch.undo()
        monkeypatch.setenv("SD_P2P_DISABLED", "1")
        cheap_argon2(monkeypatch)
        gate = _Gate(monkeypatch)
        job_id = r("files.encryptFiles", {
            "sources": [fp_id(lib.db, f"k{i}.bin") for i in range(4)],
            "key_uuid": kid, "algorithm": "Aes256Gcm", "erase_original": True},
            library_id=lib.id)
        checkpoint = json.loads(_paused(node, lib, job_id, gate)["data"])
        assert checkpoint["init_args"]["key_uuid"] == kid and checkpoint["step_number"] == 2
        lib_id = lib.id
    finally:
        node.shutdown()
    node = Node(data, device="cpu", watch_locations=False)  # cold resume at boot
    try:
        assert node.key_manager.is_unlocked
        assert node.jobs.wait_idle(60)
        lib = node.libraries.get(lib_id)
        row = lib.db.find_one(JobRow, {"id": job_id})
        assert row["status"] == JobStatus.COMPLETED, row["errors_text"]
        for i in range(4):
            assert not (tree / f"k{i}.bin").exists()
            with open(tree / f"k{i}.bin.bytes", "rb") as fh:
                h = header.FileHeader.from_reader(fh)
                out = io.BytesIO()
                stream.Decryptor.decrypt_streams(h.decrypt_master_key(primitives.Protected(key)),
                                                 h.nonce, h.algorithm, fh, out, h.aad())
            assert out.getvalue() == blob(200 + i, 3000 + i)
        node.router.resolve("keys.disableAutoUnlock")
    finally:
        node.shutdown()


# ---------------------------------------------------------------------------
# the server shell's gate
# ---------------------------------------------------------------------------

def _args(tmp: Path, kid: str) -> dict:
    return {"keys.getKey": kid, "keys.backupKeystore": str(tmp / "backup.json"),
            "keys.restoreKeystore": {"path": str(tmp / "backup.json"),
                                     "password": "master-pw"},
            "keys.enableAutoUnlock": None, "keys.disableAutoUnlock": None}


def test_shell_refuses_secret_procedures_without_auth(tmp_path, monkeypatch):
    monkeypatch.setenv("SD_P2P_DISABLED", "1")
    cheap_argon2(monkeypatch)
    node = Node(tmp_path / "data", device="cpu", watch_locations=False)
    try:
        node.router.resolve("keys.setup", "master-pw")
        kid = node.router.resolve("keys.add", {"name": "k"})
        node.key_manager.backup_keystore(tmp_path / "backup.json")
        args = _args(tmp_path, kid)
        assert set(args) == SECRET_PROCEDURES
        server = Server(node, "127.0.0.1", 0)
        server.start()
        url = f"http://127.0.0.1:{server.port}"
        try:
            ws = WsClient("127.0.0.1", server.port)
            for key, arg in args.items():
                kind = node.router.procedures[key].kind
                q = "" if arg is None else "?arg=" + urllib.request.quote(json.dumps(arg))
                status, _h, body = get(url, f"/rspc/{key}{q}")
                if kind == "query":
                    assert status == 400 and b"without auth" in body, (key, body)
                else:
                    assert status == 405, (key, status)  # GET never runs a mutation
                status, body = post(url, f"/rspc/{key}", {"arg": arg})
                assert status == 400 and b"without auth" in body, (key, body)
                reply = ws.call(kind, key, arg)["result"]
                assert reply["type"] == "error" and "without auth" in reply["data"]["message"]
            ws.close()
            assert not (tmp_path / "data" / "keyring.json").exists()
        finally:
            server.stop()

        server = Server(node, "127.0.0.1", 0, auth="user:pass")
        server.start()
        url = f"http://127.0.0.1:{server.port}"
        good = {"Authorization": "Basic " + base64.b64encode(b"user:pass").decode()}
        try:
            key_b64 = base64.b64encode(node.key_manager.get_key(kid).expose()).decode()
            q = "?arg=" + urllib.request.quote(json.dumps(kid))
            status, _h, body = get(url, f"/rspc/keys.getKey{q}", good)
            assert status == 200 and json.loads(body)["result"] == key_b64
            answers = {}
            for key, arg in args.items():
                req = urllib.request.Request(
                    f"{url}/rspc/{key}", data=json.dumps({"arg": arg}).encode(),
                    headers={"content-type": "application/json", **good}, method="POST")
                with urllib.request.urlopen(req, timeout=60) as resp:
                    answers[key] = json.loads(resp.read())["result"]
            assert answers["keys.getKey"] == key_b64
            assert answers["keys.backupKeystore"] == 1
            assert answers["keys.restoreKeystore"] == 0
            assert answers["keys.enableAutoUnlock"] in ("kernel-keyring", "file")
            assert answers["keys.disableAutoUnlock"] is True
            ws = WsClient("127.0.0.1", server.port, headers=good)
            reply = ws.call("query", "keys.getKey", kid)["result"]
            assert reply == {"type": "response", "data": key_b64}
            ws.close()
        finally:
            server.stop()
    finally:
        node.shutdown()


# ---------------------------------------------------------------------------
# a row matched by inode under another name, its content changed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rescan", ["indexer", "light"])
def test_a_file_on_a_matched_inode_gets_its_own_checksum(tmp_path, monkeypatch, rescan):
    """A file renamed and changed keeps its inode, which is how the walker
    sees a new file on a freed inode (the crypto jobs write one file and
    unlink another). The port clears the row's integrity_checksum with its
    cas_id, and the validator then stores the new file's; the reference
    keeps the old file's, which the validator never replaces. A file
    changed in place under its own name keeps its checksum in both."""
    from spacedrive_tpu.locations import light_scan_location as jax_light_scan
    from spacedrive_tpu.objects.validator import ObjectValidatorJob as JaxValidatorJob
    from spacedrive_tpu_torch.locations import light_scan_location
    from spacedrive_tpu_torch.objects.blake3_ref import blake3
    from spacedrive_tpu_torch.objects.validator import ObjectValidatorJob

    monkeypatch.setenv("SD_P2P_DISABLED", "1")
    jnode = JaxNode(tmp_path / "jax", probe_accelerator=False, watch_locations=False)
    pnode = Node(tmp_path / "port", device="cpu", watch_locations=False)
    got = {}
    try:
        for pkg, node, create, jobs, validator, light in (
                ("jax", jnode, jax_create_location, (JaxIndexerJob, JaxIdentifierJob),
                 JaxValidatorJob, jax_light_scan),
                ("port", pnode, create_location, (IndexerJob, FileIdentifierJob),
                 ObjectValidatorJob, light_scan_location)):
            tree = tmp_path / f"tree_{pkg}"
            tree.mkdir()
            (tree / "old.bin").write_bytes(blob(1, 3000))
            (tree / "kept.bin").write_bytes(blob(2, 3000))
            lib = node.libraries.create(pkg)
            loc = create(lib, tree, **({"hasher": "cpu"} if pkg == "jax" else {}))
            scan(node, lib, loc, jobs)
            node.jobs.spawn(lib, [validator({"location_id": loc["id"]})])
            assert node.jobs.wait_idle(60)
            (tree / "old.bin").rename(tree / "new.bin")
            with open(tree / "new.bin", "ab") as fh:
                fh.write(b"appended")
            with open(tree / "kept.bin", "ab") as fh:
                fh.write(b"appended")
            if rescan == "light":
                light(lib, loc["id"], "")
            scan(node, lib, loc, jobs)
            node.jobs.spawn(lib, [validator({"location_id": loc["id"]})])
            assert node.jobs.wait_idle(60)
            got[pkg] = {r["name"]: r["integrity_checksum"] for r in lib.db.query(
                "SELECT name, integrity_checksum FROM file_path WHERE is_dir = 0")}
    finally:
        jnode.shutdown()
        pnode.shutdown()
    new = blake3(blob(1, 3000) + b"appended").hex()
    old, kept = blake3(blob(1, 3000)).hex(), blake3(blob(2, 3000)).hex()
    assert got["port"] == {"new": new, "kept": kept}
    assert got["jax"] == {"new": old, "kept": kept}  # the reference's stale checksum
