"""The port's MinHash near-duplicate stage (spacedrive_tpu_torch/ops/minhash.py,
objects/dedup.py) against the JAX package's, on the CPU.

- ``minhash_rows`` on seeded rows with words >= 2**31 and lengths 0, 7, 8
  and 16,383: the signatures equal the reference's; so do those of the
  card's int32 form, run here on the CPU, from each word carrier.
- ``similar_pairs_count`` (total and flags) with pairs that meet
  ``threshold_k`` exactly and pairs one short of it, beside the numpy
  version; ``band_keys``, ``banded_candidate_pairs`` (an oversized bucket
  included) and ``verify_pairs``.
- A tree with exact copies, edited copies and a family of three: after
  ``scan_location`` the ``near_duplicate`` rows and
  ``persisted_near_duplicate_groups`` equal the JAX Node's, and
  ``find_near_duplicates`` with either method equals the reference's. File
  ids differ between the packages, so rows compare by path.

Signatures and counts are integers, so every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacedrive_tpu.locations import create_location as jax_create_location
from spacedrive_tpu.locations import scan_location as jax_scan_location
from spacedrive_tpu.node import Node as JaxNode
from spacedrive_tpu.objects import dedup as jax_dedup
from spacedrive_tpu.ops import minhash as jax_minhash
from spacedrive_tpu_torch.api.routers import search as router
from spacedrive_tpu_torch.jobs import JobStatus
from spacedrive_tpu_torch.locations import create_location, scan_location
from spacedrive_tpu_torch.node import Node
from spacedrive_tpu_torch.objects import dedup
from spacedrive_tpu_torch.ops import minhash

W = 58368 // 4  # words of a sampled row


def test_constants_match_the_reference():
    for name in ("K", "BLOCK", "BANDS", "BAND_ROWS", "MAX_BUCKET"):
        assert getattr(minhash, name) == getattr(jax_minhash, name)
    for name in ("_A", "_B", "_C"):
        assert np.array_equal(getattr(minhash, name), getattr(jax_minhash, name))
    for name in ("SAMPLED_STRIDE", "ALL_PAIRS_LIMIT", "SIG_BATCH"):
        assert getattr(dedup, name) == getattr(jax_dedup, name)
    assert dedup.DedupDetectorJob.DEVICE_LIMIT == jax_dedup.DedupDetectorJob.DEVICE_LIMIT


def test_minhash_rows_match_the_reference():
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 1 << 32, (8, W), dtype=np.uint64).astype(np.uint32)
    rows[1, :64] = 0x80000000  # words at and past 2**31
    rows[2, :64] = 0xFFFFFFFF
    lengths = np.array([0, 7, 8, 16383, 58368, 9, 57352, 1 << 20], np.int32)
    assert (rows >= 1 << 31).mean() > 0.4
    want = np.asarray(jax_minhash.minhash_rows(jnp.asarray(rows), jnp.asarray(lengths)))
    got = minhash.minhash_rows(torch.from_numpy(rows.view(np.int32)), torch.from_numpy(lengths))
    assert got.dtype == torch.int64 and got.shape == (8, minhash.K)
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    # the carrier of the words does not matter
    again = minhash.minhash_rows(torch.from_numpy(rows.astype(np.int64)), torch.from_numpy(lengths))
    assert torch.equal(again, got)
    with pytest.raises(ValueError):
        minhash.minhash_rows(torch.zeros((2, 3), dtype=torch.int32), torch.zeros(2))


@pytest.mark.parametrize("carrier", [np.int32, np.int64, np.uint32])
def test_int32_form_matches_the_reference(carrier):
    """The card's form of the signatures (int32 bit patterns: wrapping
    products, masked arithmetic shifts, the min through a sign flip), run on
    the CPU, equals the reference's on words at and past 2**31."""
    rng = np.random.default_rng(6)
    rows = rng.integers(0, 1 << 32, (6, 512), dtype=np.uint64).astype(np.uint32)
    rows[1] = 0x80000000
    rows[2] = 0xFFFFFFFF
    rows[3, ::2] = 0x7FFFFFFF
    lengths = np.array([0, 7, 8, 2048, 1000, 15], np.int32)
    want = np.asarray(jax_minhash.minhash_rows(jnp.asarray(rows), jnp.asarray(lengths)))
    words = rows.view(np.int32) if carrier is np.int32 else rows.astype(carrier)
    got = minhash._minhash_pass_i32(torch.from_numpy(words), torch.from_numpy(lengths))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    assert got.max() >= 1 << 31  # the unsigned order held past the sign bit


def pair_sigs(threshold_k: int) -> tuple[np.ndarray, np.ndarray]:
    """600 rows (two BLOCKs once padded): rows 3/4 share exactly
    ``threshold_k`` components, rows 10/11 one fewer, rows 20, 21 and 550 are
    equal (a pair across blocks), row 30 equals row 31 but is invalid."""
    rng = np.random.default_rng(threshold_k)
    sigs = rng.integers(0, 1 << 32, (600, minhash.K), dtype=np.uint64).astype(np.uint32)
    sigs[4, :threshold_k] = sigs[3, :threshold_k]
    sigs[11, : threshold_k - 1] = sigs[10, : threshold_k - 1]
    sigs[21] = sigs[20]
    sigs[550] = sigs[20]
    sigs[31] = sigs[30]
    valid = np.ones(600, bool)
    valid[30] = False
    return sigs, valid


@pytest.mark.parametrize("threshold_k", [51, 64])
def test_similar_pairs_count_matches_the_reference(threshold_k):
    sigs, valid_rows = pair_sigs(threshold_k)
    padded, valid = minhash.pad_for_blocks(sigs)
    valid[:600] &= valid_rows
    assert padded.shape[0] == 1024
    want_total, want_dup = jax_minhash.similar_pairs_count(
        jnp.asarray(padded), jnp.asarray(valid), threshold_k)
    total, dup = minhash.similar_pairs_count(torch.from_numpy(padded.astype(np.int64)),
                                             torch.from_numpy(valid), threshold_k)
    assert total.dtype == torch.int64
    assert int(total) == int(want_total) == 4  # (3,4), (20,21), (20,550), (21,550)
    assert np.array_equal(dup.numpy(), np.asarray(want_dup))
    assert list(np.flatnonzero(dup.numpy())) == [4, 21, 550]
    cpu_total, cpu_dup = minhash.similar_pairs_count_cpu(padded, valid, threshold_k)
    assert cpu_total == 4 and np.array_equal(cpu_dup, dup.numpy())
    with pytest.raises(ValueError, match="multiple of BLOCK"):
        minhash.similar_pairs_count(torch.from_numpy(sigs.astype(np.int64)),
                                    torch.from_numpy(valid_rows), threshold_k)


def test_banding_and_verification_match_the_reference():
    sigs, valid = pair_sigs(51)
    # an oversized bucket: 300 rows sharing band 0, different elsewhere
    sigs[100:400, : minhash.BAND_ROWS] = sigs[100, : minhash.BAND_ROWS]
    keys = minhash.band_keys(sigs)
    assert np.array_equal(keys, jax_minhash.band_keys(sigs))
    pairs, oversized = minhash.banded_candidate_pairs(keys, valid)
    want_pairs, want_oversized = jax_minhash.banded_candidate_pairs(keys, valid)
    assert oversized == want_oversized == 1
    assert np.array_equal(pairs, want_pairs)
    assert len(pairs) >= 299
    for thr in (51, 64):
        got = minhash.verify_pairs(sigs, pairs, thr)
        assert got == jax_minhash.verify_pairs(sigs, want_pairs, thr)
        assert got == minhash.verify_pairs(sigs, {tuple(p) for p in pairs.tolist()}, thr)
    assert (3, 4, 51) in minhash.verify_pairs(sigs, pairs, 51)
    assert minhash.verify_pairs(sigs, set(), 51) == []
    with pytest.raises(ValueError):
        minhash.banded_candidate_pairs(keys, valid[:10])


def blob(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, size=n, dtype=np.uint8).tobytes()


def make_dedup_tree(root):
    """Files over 100 KiB: an original with an exact copy and an edited
    copy (4 KiB of its header sample changed: similarity below 1), a
    family of three with 2 KiB edits in different places, unrelated files;
    and small files the detector skips."""
    (root / "a").mkdir(parents=True)
    (root / "b").mkdir()
    base = blob(1, 300_000)
    (root / "a" / "orig.bin").write_bytes(base)
    (root / "b" / "copy.bin").write_bytes(base)
    edited = bytearray(base)
    edited[100:4196] = blob(2, 4096)  # half the header sample
    (root / "b" / "edited.bin").write_bytes(bytes(edited))
    fam = blob(3, 180_000)
    for i in range(3):  # 2 KiB edits, each in another place
        member = bytearray(fam)
        member[1000 + 3000 * i : 3048 + 3000 * i] = blob(10 + i, 2048)
        (root / "a" / f"fam{i}.bin").write_bytes(bytes(member))
    for i in range(4):
        (root / "b" / f"other{i}.bin").write_bytes(blob(20 + i, 120_000 + 5000 * i))
    (root / "a" / "small.txt").write_bytes(blob(30, 5000))
    (root / "a" / "small_copy.txt").write_bytes(blob(30, 5000))
    return root


def path_of(db) -> dict:
    return {r["id"]: r["materialized_path"] + r["name"] + (f".{r['extension']}" if r["extension"] else "")
            for r in db.query("SELECT id, materialized_path, name, extension FROM file_path")}


def near_rows(db) -> list:
    paths = path_of(db)
    return sorted((paths[r["file_path_a_id"]], paths[r["file_path_b_id"]], r["similarity"])
                  for r in db.query("SELECT * FROM near_duplicate"))


def by_path(result: dict, paths: dict) -> tuple:
    """A groups result with ids replaced by paths."""
    groups = [[paths[r["id"]] for r in g] for g in result["groups"]]
    pairs = []
    for p in result["pairs"]:
        a, b = p["a"], p["b"]
        a, b = (paths[a["id"]], paths[b["id"]]) if isinstance(a, dict) else (paths[a], paths[b])
        pairs.append((a, b, p["similarity"]))
    return groups, pairs, result["scanned"], result["method"], result["errors"]


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """Both Nodes scan the tree through ``scan_location``; returns what each
    persisted and found, by path."""
    base = tmp_path_factory.mktemp("dedup")
    tree = make_dedup_tree(base / "tree")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SD_P2P_DISABLED", "1")
        node = JaxNode(base / "jax", probe_accelerator=False, watch_locations=False)
        try:
            lib = node.libraries.create("jax")
            loc = jax_create_location(lib, tree)
            jax_scan_location(lib, loc["id"])
            assert node.jobs.wait_idle(120)
            paths = path_of(lib.db)
            out["jax"] = {
                "rows": near_rows(lib.db),
                "persisted": by_path(jax_dedup.persisted_near_duplicate_groups(lib.db), paths),
                **{m: by_path(jax_dedup.find_near_duplicates(lib, loc["id"], method=m), paths)
                   for m in ("all_pairs", "banded")}}
        finally:
            node.shutdown()
        node = Node(base / "port", device="cpu")
        try:
            lib = node.libraries.create("port")
            loc = create_location(lib, tree)
            scan_location(lib, loc["id"])
            assert node.jobs.wait_idle(120)
            paths = path_of(lib.db)
            job = lib.db.query("SELECT * FROM job WHERE name = 'dedup_detector'")[0]
            persisted = dedup.persisted_near_duplicate_groups(lib.db)
            out["port"] = {
                "rows": near_rows(lib.db), "persisted": by_path(persisted, paths),
                "router": router.near_duplicates(node, lib, {}) == persisted,
                "job": (job["status"], job["metadata"]),
                **{m: by_path(dedup.find_near_duplicates(lib, loc["id"], method=m), paths)
                   for m in ("all_pairs", "banded")}}
        finally:
            node.shutdown()
    return out


def test_near_duplicate_rows_match_the_jax_node(scans):
    rows = scans["port"]["rows"]
    assert rows == scans["jax"]["rows"]
    assert ("/a/", "/b/copy.bin", 1.0) not in rows  # paths are whole
    assert ("/a/orig.bin", "/b/copy.bin", 1.0) in rows
    assert any(a == "/a/orig.bin" and b == "/b/edited.bin" and 0.8 <= s < 1.0
               for a, b, s in rows)
    assert not any("small" in a or "other" in a or "other" in b for a, b, _s in rows)
    status, _meta = scans["port"]["job"]
    assert status == JobStatus.COMPLETED


def test_persisted_groups_match_the_jax_node(scans):
    groups, pairs, scanned, method, errors = scans["port"]["persisted"]
    assert scans["port"]["persisted"] == scans["jax"]["persisted"]
    assert method == "persisted" and not errors and scanned == len(pairs) > 0
    assert ["/a/fam0.bin", "/a/fam1.bin", "/a/fam2.bin"] in groups
    assert ["/a/orig.bin", "/b/copy.bin", "/b/edited.bin"] in groups
    assert scans["port"]["router"]


@pytest.mark.parametrize("method", ["all_pairs", "banded"])
def test_find_near_duplicates_matches_the_reference(scans, method):
    got = scans["port"][method]
    assert got == scans["jax"][method]
    groups, _pairs, scanned, used, _errors = got
    assert used == method and scanned == 10
    assert len(groups) == 2


def test_scan_of_a_sub_path_skips_the_detector(tmp_path):
    tree = make_dedup_tree(tmp_path / "tree")
    node = Node(tmp_path / "port", device="cpu")
    try:
        lib = node.libraries.create("port")
        loc = create_location(lib, tree)
        scan_location(lib, loc["id"], sub_path="a")
        assert node.jobs.wait_idle(120)
        names = {r["name"] for r in lib.db.query("SELECT name FROM job")}
        assert names == {"indexer", "file_identifier", "media_processor"}
    finally:
        node.shutdown()
