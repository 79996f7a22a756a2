"""The seeded tree of the pipeline tests and the row comparison of the port's
scan tests, without jax: the on-card tests import it too.

``rows_of`` is the comparison of ``tests/test_torch_scan.py``:
``(materialized_path, name, extension, size, cas_id, kind)`` per path, the
grouping of files into objects, and the manifest rows per cas_id.
"""

from pathlib import Path

import numpy as np


def blob(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, size=n, dtype=np.uint8).tobytes()


def rows_of(db):
    paths = sorted(tuple(r) for r in db.query(
        "SELECT fp.materialized_path, fp.name, fp.extension, fp.size_in_bytes, "
        "fp.cas_id, o.kind FROM file_path fp LEFT JOIN object o ON fp.object_id = o.id"))
    groups: dict = {}
    for r in db.query("SELECT materialized_path, name, extension, object_id FROM file_path "
                      "WHERE object_id IS NOT NULL"):
        groups.setdefault(r["object_id"], []).append(tuple(r)[:3])
    manifests: dict = {}
    for r in db.query("SELECT DISTINCT fp.cas_id, cm.seq, cm.chunk_hash, cm.length "
                      "FROM chunk_manifest cm JOIN file_path fp ON fp.object_id = cm.object_id "
                      "ORDER BY fp.cas_id, cm.seq"):
        manifests.setdefault(r["cas_id"], []).append(tuple(r)[1:])
    return paths, sorted(sorted(g) for g in groups.values()), manifests


#: files a page in both packages: the tree spans five pages
PAGE = 16
EXTS = ["txt", "jpg", "json", "", "pdf", "mp3", "bin", "xyz"]


def make_tree(root: Path) -> Path:
    """80 files in five pages of 16: five directories of 14 files of 1 B-1000 B
    and one empty file each, a sampled-class file of 120 KB in d3, and
    copies of one file in d0 and d1 (two pages of one commit group of 4)
    and of another in d2 and d4 (two groups)."""
    rng = np.random.default_rng(11)
    seed = 0
    for d in range(5):
        (root / f"d{d}").mkdir(parents=True)
        for i in range(14):
            seed += 1
            ext = EXTS[seed % len(EXTS)]
            name = f"f{i:02d}.{ext}" if ext else f"f{i:02d}"
            (root / f"d{d}" / name).write_bytes(blob(seed, int(rng.integers(1, 1000))))
        (root / f"d{d}" / "zz_empty.txt").write_bytes(b"")
    (root / "d3" / "f99.bin").write_bytes(blob(900, 120_000))
    for a, b, seed in (("d0", "d1", 901), ("d2", "d4", 902)):
        dup = blob(seed, 700)
        (root / a / "dup.txt").write_bytes(dup)
        (root / b / "dup.txt").write_bytes(dup)
    return root


def page_of(db) -> dict:
    """(materialized_path, name) → page number in the fixed-page schedule."""
    rows = db.query("SELECT materialized_path, name FROM file_path WHERE is_dir = 0 "
                    "AND name != '' ORDER BY id")
    return {(r["materialized_path"], r["name"]): i // PAGE for i, r in enumerate(rows)}
