"""Near-duplicate detection over indexed files: the MinHash ops as a job.

Counterpart of ``spacedrive_tpu/objects/dedup.py``. Exact duplicates
collapse into one object at identify time; this module finds near
duplicates (edited, truncated or re-encoded copies) among the files over
100 KiB: the native gather reads each file's sampled cas message into a row
(pinned on the card), the device computes MinHash signatures
(:func:`..ops.minhash.minhash_rows`), and either the device all-pairs sweep
or, above ``ALL_PAIRS_LIMIT`` rows, host LSH banding with exact
verification finds the similar pairs. :class:`DedupDetectorJob` persists
them into ``near_duplicate``; :func:`persisted_near_duplicate_groups` reads
them back. There is no ``ensure_jax_safe`` counterpart: a device error
raises.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import TYPE_CHECKING, Any

import numpy as np
import torch

from ..jobs import EarlyFinish, JobError, StatefulJob, StepResult
from ..models import FilePath, Location, NearDuplicate, utc_now
from ..native import cas_native
from ..ops import minhash
from .cas import MINIMUM_FILE_SIZE, SAMPLED_MESSAGE_LEN

if TYPE_CHECKING:
    from ..library import Library

logger = logging.getLogger(__name__)

SAMPLED_STRIDE = ((SAMPLED_MESSAGE_LEN + 1023) // 1024) * 1024  # 58368

#: above this row count the all-pairs device sweep gives way to LSH banding
#: (candidate buckets + exact verification): O(N * BANDS), not O(N**2 * K)
ALL_PAIRS_LIMIT = 8192

#: files per signature pass (gather + minhash)
SIG_BATCH = 8192


def _paths_of(db, rows_db) -> tuple[list[str], list[int]]:
    paths, sizes = [], []
    roots: dict[int, Path] = {}
    for r in rows_db:
        loc = r["location_id"]
        if loc not in roots:
            row = db.find_one(Location, {"id": loc})
            if row is None:
                raise JobError(f"location {loc} not found")
            roots[loc] = Path(row["path"])
        rel = (r["materialized_path"] or "/").lstrip("/")
        name = r["name"] + (f".{r['extension']}" if r["extension"] else "")
        paths.append(str(roots[loc] / rel / name))
        sizes.append(r["size_in_bytes"])
    return paths, sizes


def _signatures(paths: list[str], sizes: list[int], errors: list[str],
                device: torch.device) -> tuple[np.ndarray, np.ndarray]:
    """(n, K) uint32 MinHash signatures and the gathered lengths, in
    SIG_BATCH passes so the corpus size never bounds host or device memory.
    A row the native gather could not read (length 0) is an error, as in
    the reference: no Python re-read."""
    n = len(paths)
    sigs = np.zeros((n, minhash.K), np.uint32)
    lengths = np.zeros(n, np.int32)
    pin = device.type == "cuda"
    for start in range(0, n, SIG_BATCH):
        stop = min(n, start + SIG_BATCH)
        buf = torch.zeros((stop - start, SAMPLED_STRIDE), dtype=torch.uint8, pin_memory=pin)
        lens = torch.zeros(stop - start, dtype=torch.int32, pin_memory=pin)
        cas_native.gather_batch(paths[start:stop], sizes[start:stop], buf.numpy(), lens.numpy())
        got = minhash.minhash_rows(buf.view(torch.int32).to(device, non_blocking=True),
                                   lens.to(device, non_blocking=True))
        sigs[start:stop] = got.cpu().numpy().astype(np.uint32)
        lengths[start:stop] = lens.numpy()
    errors += [paths[i] for i in range(n) if lengths[i] == 0]
    return sigs, lengths


def find_near_duplicates(library: "Library", location_id: int | None = None,
                         threshold: float = 0.8, limit: int = ALL_PAIRS_LIMIT,
                         method: str = "auto") -> dict[str, Any]:
    """Similarity groups among sampled-size files on the library's node
    device. Returns ``{groups: [[file_path rows]], pairs, scanned, method,
    errors}``.

    ``method``: ``all_pairs`` (the device O(N**2 K) sweep), ``banded`` (LSH
    candidate buckets + exact verification), or ``auto`` (all-pairs up to
    ALL_PAIRS_LIMIT rows, banded beyond)."""
    db = library.db
    where = "is_dir = 0 AND size_in_bytes > ?"
    params: list[Any] = [MINIMUM_FILE_SIZE]
    if location_id is not None:
        where += " AND location_id = ?"
        params.append(location_id)
    rows_db = [FilePath.decode_row(r) for r in db.query(
        f"SELECT * FROM file_path WHERE {where} ORDER BY id LIMIT ?", params + [limit])]
    n = len(rows_db)
    if n < 2:
        return {"groups": [], "pairs": [], "scanned": n, "errors": [], "method": "none"}
    if method == "auto":
        method = "all_pairs" if n <= ALL_PAIRS_LIMIT else "banded"

    errors: list[str] = []
    paths, sizes = _paths_of(db, rows_db)
    device = library.node.device
    sigs, lengths = _signatures(paths, sizes, errors, device)
    thr_k = max(1, int(threshold * minhash.K))

    if method == "banded":
        if threshold < 0.7:
            # BANDS / BAND_ROWS are tuned for the 0.8 default; recall falls
            # at low thresholds (about 0.64 at s = 0.5): say so
            errors.append(
                f"banded LSH recall degrades below threshold 0.7 "
                f"(requested {threshold}); pairs near the threshold may "
                "be missed — force method='all_pairs' for exhaustive "
                "comparison")
        raw_pairs = _banded_pairs(sigs, lengths > 0, thr_k, errors)
    else:
        raw_pairs = _all_pairs(sigs, lengths > 0, thr_k, device)

    # union-find grouping from verified pairs
    parent = list(range(n))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i, j, _m in raw_pairs:
        parent[find(j)] = find(i)

    # collapse cliques to spanning pairs: each row keeps only its best
    # match, so a family of 200 files emits at most 199 rows
    best: dict[int, tuple[int, int]] = {}
    for i, j, m in raw_pairs:
        for x, y in ((i, j), (j, i)):
            if m > best.get(x, (0, -1))[0]:
                best[x] = (m, y)
    edges: dict[tuple[int, int], int] = {}
    for x, (m, y) in best.items():
        key = (x, y) if x < y else (y, x)
        if m > edges.get(key, 0):
            edges[key] = m
    pairs = [{"a": rows_db[i], "b": rows_db[j], "similarity": float(m) / minhash.K}
             for (i, j), m in sorted(edges.items())]

    members: dict[int, list[int]] = {}
    linked = {i for i, _j, _m in raw_pairs} | {j for _i, j, _m in raw_pairs}
    for i in linked:
        members.setdefault(find(i), []).append(i)
    out_groups = [[rows_db[i] for i in sorted(ids)]
                  for ids in members.values() if len(ids) > 1]
    return {"groups": out_groups, "pairs": pairs, "scanned": n,
            "errors": errors, "method": method}


def _all_pairs(sigs: np.ndarray, valid_rows: np.ndarray, thr_k: int,
               device: torch.device) -> list[tuple[int, int, int]]:
    """The device all-pairs sweep → verified (i, j, matches) pairs."""
    n = sigs.shape[0]
    sigs_p, valid = minhash.pad_for_blocks(sigs)
    valid[:n] &= valid_rows
    _total, dup = minhash.similar_pairs_count(
        torch.from_numpy(sigs_p.astype(np.int64)).to(device),
        torch.from_numpy(valid).to(device), thr_k)
    dup = dup.cpu().numpy()[:n]
    out: list[tuple[int, int, int]] = []
    for i in range(n):
        if not dup[i]:
            continue
        eq = (sigs[i][None, :] == sigs[:i]).sum(axis=1)
        eq[~valid_rows[:i]] = 0
        j = int(np.argmax(eq))
        if eq[j] >= thr_k:
            out.append((j, i, int(eq[j])))
    return out


def _banded_pairs(sigs: np.ndarray, valid_rows: np.ndarray, thr_k: int,
                  errors: list[str]) -> list[tuple[int, int, int]]:
    """LSH banding: bucket by band keys, exact-verify the candidates."""
    keys = minhash.band_keys(sigs)
    cand, oversized = minhash.banded_candidate_pairs(keys, valid_rows)
    if oversized:
        errors.append(
            f"{oversized} oversized LSH buckets collapsed to "
            "representative pairing (members compared against one "
            "representative instead of all-pairs)")
    return minhash.verify_pairs(sigs, cand, thr_k)


def persisted_near_duplicate_groups(db, location_id: int | None = None,
                                    limit: int = 1000) -> dict[str, Any]:
    """Similarity groups from the persisted ``near_duplicate`` pairs the
    chained :class:`DedupDetectorJob` wrote: database reads only.

    The shape of :func:`find_near_duplicates`'s result: ``{groups: [[file_path
    rows]], pairs, scanned, method: "persisted", errors: []}``, ``scanned``
    counting the pair rows read. Ordering is deterministic: similarity
    descending then pair id; members by id; groups by their smallest member
    id."""
    where, params = "1=1", []
    if location_id is not None:
        where = "(fa.location_id = ? OR fb.location_id = ?)"
        params = [location_id, location_id]
    limit = max(0, min(int(limit), 5000))
    pair_rows = db.query(
        f"SELECT nd.id, nd.file_path_a_id AS a, nd.file_path_b_id AS b, "
        f"nd.similarity FROM near_duplicate nd "
        f"JOIN file_path fa ON nd.file_path_a_id = fa.id "
        f"JOIN file_path fb ON nd.file_path_b_id = fb.id "
        f"WHERE {where} ORDER BY nd.similarity DESC, nd.id LIMIT ?",
        params + [limit])

    parent: dict[int, int] = {}

    def find(x: int) -> int:
        parent.setdefault(x, x)
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    pairs = []
    for r in pair_rows:
        parent[find(int(r["b"]))] = find(int(r["a"]))
        pairs.append({"a": int(r["a"]), "b": int(r["b"]), "similarity": r["similarity"]})
    ids = sorted(parent)
    rows_by_id: dict[int, dict] = {}
    if ids:
        marks = ",".join("?" for _ in ids)
        rows_by_id = {r["id"]: FilePath.decode_row(r) for r in db.query(
            f"SELECT * FROM file_path WHERE id IN ({marks})", ids)}
    members: dict[int, list[int]] = {}
    for i in ids:
        members.setdefault(find(i), []).append(i)
    groups = [[rows_by_id[i] for i in sorted(group) if i in rows_by_id]
              for _root, group in sorted(members.items(), key=lambda kv: min(kv[1]))
              if len(group) > 1]
    return {"groups": [g for g in groups if len(g) > 1], "pairs": pairs,
            "scanned": len(pair_rows), "method": "persisted", "errors": []}


class DedupDetectorJob(StatefulJob):
    """The scan's chained near-duplicate stage: persists the pairs into
    ``near_duplicate``. Up to ALL_PAIRS_LIMIT files take the device
    all-pairs sweep, larger locations LSH banding, up to DEVICE_LIMIT files
    a pass; beyond that the window is cut, with a warning."""

    NAME = "dedup_detector"

    #: rows per detection pass (signatures stream through the device in
    #: SIG_BATCH batches; banding keeps candidate generation linear)
    DEVICE_LIMIT = 131072

    def init(self, ctx):
        db = ctx.library.db
        location_id = self.init_args["location_id"]
        count = db.query(
            "SELECT COUNT(*) n FROM file_path WHERE is_dir = 0 "
            "AND location_id = ? AND size_in_bytes > ?",
            [location_id, MINIMUM_FILE_SIZE])[0]["n"]
        if count < 2:
            raise EarlyFinish("not enough sampled-size files for dedup")
        if count > self.DEVICE_LIMIT:
            logger.warning(
                "dedup_detector: location %s has %d eligible files; only the "
                "first %d are compared this pass", location_id, count, self.DEVICE_LIMIT)
        data = {"location_id": location_id,
                "threshold": float(self.init_args.get("threshold", 0.8))}
        return data, [{"kind": "detect"}], {"pairs_found": 0, "scanned": 0}

    def execute_step(self, ctx, data, step, step_number):
        db = ctx.library.db
        result = find_near_duplicates(ctx.library, data["location_id"],
                                      threshold=data["threshold"], limit=self.DEVICE_LIMIT)
        rows = []
        for pair in result["pairs"]:
            a, b = pair["a"]["id"], pair["b"]["id"]
            rows.append({"file_path_a_id": min(a, b), "file_path_b_id": max(a, b),
                         "similarity": pair["similarity"], "date_detected": utc_now()})
        with db.transaction():
            # a rescan refreshes the location's pair set
            db.execute("DELETE FROM near_duplicate WHERE file_path_a_id IN "
                       "(SELECT id FROM file_path WHERE location_id = ?)",
                       [data["location_id"]])
            if rows:
                db.insert_many(NearDuplicate, rows, or_ignore=True)
        return StepResult(metadata={"pairs_found": len(rows), "scanned": result["scanned"],
                                    "method": result["method"]},
                          errors=[str(e) for e in result["errors"]])

    def finalize(self, ctx, data, run_metadata):
        ctx.library.emit("invalidate_query", {"key": "search.duplicates"})
        return run_metadata
