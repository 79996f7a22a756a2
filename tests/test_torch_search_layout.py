"""The arithmetic of the search kernels (spacedrive_tpu_torch/csrc/search.cu),
replayed in numpy and held to the port's plain versions and to the JAX
package.

The CUDA kernels cannot run here, so these tests replay what each thread and
warp of them computes:

- ``substring_kernel``: the row's 4-byte windows formed by funnel shifts
  over adjacent words, the gram filter (the needle's first min(L, 4) bytes,
  masked below 4) into a 64-bit candidate mask bounded by j <= W-L, and for
  L > 4 the verify of the needle's other bytes a word at a time on the
  staged row: by the row's own lane where it has at most four candidate
  offsets, else by its warp, one lane per offset (lane and lane + 32);
- ``exact_kernel``: four rows a thread, a row read only where its key
  equals the needle's, the four flags stored as one little-endian word; with
  the index's key (``row_keys``) and with weak keys that force collisions;
- the index's key columns equal ``row_keys`` of its rows after build,
  upsert, delete, ``index_from_jax`` and a mirror patch.

Outputs are bits, so every comparison is exact (tolerance zero).
"""

import numpy as np
import pytest
import torch

from spacedrive_tpu.search import columnar as jax_columnar
from spacedrive_tpu.search import kernels as jax_kernels
from spacedrive_tpu_torch.search import columnar, kernels
from tests.test_torch_search import LOADER_ROWS, loader_rows
from tests.torch_search_cases import (WARP, birthday_pair, seeded_values, substring_cases,
                                      value_rows)

# the kernels' launch constants (csrc/search.cu)
MAX_NEEDLE = 48
MAX_WIDTH = 96
LANE_OFFSETS = 4
STAGED_WORDS = 17
EXACT_ROWS = 4


def needle_words(raw: bytes) -> np.ndarray:
    """The by-value ``Needle``: zero-padded to 96 bytes, as u32 words."""
    padded = np.zeros(MAX_WIDTH, dtype=np.uint8)
    padded[: len(raw)] = np.frombuffer(raw, dtype=np.uint8)
    return padded.view("<u4").astype(np.uint64)


def gram_candidates(rows: np.ndarray, needle: bytes) -> np.ndarray:
    """Each row's 64-bit candidate mask: bit j where the window at j equals
    the gram, for j <= W-L."""
    n, width = rows.shape
    L = len(needle)
    w = np.zeros((n, width // 4 + 1), dtype=np.uint64)  # the word past the row is 0
    w[:, : width // 4] = rows.view("<u4")
    g = min(L, 4)
    gmask = np.uint64(0xFFFFFFFF if g == 4 else (1 << (8 * g)) - 1)
    gram = needle_words(needle)[0] & gmask
    cand = np.zeros(n, dtype=np.uint64)
    for j in range(width):
        i, s = j >> 2, j & 3
        win = w[:, i] if s == 0 else (
            (w[:, i] >> np.uint64(8 * s)) | (w[:, i + 1] << np.uint64(32 - 8 * s))
        ) & np.uint64(0xFFFFFFFF)
        cand |= (((win ^ gram) & gmask) == 0).astype(np.uint64) << np.uint64(j)
    last = width - L
    in_bound = (1 << 64) - 1 if last >= 63 else (1 << (last + 1)) - 1
    return cand & np.uint64(in_bound)


def verify_at(row: np.ndarray, nw: np.ndarray, L: int, j: int) -> bool:
    """``verify_at``: the needle's bytes 4..L-1 against the staged row's
    bytes j+4.., a word at a time; ``row`` is the 17 staged words."""
    for k in range(4, L, 4):
        p = j + k
        a, b = int(row[p >> 2]), int(row[(p >> 2) + 1])
        win = ((b << 32 | a) >> (8 * (p & 3))) & 0xFFFFFFFF  # __funnelshift_r
        mask = 0xFFFFFFFF if L - k >= 4 else (1 << (8 * (L - k))) - 1
        if (win ^ int(nw[k >> 2])) & mask:
            return False
    return True


def substring_replay(rows: np.ndarray, needle: bytes) -> np.ndarray:
    """What ``substring_kernel`` writes for each row, warp by warp; also
    counts the rows verified by their own lane and by their warp."""
    n, width = rows.shape
    L = len(needle)
    substring_replay.by_lane = substring_replay.by_warp = 0
    if not 1 <= L <= min(width, MAX_NEEDLE):
        return np.zeros(n, dtype=bool)  # the wrapper launches nothing
    cand = gram_candidates(rows, needle)
    hit = cand != 0
    if L <= 4:
        return hit
    hit[:] = False
    nw = needle_words(needle)
    staged = np.zeros((n, STAGED_WORDS), dtype=np.uint64)  # word 16 past the row: 0
    staged[:, : width // 4] = rows.view("<u4")
    offsets = np.array([bin(int(c)).count("1") for c in cand])
    for r in np.flatnonzero((offsets > 0) & (offsets <= LANE_OFFSETS)):  # the row's own lane
        substring_replay.by_lane += 1
        c = int(cand[r])
        while c and not hit[r]:
            hit[r] = verify_at(staged[r], nw, L, (c & -c).bit_length() - 1)
            c &= c - 1
    for first in range(0, n, WARP):  # the warp, rows r - lane .. r - lane + 31
        lanes = np.arange(first, min(first + WARP, n))
        for src in lanes[offsets[lanes] > LANE_OFFSETS]:  # ascending, as __ffs takes them
            substring_replay.by_warp += 1
            c = int(cand[src])
            ok = [bool(c >> j & 1) and verify_at(staged[src], nw, L, j) for j in range(64)]
            hit[src] = any(ok)
    return hit


def exact_replay(rows: np.ndarray, keys: np.ndarray, needle: bytes, key: int) -> np.ndarray:
    """What ``exact_kernel`` writes: four rows a thread, a row's bytes read
    only where its key equals ``key``."""
    n, width = rows.shape
    if len(needle) > width:
        return np.zeros(n, dtype=bool)  # the wrapper launches nothing
    padded = np.zeros(width, dtype=np.uint8)
    padded[: len(needle)] = np.frombuffer(needle, dtype=np.uint8)
    out = np.full(n, 0xAB, dtype=np.uint8)  # torch.empty: every byte must be written
    reads = 0
    for r0 in range(0, n, EXACT_ROWS):
        if r0 + EXACT_ROWS <= n:
            flags = np.uint32(0)
            for i in range(EXACT_ROWS):
                if keys[r0 + i] == key:
                    reads += 1
                    if (rows[r0 + i] == padded).all():
                        flags |= np.uint32(1 << (8 * i))
            out[r0 : r0 + EXACT_ROWS] = np.array([flags], dtype="<u4").view(np.uint8)
        else:
            for r in range(r0, n):
                reads += int(keys[r] == key)
                out[r] = keys[r] == key and (rows[r] == padded).all()
    assert set(np.unique(out)) <= {0, 1}
    exact_replay.reads = reads
    return out.astype(bool)


@pytest.mark.parametrize("case", substring_cases(), ids=lambda c: c[0])
def test_substring_replay_matches_plain_and_jax(case):
    _label, rows, needle = case
    got = substring_replay(rows, needle)
    plain = kernels.substring(torch.from_numpy(rows), needle).numpy()
    assert np.array_equal(got, plain)
    want = jax_kernels.substring_np(np.ascontiguousarray(rows.T), needle)
    if not 1 <= len(needle) <= kernels.MAX_NEEDLE:
        want[:] = False  # the device entry points' contract (substring_jnp)
    assert np.array_equal(got, want)


def test_substring_edge_cases_are_not_vacuous():
    cases = {label: (rows, needle) for label, rows, needle in substring_cases()}
    hits = {label: int(substring_replay(*cases[label]).sum()) for label in cases}
    assert all(hits[f"L{L}"] > 0 for L in (1, 2, 3, 4, 5))
    assert hits["offset-0-and-W-L"] == 2 and hits["common-gram"] == 0
    rows, needle = cases["common-gram"]
    assert (gram_candidates(rows, needle) != 0).sum() > len(rows) // 4
    rows, needle = cases["every-offset-L6"]
    assert hits["every-offset-L6"] == 0
    assert int(gram_candidates(rows, needle)[0]) == (1 << 59) - 1  # j <= 58 = W-L
    assert hits["every-offset-match"] >= len(rows) // 3 and hits["high-bytes"] > 0
    # both verify paths run: a row's own lane, and its warp
    substring_replay(*cases["every-offset-L6"])
    assert substring_replay.by_lane > 0 and substring_replay.by_warp >= len(rows) // 3


@pytest.mark.parametrize("L", [1, 2, 3, 4, 7, 17, 48])
def test_substring_replay_on_corpus_names(L):
    """Names shaped like the search benchmark's corpus, needles cut from
    them (a match, and the same needle with its last byte changed)."""
    rng = np.random.default_rng(L)
    words = ["report", "photo", "invoice", "holiday", "budget", "meeting", "render", "design"]
    names = [f"{rng.choice(words)}-{rng.choice(words)}-{i:07d}.pdf".encode()
             for i in range(700)]
    rows = value_rows(names, 64)
    for needle in (names[3][:L], names[3][:L - 1] + b"#"):
        assert np.array_equal(substring_replay(rows, needle),
                              kernels.substring_plain(torch.from_numpy(rows), needle).numpy())


# -- exact ---------------------------------------------------------------------


def test_row_keys_are_a_multiply_shift_hash():
    rows = np.random.default_rng(1).integers(0, 256, size=(50, 96), dtype=np.uint8)
    keys = kernels.row_keys(rows)
    assert keys.dtype == np.int32
    for row, key in zip(rows, keys):
        words = [int.from_bytes(bytes(row[4 * i : 4 * i + 4]), "little") for i in range(24)]
        h = sum(w * int(m) for w, m in zip(words, kernels.KEY_MULTIPLIERS)) % (1 << 64)
        assert (h >> 32) == int(key) & 0xFFFFFFFF
    assert (kernels.row_keys(np.zeros((3, 12), np.uint8)) == 0).all()
    for width in (12, 96):
        row = np.zeros((1, width), np.uint8)
        row[0, :3] = [ord("p"), ord("n"), ord("g")]
        assert kernels.needle_key(b"png", width) == int(kernels.row_keys(row)[0])
    with pytest.raises(ValueError):
        kernels.row_keys(np.zeros((1, 10), np.uint8))


@pytest.mark.parametrize("width", [12, 96])
def test_exact_replay_matches_plain_and_jax(width):
    values = seeded_values(width, 2, n=8 * WARP + 7)  # n not a multiple of 4
    rows = value_rows(values, width)
    keys = kernels.row_keys(rows)
    planes = np.ascontiguousarray(rows.T)
    for needle in (values[3], values[10], values[0][:width], b"", b"x" * (width + 1)):
        got = exact_replay(rows, keys, needle, kernels.needle_key(needle[:width], width)
                           if len(needle) <= width else 0)
        assert np.array_equal(got, kernels.exact_plain(torch.from_numpy(rows), needle).numpy())
        assert np.array_equal(got, jax_kernels.exact_np(planes, needle)), needle


@pytest.mark.parametrize("width", [12, 96])
def test_exact_replay_with_forced_collisions(width):
    """A planted pair of different rows with one key (the needle is one, the
    other sits in the column), and weak keys under which every row, or every
    row with the needle's first byte, collides: a collision costs reads,
    never a wrong answer."""
    values = seeded_values(width, 5, n=301)
    rows = value_rows(values, width)
    a, b = birthday_pair(width, width)
    rows[17], rows[200] = a, b
    needle = bytes(b).rstrip(b"\x00")
    plain = kernels.exact_plain(torch.from_numpy(rows), needle).numpy()
    assert plain[200] and not plain[17]
    keys = kernels.row_keys(rows)
    key = kernels.needle_key(needle, width)
    assert keys[17] == keys[200] == key
    assert np.array_equal(exact_replay(rows, keys, needle, key), plain)
    assert exact_replay.reads >= 2
    for weak, weak_key in ((np.zeros(len(rows), np.int32), 0),
                           (rows[:, 0].astype(np.int32), needle[0])):
        assert np.array_equal(exact_replay(rows, weak, needle, weak_key), plain)
    assert exact_replay(rows, np.zeros(len(rows), np.int32), needle, 0).sum() == plain.sum()
    assert exact_replay.reads == len(rows)


# -- the index's key columns ------------------------------------------------------


def assert_keys_current(idx) -> None:
    idx.refresh_keys()
    assert not idx._stale_keys
    for key, (attr, build) in columnar.ColumnarIndex.KEYS.items():
        got, want = getattr(idx, key), build(getattr(idx, attr))
        assert got.dtype == want.dtype and got.shape == (idx.cap,)
        assert np.array_equal(got, want), key


def test_index_keys_follow_build_upsert_delete_and_jax():
    rows = loader_rows()
    idx = columnar.ColumnarIndex()
    idx.build(rows)
    assert_keys_current(idx)
    assert (idx.path_key[: idx.n] != 0).all()  # every path row is non-empty
    before = idx.path_key[3]
    assert idx.upsert(dict(rows[3], materialized_path="/moved/here/", extension="tar"))
    assert idx.path_key[3] == before and idx._stale_keys == [3]  # until refresh_keys
    assert idx.upsert(dict(rows[4], extension=None))  # NULL: a zero row, key 0
    for k in range(5000):  # past the capacity: the key columns grow with the rest
        assert idx.upsert(dict(rows[0], id=LOADER_ROWS + 1 + k, extension=f"e{k % 7}"))
    idx.delete_id(20)
    assert_keys_current(idx)
    assert idx.ext_key[idx.slot_of(5)] == 0
    ref = jax_columnar.ColumnarIndex()
    ref.build(rows)
    converted, fresh = columnar.index_from_jax(ref), columnar.ColumnarIndex()
    fresh.build(rows)
    assert_keys_current(converted)
    for key in columnar.ColumnarIndex.KEYS:
        assert np.array_equal(getattr(converted, key), getattr(fresh, key)), key


def test_mirror_keys_follow_the_patch_and_match_the_rows():
    rows = loader_rows()
    idx = columnar.ColumnarIndex()
    idx.build(rows)
    mirror = columnar.DeviceMirror("cpu")
    mirror.sync(idx)
    idx.upsert(dict(rows[7], materialized_path="/patched/", extension="mkv"))
    idx.upsert(dict(rows[0], id=LOADER_ROWS + 1, materialized_path="/new/"))
    mirror.sync(idx)
    assert (mirror.uploads, mirror.patches) == (1, 1)
    arr = mirror.arrays
    for key, rows_key in (("path_key", "path"), ("ext_key", "ext")):
        want = kernels.row_keys(arr[rows_key].numpy())  # padding rows included
        assert arr[key].dtype == torch.int32
        assert np.array_equal(arr[key].numpy(), want), key
    pred, _ = columnar.parse_predicate({"materialized_path": "/patched/", "extensions": ["mkv"]})
    got = columnar.eval_mask_device(idx, mirror, pred)
    assert got.sum() == 1 and got[idx.slot_of(8)]
