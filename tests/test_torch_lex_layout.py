"""The arithmetic of the range kernel (``lex_kernel`` in
spacedrive_tpu_torch/csrc/search.cu), replayed in numpy and held to the JAX
package's ``lex_cmp_np``, and the index's ``date_prefix`` column it reads.

The CUDA kernel cannot run here, so this replays what each thread of it
computes: four rows a thread, each row's 8-byte prefix (``date_prefix_of``:
its first 8 bytes, big-endian) compared as uint64 with the bound's, and
only where they tie the row's bytes 8..39 read 8 bytes at a time and
compared word by word (bytes swapped so that an unsigned compare is memcmp)
up to the first word that differs; the four int8 verdicts stored as one
little-endian word, and a tail of fewer than four rows one row at a time.

Outputs are integers, so every comparison is exact (tolerance zero).
"""

import numpy as np
import pytest
import torch

from spacedrive_tpu.search import columnar as jax_columnar
from spacedrive_tpu.search import kernels as jax_kernels
from spacedrive_tpu_torch.search import columnar, kernels
from tests.test_torch_search import LOADER_ROWS, loader_rows
from tests.torch_search_cases import LEX_BOUND, LEX_BOUNDS, lex_rows, seeded_values, value_rows
from tests.torch_scan_cases import one_torch_thread  # noqa: F401

# the kernel's launch constants (csrc/search.cu)
KEYED_ROWS = 4
PREFIX_WORDS = 2
MAX_WIDTH = 96


def bswap(word: int) -> int:
    """``__byte_perm(word, 0, 0x0123)``."""
    return int.from_bytes(word.to_bytes(4, "little"), "big")


def lex_replay(rows: np.ndarray, prefix: np.ndarray, bound: bytes,
               signed: bool = False) -> np.ndarray:
    """What ``lex_kernel`` writes for each row; ``lex_replay.reads`` counts
    the rows it read past their prefix. ``signed`` compares the prefixes as
    int64 instead, the trap the kernel avoids."""
    n, width = rows.shape
    clipped = bound[:width]
    padded = np.zeros(MAX_WIDTH, dtype=np.uint8)  # the by-value Needle
    padded[: len(clipped)] = np.frombuffer(clipped, dtype=np.uint8)
    nw = [int(w) for w in padded.view("<u4")]
    bp = kernels.bound_prefix(bound, width)
    if signed:
        bp = int(np.uint64(bp).view(np.int64))
    lex_replay.reads = 0

    def verdict(r: int) -> int:
        p = int(prefix[r]) if signed else int(prefix[r].view(np.uint64))
        if p != bp:
            return 1 if p > bp else -1
        lex_replay.reads += 1
        words = rows[r].view("<u4")
        for i in range(PREFIX_WORDS, width // 4, 2):  # one 8-byte load
            for j in (i, i + 1):
                if int(words[j]) != nw[j]:
                    return 1 if bswap(int(words[j])) > bswap(nw[j]) else -1
        return 0

    out = np.full(n, 0x5A, dtype=np.uint8)  # torch.empty: every byte must be written
    for r0 in range(0, n, KEYED_ROWS):
        if r0 + KEYED_ROWS <= n:
            word = 0
            for i in range(KEYED_ROWS):
                word |= (verdict(r0 + i) & 0xFF) << (8 * i)
            out[r0 : r0 + KEYED_ROWS] = np.array([word], dtype="<u4").view(np.uint8)
        else:
            for r in range(r0, n):
                out[r] = verdict(r) & 0xFF
    return out.view(np.int8)


def ties(rows: np.ndarray, bound: bytes) -> int:
    """Rows whose first 8 bytes equal the zero-padded bound's."""
    padded = np.zeros(8, dtype=np.uint8)
    clipped = bound[:8]
    padded[: len(clipped)] = np.frombuffer(clipped, dtype=np.uint8)
    return int((rows[:, :8] == padded).all(axis=1).sum())


def test_date_prefix_of_is_the_first_eight_bytes_big_endian():
    rows = np.random.default_rng(7).integers(0, 256, size=(64, 40), dtype=np.uint8)
    rows[3] = 0
    rows[5, 0] = 0xFF
    got = kernels.date_prefix_of(rows)
    assert got.dtype == np.int64 and got.shape == (64,)
    for row, p in zip(rows, got):
        assert int(p) & ((1 << 64) - 1) == int.from_bytes(bytes(row[:8]), "big")
    assert got[3] == 0 and got[5] < 0  # the u64 bits, negative as int64
    # an unsigned compare of prefixes orders rows as memcmp of their 8 bytes
    order = np.argsort(got.view(np.uint64), kind="stable")
    assert [bytes(r[:8]) for r in rows[order]] == sorted(bytes(r[:8]) for r in rows)
    assert kernels.bound_prefix(b"", 40) == 0
    assert kernels.bound_prefix(LEX_BOUND, 40) == int.from_bytes(LEX_BOUND[:8], "big")
    assert kernels.bound_prefix(b"\xff", 40) == 0xFF << 56
    with pytest.raises(ValueError):
        kernels.date_prefix_of(np.zeros((2, 7), np.uint8))


@pytest.mark.parametrize("bound", LEX_BOUNDS, ids=lambda b: f"len{len(b)}-{b[:1].hex()}")
def test_lex_replay_matches_jax(bound):
    rows = lex_rows(len(bound))
    got = lex_replay(rows, kernels.date_prefix_of(rows), bound)
    assert np.array_equal(got, jax_kernels.lex_cmp_np(np.ascontiguousarray(rows.T), bound))
    assert np.array_equal(got, kernels.lex_cmp_plain(torch.from_numpy(rows), bound).numpy())
    # the kernel reads past the prefix exactly where the prefix ties
    assert lex_replay.reads == ties(rows, bound)


def test_lex_replay_edge_cases_are_not_vacuous():
    rows = lex_rows(0)
    prefix = kernels.date_prefix_of(rows)
    want = jax_kernels.lex_cmp_np(np.ascontiguousarray(rows.T), LEX_BOUND)
    got = lex_replay(rows, prefix, LEX_BOUND)
    # ties decided at byte 8 or 9 both ways, equal rows, and rows read past
    # the prefix that are not equal
    tied = (rows[:, :8] == np.frombuffer(LEX_BOUND[:8], np.uint8)).all(axis=1)
    assert {-1, 0, 1} <= set(got[tied].tolist())
    assert lex_replay.reads > (got == 0).sum() > 0
    # the 40-byte bound ties rows up to byte 39, and decides some there
    long_bound = LEX_BOUND + b"Z" * 15
    at_39 = (rows[:, :39] == np.frombuffer(long_bound[:39], np.uint8)).all(axis=1)
    long_got = lex_replay(rows, prefix, long_bound)
    assert {-1, 0, 1} <= set(long_got[at_39].tolist())
    # a signed compare of the prefixes gets the rows with a first byte
    # >= 0x80 wrong: they are greater, not less
    high = rows[:, 0] >= 0x80
    assert high.sum() > 0 and (want[high] == 1).all()
    signed = lex_replay(rows, prefix, LEX_BOUND, signed=True)
    assert (signed[high] == -1).all() and not np.array_equal(signed, want)
    # zero rows (padding, NULL dates) are less than any non-empty bound
    zero = ~rows.any(axis=1)
    assert zero.sum() > 0 and (got[zero] == -1).all()
    assert len(rows) % KEYED_ROWS  # the tail takes the one-row path


@pytest.mark.parametrize("seed", [1, 2])
def test_lex_replay_on_seeded_rows(seed):
    """Rows over a small alphabet with bytes >= 0x80 (many ties on short
    prefixes), bounds cut from them at 0-41 bytes."""
    rows = value_rows(seeded_values(40, seed, n=4 * 97 + 1), 40)
    prefix = kernels.date_prefix_of(rows)
    planes = np.ascontiguousarray(rows.T)
    for length in (0, 1, 7, 8, 9, 39, 40, 41):
        bound = (bytes(rows[11]) + b"\xc3")[:length]
        got = lex_replay(rows, prefix, bound)
        assert np.array_equal(got, jax_kernels.lex_cmp_np(planes, bound)), length
        assert lex_replay.reads == ties(rows, bound)


# -- the index's date_prefix column ---------------------------------------------


def assert_prefix_current(idx) -> None:
    idx.refresh_keys()
    assert idx.date_prefix.dtype == np.int64 and idx.date_prefix.shape == (idx.cap,)
    assert np.array_equal(idx.date_prefix, kernels.date_prefix_of(idx.date_planes))


def test_date_prefix_follows_build_upsert_and_jax():
    rows = loader_rows()
    idx = columnar.ColumnarIndex()
    idx.build(rows)
    assert_prefix_current(idx)
    assert (idx.date_prefix[: idx.n] != 0).all() and (idx.date_prefix[idx.n:] == 0).all()
    before = idx.date_prefix[3]
    assert idx.upsert(dict(rows[3], date_created="été-2027"))  # first byte 0xC3
    assert idx.date_prefix[3] == before  # until refresh_keys
    assert idx.upsert(dict(rows[4], date_created=None))  # NULL: a zero row, prefix 0
    for k in range(5000):  # past the capacity: the prefix column grows with the rest
        assert idx.upsert(dict(rows[0], id=LOADER_ROWS + 1 + k,
                               date_created=f"2026-07-{1 + k % 28:02d}T00:00:00+00:00"))
    assert_prefix_current(idx)
    assert idx.date_prefix[3] < 0 and idx.date_prefix[4] == 0
    ref = jax_columnar.ColumnarIndex()
    ref.build(rows)
    converted = columnar.index_from_jax(ref)
    assert_prefix_current(converted)
    fresh = columnar.ColumnarIndex()
    fresh.build(rows)
    assert np.array_equal(converted.date_prefix, fresh.date_prefix)


def test_mirror_date_prefix_follows_the_patch():
    rows = loader_rows()
    idx = columnar.ColumnarIndex()
    idx.build(rows)
    mirror = columnar.DeviceMirror("cpu")
    mirror.sync(idx)
    idx.upsert(dict(rows[7], date_created="2031-01-01T00:00:00+00:00"))
    idx.upsert(dict(rows[0], id=LOADER_ROWS + 1, date_created="ÿ"))
    mirror.sync(idx)
    assert (mirror.uploads, mirror.patches) == (1, 1)
    got = mirror.arrays["date_prefix"]
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), kernels.date_prefix_of(mirror.arrays["date"].numpy()))
    pred, _ = columnar.parse_predicate({"date_range": ["2031-01-01", None],
                                        "include_hidden": True})
    mask = columnar.eval_mask_device(idx, mirror, pred)
    assert mask.sum() == 2 and mask[idx.slot_of(8)] and mask[idx.slot_of(LOADER_ROWS + 1)]


@pytest.mark.parametrize("bound", LEX_BOUNDS, ids=lambda b: f"len{len(b)}-{b[:1].hex()}")
def test_lex_cmp_on_the_cpu_ignores_the_prefix(bound):
    rows = lex_rows(3)
    want = jax_kernels.lex_cmp_np(np.ascontiguousarray(rows.T), bound)
    t = torch.from_numpy(rows)
    for prefix in (None, torch.from_numpy(kernels.date_prefix_of(rows))):
        got = kernels.lex_cmp(t, bound, prefix)
        assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)
