"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests import torch and the port only (no jax), so they run on a
machine with a CUDA card: ``python -m pytest tests/test_torch_on_card.py``.
Without a card each test skips. Outputs are integers and bits, so every
comparison is exact (tolerance zero).
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from spacedrive_tpu_torch.objects.blake3_ref import blake3
from spacedrive_tpu_torch.ops import _kernels
from spacedrive_tpu_torch.ops import blake3 as b3
from spacedrive_tpu_torch.ops import cdc
from spacedrive_tpu_torch.search import kernels as search_kernels
from tests.torch_gear_edges import edge_plane
from tests.torch_search_cases import LEX_BOUNDS, birthday_pair, lex_rows, substring_cases

EDGE_LENGTHS = (0, 1, 63, 64, 65, 1023, 1024, 1025, 2048, 2049, 57352, 102408)


def blob(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, size=n, dtype=np.uint8).tobytes()


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_blake3_kernels_match_plain_and_oracle(card):
    msgs = [blob(i, n) for i, n in enumerate(EDGE_LENGTHS)]
    rows, lengths = b3.pack_rows(msgs + [b""] * 4, 101)
    r, n = torch.from_numpy(rows).to(card), torch.from_numpy(lengths).to(card)
    before = dict(_kernels.LAUNCHES)
    cvs = b3.chunk_cvs(r, n)
    assert torch.equal(b3.u32(cvs), b3.chunk_cvs_plain(r, n))
    assert torch.equal(b3.u32(b3.merge(cvs, n)), b3.merge_plain(b3.chunk_cvs_plain(r, n), n))
    assert _kernels.LAUNCHES["blake3_chunk_cvs"] == before.get("blake3_chunk_cvs", 0) + 1
    assert b3.blake3_batch_hex(msgs, max_chunks=101) == [blake3(m).hex() for m in msgs]


def hold_blake3_to_plain(card, msgs: list[bytes], C: int, lengths=None) -> None:
    """Both BLAKE3 kernels against their plain versions on one batch, one
    launch each; ``lengths`` may replace the packed lengths."""
    rows, packed = b3.pack_rows(msgs, C)
    r = torch.from_numpy(rows).to(card)
    n = torch.from_numpy(packed if lengths is None else np.asarray(lengths, np.int32)).to(card)
    before = dict(_kernels.LAUNCHES)
    cvs = b3.chunk_cvs(r, n)
    plain = b3.chunk_cvs_plain(r, n)
    assert torch.equal(b3.u32(cvs), plain)
    assert torch.equal(b3.u32(b3.merge(cvs, n)), b3.merge_plain(plain, n))
    for kernel in ("blake3_chunk_cvs", "blake3_merge"):
        assert _kernels.LAUNCHES[kernel] == before.get(kernel, 0) + 1


def chunk_id_lengths(seed: int, n: int) -> list[int]:
    """CDC chunk lengths as the manifest stage sends them: mostly 2 KiB plus
    a geometric tail capped at 64 KiB, one in ten a short final chunk."""
    rng = np.random.default_rng(seed)
    return [int(rng.integers(1, 2048)) if rng.random() < 0.1
            else min(65536, 2048 + int(rng.exponential(6144))) for _ in range(n)]


@pytest.mark.parametrize("n", [4096, 2048, 45])
def test_blake3_kernels_on_chunk_id_batches(card, n):
    """Chunk-id batches (lanes numbered over real chunks; 45 messages is not
    a multiple of any merge group)."""
    lens = [2048, 2049, 4096, 65535, 65536, 1] + chunk_id_lengths(n, n - 6)
    hold_blake3_to_plain(card, [blob(i, k) for i, k in enumerate(lens)], 64)


def test_blake3_kernels_on_the_sampled_cas_batch(card):
    from spacedrive_tpu_torch.objects.cas import SAMPLED_MESSAGE_LEN

    hold_blake3_to_plain(card, [blob(i, SAMPLED_MESSAGE_LEN) for i in range(1024)], 64)


@pytest.mark.parametrize("C", [1, 4, 101])
def test_blake3_kernels_at_chunk_counts_and_tier_padding(card, C):
    """C = 1 (no merge level), 4 and 101 (not a power of two), each batch
    padded with empty messages to a tier; at C = 101 a 101-chunk message
    shares its merge group with one-chunk ones."""
    rng = np.random.default_rng(C)
    lens = [C * 1024, 0, 1, 1023, min(1025, C * 1024)] + [
        int(x) for x in rng.integers(0, C * 1024 + 1, 40)]
    msgs = [blob(i, k) for i, k in enumerate(lens)]
    hold_blake3_to_plain(card, msgs + [b""] * (b3._pad_to_tier(len(msgs)) - len(msgs)), C)


@pytest.mark.parametrize("B", [8191, 8192, 8193, 9000])
def test_blake3_kernels_across_merge_groups_and_launch_slices(card, B):
    """Batch sizes around the chunk kernel's 8192 messages a launch (the
    launcher slices larger batches) and the merge's groups of 31 and 32."""
    lens = [int(x) for x in np.random.default_rng(B).integers(0, 4 * 1024 + 1, B)]
    hold_blake3_to_plain(card, [blob(i, k) for i, k in enumerate(lens)], 4)


def test_blake3_kernels_near_max_chunks(card):
    """One message of MAX_CHUNKS - 1 chunks plus a byte (a merge group of
    one message taking 112 KiB of shared memory) beside short ones."""
    C = b3.MAX_CHUNKS
    msgs = [blob(1, (C - 1) * 1024 + 1), blob(2, 5), b"", blob(3, 70_000)] + [b""] * 4
    hold_blake3_to_plain(card, msgs, C)
    assert b3.blake3_batch_hex(msgs[:2], max_chunks=C) == [blake3(m).hex() for m in msgs[:2]]


def test_blake3_kernels_clamp_lengths_past_the_row(card):
    """Lengths past the row (and negative ones) clamp as in the plain
    version: nothing is read or merged out of bounds."""
    msgs = [blob(i, 2048) for i in range(8)]
    hold_blake3_to_plain(card, msgs, 2, lengths=[10_000, -5, 2048, 2047, 4096, 0, 1 << 30, 3])


def test_gear_kernel_matches_plain(card):
    datas = [b"", b"a", blob(7, 255), blob(9, 4096), blob(10, 70_000), b"\x00" * 4096]
    params = cdc.ChunkParams(64, 256, 1024)
    plane, lengths = cdc._plane(datas, card)
    assert torch.equal(cdc.gear_candidates(plane, lengths, params.mask),
                       cdc.gear_candidates_plain(plane, lengths, params.mask))
    assert cdc.chunk_batch(datas, params) == cdc.chunk_batch(datas, params, device="cpu")


@pytest.mark.parametrize("width", [256, 4096, 128 << 10, 1000])
def test_gear_kernel_edges_match_plain(card, width):
    """Edge lengths in a padded plane; 1000 is not a multiple of 16 (the
    kernel's byte path). Masks of low bits (8191 is the default) and
    0xFF000000, which reads the window's oldest bytes; mask 0 flags every
    position."""
    plane, lengths = (torch.from_numpy(t).to(card) for t in edge_plane(width, width))
    for mask in (0, 255, 8191, 0xFF000000):
        got = cdc.gear_candidates(plane, lengths, mask)
        assert torch.equal(got, cdc.gear_candidates_plain(plane, lengths, mask)), mask
    assert torch.equal(cdc.gear_candidates(plane, lengths, 0).sum(1, dtype=torch.int32), lengths)


def test_gear_kernel_off_alignment_and_tiers_match_plain(card):
    plane, lengths = (torch.from_numpy(t).to(card) for t in edge_plane(4096, 5))
    buf = torch.empty(plane.numel() + 1, dtype=torch.uint8, device=card)
    shifted = buf[1:].view(plane.shape)  # contiguous, 1 byte off 16-byte alignment
    shifted.copy_(plane)
    mask = cdc.DEFAULT_PARAMS.mask
    assert torch.equal(cdc.gear_candidates(shifted, lengths, mask),
                       cdc.gear_candidates_plain(plane, lengths, mask))
    rng = np.random.default_rng(6)
    for tier, n_files in ((256, 120), (4 << 10, 15), (128 << 10, 48), (512 << 10, 16)):
        datas = [blob(int(rng.integers(1 << 30)), int(rng.integers(tier // 2 + 1, tier + 1)))
                 for _ in range(n_files)]
        plane, lengths = cdc._plane(datas, card)
        before = _kernels.LAUNCHES_BY_SHAPE[("gear_candidates", None, tuple(plane.shape))]
        assert torch.equal(cdc.gear_candidates(plane, lengths, mask),
                           cdc.gear_candidates_plain(plane, lengths, mask)), tier
        assert _kernels.LAUNCHES_BY_SHAPE[
            ("gear_candidates", None, tuple(plane.shape))] == before + 1


def test_kernel_wrappers_reject_bad_inputs(card):
    rows = torch.zeros((8, 256), dtype=torch.int64, device=card)
    with pytest.raises(TypeError):
        b3.chunk_cvs(rows, torch.zeros(8, dtype=torch.int32, device=card))
    plane = torch.zeros((2, 16), dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        cdc.gear_candidates(plane, torch.zeros(2, dtype=torch.int32, device=card), 255)
    with pytest.raises(ValueError):
        search_kernels.exact(torch.zeros((8, 20), dtype=torch.uint8, device=card), b"a")
    with pytest.raises(ValueError):
        search_kernels.substring(torch.zeros((8, 128), dtype=torch.uint8, device=card)[:, :64], b"a")


def search_rows(seed: int, n: int, width: int) -> torch.Tensor:
    """(n, W) rows over a small alphabet (many partial matches), with empty
    rows and rows of exactly W bytes."""
    rng = np.random.default_rng(seed)
    rows = rng.choice(np.frombuffer(b"abc.-\xc3", dtype=np.uint8), size=(n, width))
    lens = rng.integers(0, width + 1, size=n)
    lens[::7] = width
    rows[np.arange(width)[None, :] >= lens[:, None]] = 0
    return torch.from_numpy(rows)


@pytest.mark.parametrize("length", [1, 2, 17, 48])
def test_search_substring_kernel_matches_plain(card, length):
    rows = search_rows(length, 8192 + 77, 64)
    needle = bytes(rows[3, 64 - length:].tolist()) if length > 1 else b"a"
    rows[5, 64 - length:] = torch.tensor(list(needle), dtype=torch.uint8)  # last offset
    rows = rows.to(card)
    got = search_kernels.substring(rows, needle)
    assert torch.equal(got, search_kernels.substring_plain(rows, needle))
    assert bool(got[5])


@pytest.mark.parametrize("case", substring_cases(), ids=lambda c: c[0])
def test_search_substring_kernel_edge_cases(card, case):
    """L = 1-5 and 48, a common first gram with no match, matches only at
    offset 0 and W-L, rows where every offset is a candidate, bytes >= 0x80
    and NULs in the needle, over a row count that is not a multiple of 32."""
    _label, rows, needle = case
    rows = torch.from_numpy(rows).to(card)
    assert torch.equal(search_kernels.substring(rows, needle),
                       search_kernels.substring_plain(rows, needle))


def key_column(rows: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(search_kernels.row_keys(rows.cpu().numpy())).to(rows.device)


@pytest.mark.parametrize("width", [12, 96])
def test_search_exact_kernel_matches_plain(card, width):
    rows = search_rows(width, 8192 + 5, width).to(card)
    keys = key_column(rows)
    for needle in (bytes(rows[0].tolist()).rstrip(b"\0"), bytes(rows[7].tolist()), b"", b"a",
                   b"x" * width):
        assert torch.equal(search_kernels.exact(rows, needle, keys),
                           search_kernels.exact_plain(rows, needle)), needle


@pytest.mark.parametrize("width", [12, 96])
def test_search_exact_kernel_with_a_key_collision(card, width):
    """Two different rows with one key: the needle is one of them, the other
    is planted in the column beside it, and only the equal row matches."""
    a, b = birthday_pair(width, width)
    rows = search_rows(width + 1, 4096 + 3, width)
    rows[17], rows[4000] = torch.from_numpy(a), torch.from_numpy(b)
    rows = rows.to(card)
    needle = bytes(b.tolist()).rstrip(b"\0")
    keys = key_column(rows)
    assert int(keys[17]) == int(keys[4000]) == search_kernels.needle_key(needle, width)
    got = search_kernels.exact(rows, needle, keys)
    assert torch.equal(got, search_kernels.exact_plain(rows, needle))
    assert bool(got[4000]) and not bool(got[17])


def test_search_exact_kernel_needs_its_key_column(card):
    rows = search_rows(96, 4096, 96).to(card)
    keys = key_column(rows)
    for bad in (None, keys[:-4], keys.to(torch.int64), keys.cpu()):
        with pytest.raises(ValueError):
            search_kernels.exact(rows, b"a", bad)
    before = _kernels.LAUNCHES["search_exact"]
    search_kernels.exact(rows, b"a", keys)
    assert _kernels.LAUNCHES["search_exact"] == before + 1


def prefix_column(rows: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(search_kernels.date_prefix_of(rows.cpu().numpy())).to(rows.device)


def test_search_lex_kernel_matches_plain(card):
    rows = search_rows(40, 8192 + 3, 40)
    rows[9, 0] = 0xFF  # a first byte >= 0x80: negative as int64
    rows = rows.to(card)
    prefix = prefix_column(rows)
    row7 = bytes(rows[7].tolist())
    for bound in (b"", b"b", b"abc", b"\xc3", row7, row7[:7], row7[:8], row7[:9], b"c" * 41):
        assert torch.equal(search_kernels.lex_cmp(rows, bound, prefix),
                           search_kernels.lex_cmp_plain(rows, bound)), bound


@pytest.mark.parametrize("bound", LEX_BOUNDS, ids=lambda b: f"len{len(b)}-{b[:1].hex()}")
def test_search_lex_kernel_edge_cases(card, bound):
    """Rows that tie with the bound's 8-byte prefix and differ at byte 8, 9
    or 39 or nowhere, first bytes >= 0x80, zero rows, bounds of 0-41 bytes,
    over a row count that is not a multiple of 4."""
    rows = torch.from_numpy(lex_rows(len(bound))).to(card)
    assert torch.equal(search_kernels.lex_cmp(rows, bound, prefix_column(rows)),
                       search_kernels.lex_cmp_plain(rows, bound))


def test_search_lex_kernel_needs_its_prefix_column(card):
    rows = search_rows(40, 4096, 40).to(card)
    prefix = prefix_column(rows)
    for bad in (None, prefix[:-4], prefix.to(torch.int32), prefix.cpu()):
        with pytest.raises(ValueError):
            search_kernels.lex_cmp(rows, b"b", bad)
    # one launch a call, and nothing else runs to remap its output
    before = dict(_kernels.LAUNCHES)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = search_kernels.lex_cmp(rows, b"b", prefix)
        torch.cuda.synchronize()
    assert got.dtype == torch.int8
    assert _kernels.LAUNCHES["search_lex"] == before.get("search_lex", 0) + 1
    assert sum(_kernels.LAUNCHES.values()) == sum(before.values()) + 1
    launched = [e.key for e in prof.key_averages() if e.self_device_time_total > 0]
    assert launched and all("lex_kernel<" in key for key in launched), launched
