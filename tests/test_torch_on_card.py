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


def test_pipelined_scan_on_the_card_matches_the_sequential_scan(card, tmp_path, monkeypatch):
    """A pipelined scan (4 gather shards, groups of 4, 16-file pages) of a
    seeded tree gives the rows of an ``SD_PIPELINE=0`` scan, and the scan
    kernels launch from its dispatch thread with no plain version on the
    card."""
    from spacedrive_tpu_torch.locations import create_location, scan_location
    from spacedrive_tpu_torch.models import JobRow
    from spacedrive_tpu_torch.node import Node
    from spacedrive_tpu_torch.objects import file_identifier as fi
    from spacedrive_tpu_torch.pipeline import executor
    from tests.torch_scan_cases import PAGE, make_tree, rows_of

    tree = make_tree(tmp_path / "tree")
    monkeypatch.setattr(fi, "BATCH_SIZE", PAGE)
    monkeypatch.setattr(executor, "GROUP_LINGER_S", 60.0)
    monkeypatch.setenv("SD_CHUNK_MANIFESTS", "1")
    monkeypatch.setenv("SD_SCAN_SHARDS", "4")
    monkeypatch.setenv("SD_COMMIT_GROUP", "4")

    def scan(name: str):
        node = Node(tmp_path / name, watch_locations=False)
        try:
            lib = node.libraries.create(name)
            scan_location(lib, create_location(lib, tree)["id"])
            assert node.jobs.wait_idle(300)
            return rows_of(lib.db), lib.db.find_one(JobRow, {"name": "file_identifier"})
        finally:
            node.shutdown()

    monkeypatch.setenv("SD_PIPELINE", "0")
    seq_rows, seq_job = scan("sequential")
    monkeypatch.setenv("SD_PIPELINE", "1")
    _kernels.reset_counts()
    rows, job = scan("pipelined")
    launches, plain = dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_ON_CUDA)
    assert seq_job["status"] == job["status"] == 2
    assert rows == seq_rows
    assert job["metadata"]["pipeline_batches"] == 5 and job["metadata"]["commit_txns"] == 2
    assert all(launches.get(k, 0) > 0
               for k in ("blake3_chunk_cvs", "blake3_merge", "gear_candidates")), launches
    assert not any(plain.values()), plain


def test_pause_and_resume_on_the_card_gives_the_uninterrupted_rows(card, tmp_path, monkeypatch):
    """An identify job paused on the card once two pages are committed
    launches nothing while Paused, and resumed gives the rows of an
    uninterrupted scan, through both scan kernels and no plain version."""
    import json
    import threading
    import time

    from spacedrive_tpu_torch.jobs import JobStatus
    from spacedrive_tpu_torch.locations import create_location, scan_location
    from spacedrive_tpu_torch.models import JobRow
    from spacedrive_tpu_torch.node import Node
    from spacedrive_tpu_torch.objects import file_identifier as fi
    from tests.torch_scan_cases import PAGE, make_tree, rows_of

    tree = make_tree(tmp_path / "tree")
    monkeypatch.setattr(fi, "BATCH_SIZE", PAGE)
    monkeypatch.setenv("SD_CHUNK_MANIFESTS", "1")
    monkeypatch.setenv("SD_SCAN_SHARDS", "1")
    monkeypatch.setenv("SD_COMMIT_GROUP", "1")

    def scan(name: str, hold: int | None = None):
        node = Node(tmp_path / name, watch_locations=False)
        try:
            lib = node.libraries.create(name)
            loc = create_location(lib, tree)
            lib.db.execute("UPDATE location SET generate_preview_media = 0")
            scan_location(lib, loc["id"])
            if hold is not None:
                hold(node, lib)
            assert node.jobs.wait_idle(300)
            return rows_of(lib.db), lib.db.find_one(JobRow, {"name": "file_identifier"})
        finally:
            node.shutdown()

    want, _job = scan("uninterrupted")
    reached, release = threading.Event(), threading.Event()
    real = fi.read_sampled_batch
    gathers = []

    def held_gather(paths, sizes):
        gathers.append(len(paths))
        if len(gathers) == 3:
            reached.set()
            assert release.wait(60)
        return real(paths, sizes)

    def pause_then_resume(node, lib):
        assert reached.wait(120)
        job = lib.db.find_one(JobRow, {"name": "file_identifier"})

        def checkpoint():
            return json.loads(lib.db.find_one(JobRow, {"id": job["id"]})["data"])

        deadline = time.monotonic() + 60
        while checkpoint()["step_number"] < 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        worker = node.jobs._running[job["id"]]
        assert node.jobs.pause(job["id"])
        while worker._commands.empty():
            time.sleep(0.001)
        release.set()
        while lib.db.find_one(JobRow, {"id": job["id"]})["status"] != JobStatus.PAUSED:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        frozen = dict(_kernels.LAUNCHES)
        time.sleep(2.0)
        assert dict(_kernels.LAUNCHES) == frozen  # nothing launches while Paused
        # the third page, released with the command queued, may still reach
        # the committer before its next poll
        assert checkpoint()["step_number"] in (2, 3)
        _kernels.reset_counts()
        assert node.jobs.resume(lib, job["id"])

    monkeypatch.setattr(fi, "read_sampled_batch", held_gather)
    rows, job = scan("paused", pause_then_resume)
    launches, plain = dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_ON_CUDA)
    assert job["status"] == JobStatus.COMPLETED and rows == want
    assert launches.get("blake3_chunk_cvs", 0) > 0 and launches.get("gear_candidates", 0) > 0
    assert not any(plain.values())


def test_a_scan_killed_on_the_card_cold_resumes(card, tmp_path, monkeypatch):
    """A child process identifying on the card is SIGKILLed at the COMMIT
    of its second commit group (``commit:kill:skip3``); a Node booted on
    its data dir sweeps the stale temporary the child planted and
    cold-resumes the Running identify job, through the scan kernels, to the
    rows of an uninterrupted scan on the card."""
    import json
    import signal
    import sqlite3
    import subprocess
    import sys
    from pathlib import Path

    from spacedrive_tpu_torch.jobs import JobStatus
    from spacedrive_tpu_torch.locations import create_location
    from spacedrive_tpu_torch.locations.indexer_job import IndexerJob
    from spacedrive_tpu_torch.models import JobRow
    from spacedrive_tpu_torch.node import Node
    from spacedrive_tpu_torch.objects import file_identifier as fi
    from tests.crash_harness import make_tree
    from tests.torch_scan_cases import rows_of

    tree = make_tree(tmp_path / "tree")
    monkeypatch.setattr(fi, "BATCH_SIZE", 24)
    monkeypatch.setenv("SD_COMMIT_GROUP", "4")
    monkeypatch.setenv("SD_SCAN_SHARDS", "1")
    node = Node(tmp_path / "uninterrupted", watch_locations=False)
    try:
        lib = node.libraries.create("uninterrupted")
        args = {"location_id": create_location(lib, tree)["id"]}
        node.jobs.spawn(lib, [IndexerJob(args), fi.FileIdentifierJob(dict(args))])
        assert node.jobs.wait_idle(300)
        want = rows_of(lib.db)
    finally:
        node.shutdown()

    data = tmp_path / "killed"
    child = Path(__file__).resolve().parent / "torch_kill_child.py"
    proc = subprocess.run([sys.executable, str(child), str(data), str(tree), "commit:kill:skip3",
                           "24", "4", "cuda"], capture_output=True, text=True, timeout=600)
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-3000:]
    (db_path,) = (data / "libraries").glob("*.db")
    conn = sqlite3.connect(db_path)
    status, blob = conn.execute(
        "SELECT status, data FROM job WHERE name = 'file_identifier'").fetchone()
    conn.close()
    assert status == JobStatus.RUNNING and json.loads(blob)["step_number"] > 0
    (stale,) = (data / "thumbnails").glob("*/*.sd-tmp*")
    _kernels.reset_counts()
    node = Node(data, watch_locations=False)  # sweeps, then cold-resumes on the card
    try:
        assert not stale.exists()
        (lib,) = node.libraries.list()
        assert node.jobs.wait_idle(300)
        job = lib.db.find_one(JobRow, {"name": "file_identifier"})
        rows = rows_of(lib.db)
    finally:
        node.shutdown()
    assert job["status"] == JobStatus.COMPLETED and rows == want
    assert _kernels.LAUNCHES.get("blake3_chunk_cvs", 0) > 0
    assert not any(_kernels.PLAIN_ON_CUDA.values())


@pytest.mark.parametrize("tier", [8, 64, 512, 1024, 2048])
def test_blake3_kernels_at_57_chunks(card, tier):
    """The fused cas path's rows: sampled messages in 57-chunk rows, at
    every batch tier a sub-batch of at most 2048 files pads to, the last
    rows empty (padding or failed reads)."""
    from spacedrive_tpu_torch.objects.cas import SAMPLED_MESSAGE_LEN
    from spacedrive_tpu_torch.objects.hasher import SAMPLED_CHUNKS

    n = max(1, tier - 3)
    msgs = [blob(tier + i, SAMPLED_MESSAGE_LEN) for i in range(n)] + [b""] * (tier - n)
    hold_blake3_to_plain(card, msgs, SAMPLED_CHUNKS)


def test_fused_hash_batch_on_the_card(card, tmp_path, monkeypatch):
    """``DeviceHasher.hash_batch`` on the card: sampled files gathered
    natively into pinned rows, three sub-batches double buffered, the
    kernels at (8, 57); small files bucketed; cas_ids equal the oracle,
    and no plain version runs on the card."""
    from spacedrive_tpu_torch.native import cas_native
    from spacedrive_tpu_torch.objects import hasher
    from spacedrive_tpu_torch.objects.cas import generate_cas_id

    monkeypatch.setattr(hasher, "PIPELINE_BATCH", 4)
    sizes = [102_401 + 997 * i for i in range(10)] + [0, 1, 5000, 102_400]
    paths = []
    for i, size in enumerate(sizes):
        path = tmp_path / f"f{i}"
        path.write_bytes(blob(700 + i, size))
        paths.append(str(path))
    h = hasher.DeviceHasher(card)
    staged = h._stage(paths, sizes, [0, 1])
    assert staged[2][0].is_pinned() and staged[2][1].is_pinned()
    assert staged[0].is_cuda and staged[0].shape == (8, hasher.SAMPLED_CHUNKS * 256)
    _kernels.reset_counts()
    cas_native.reset_counts()
    got = h.hash_batch(paths, sizes)
    torch.cuda.synchronize()
    assert got == [generate_cas_id(p) for p in paths]
    assert _kernels.LAUNCHES_BY_SHAPE[("blake3_chunk_cvs", "cas", (8, 57))] == 3
    assert sum(cas_native.GATHER_BATCHES.values()) == 3
    assert not any(_kernels.PLAIN_ON_CUDA.values())


def test_minhash_programs_on_the_card(card):
    """``minhash_rows`` and ``similar_pairs_count`` on the card against the
    same functions on the CPU and the numpy compare: words >= 2**31 (in int32
    and int64 carriers), lengths 0-15, ten equal rows (45 pairs), N = 600
    padded to BLOCK."""
    from spacedrive_tpu_torch.ops import minhash

    rng = np.random.default_rng(9)
    rows = rng.integers(0, 1 << 32, (600, 14592), dtype=np.uint64).astype(np.uint32)
    lengths = rng.integers(0, 58369, 600).astype(np.int32)
    lengths[:16] = np.arange(16)
    rows[11:20] = rows[10]
    lengths[10:20] = 57352
    r, n = torch.from_numpy(rows.view(np.int32)), torch.from_numpy(lengths)
    before = minhash.DEVICE_CALLS["minhash_rows"]
    got = minhash.minhash_rows(r.to(card), n.to(card))
    assert minhash.DEVICE_CALLS["minhash_rows"] == before + 1
    want = minhash.minhash_rows(r, n)
    assert torch.equal(got.cpu(), want)
    # words carried in int64 reach the card's int32 form intact
    wide = minhash.minhash_rows(torch.from_numpy(rows.astype(np.int64)).to(card), n.to(card))
    assert torch.equal(wide.cpu(), want)
    sigs, valid = minhash.pad_for_blocks(want.numpy())
    for thr in (51, 64):
        total, dup = minhash.similar_pairs_count(torch.from_numpy(sigs).to(card),
                                                 torch.from_numpy(valid).to(card), thr)
        assert total.dtype == torch.int64
        cpu_total, cpu_dup = minhash.similar_pairs_count_cpu(sigs, valid, thr)
        assert int(total) == cpu_total == 45
        assert np.array_equal(dup.cpu().numpy(), cpu_dup)


def resize_sub_batch(seed: int = 12):
    """A full (32, 1024, 1024, 3) sub-batch of the thumbnailer: lanes of
    600-1024 px edges (lane 0 the whole canvas), each with its target."""
    from spacedrive_tpu_torch.ops import resize

    rng = np.random.default_rng(seed)
    batch = rng.integers(0, 256, (32, 1024, 1024, 3), dtype=np.uint8)
    src = rng.integers(600, 1025, (32, 2)).astype(np.int32)
    src[0] = (1024, 1024)
    tgt = np.array([resize.target_dims(int(w), int(h)) for h, w in src], np.int32)
    return torch.from_numpy(batch), torch.from_numpy(src), torch.from_numpy(tgt)


def test_resize_on_the_card_matches_the_cpu(card):
    """The card against the CPU at max |diff| <= 1, on four lanes of a
    full sub-batch (lanes are independent), with the outputs on the card
    and the call counted there."""
    from spacedrive_tpu_torch.ops import resize

    batch, src, tgt = resize_sub_batch()
    before = resize.CALLS[("cuda", (32, 1024, 1024))]
    got = resize.resize_batch(batch.to(card), src.to(card), tgt.to(card))
    assert got.is_cuda and got.dtype == torch.uint8 and got.shape == (32, 512, 512, 3)
    assert resize.CALLS[("cuda", (32, 1024, 1024))] == before + 1
    lanes = [0, 1, 17, 31]
    want = resize.resize_batch(batch[lanes], src[lanes], tgt[lanes])
    diff = (got[lanes].cpu().to(torch.int16) - want.to(torch.int16)).abs()
    assert int(diff.max()) <= 1


def test_resize_pixels_do_not_depend_on_tf32(card):
    from spacedrive_tpu_torch.ops import resize

    batch, src, tgt = (t.to(card) for t in resize_sub_batch(13))
    full = resize.resize_batch(batch, src, tgt)
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        assert torch.backends.cuda.matmul.allow_tf32
        tf32 = resize.resize_batch(batch, src, tgt)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)
    assert torch.equal(full, tf32)


def test_resize_host_stages_on_the_card(card):
    """``resize_batch_host`` stages the batch on the card, padded to its
    largest image, and crops each thumbnail on the host; the pixels equal
    the CPU's within 1."""
    from spacedrive_tpu_torch.ops import resize

    rng = np.random.default_rng(14)
    arrays = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in [(750, 1000), (200, 300), (1, 1), (125, 1000), (1008, 756)]]
    resize.reset_counts()
    got = resize.resize_batch_host(arrays, card)
    assert resize.CALLS == {("cuda", (5, 1008, 1000)): 1}
    want = resize.resize_batch_host(arrays, torch.device("cpu"))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g.astype(np.int16) - w.astype(np.int16)).max() <= 1


def test_a_raise_in_the_card_resize_fails_the_media_job(card, tmp_path, monkeypatch):
    from PIL import Image

    from spacedrive_tpu_torch.jobs import JobStatus
    from spacedrive_tpu_torch.locations import create_location, scan_location
    from spacedrive_tpu_torch.node import Node
    from spacedrive_tpu_torch.objects.media import processor
    from spacedrive_tpu_torch.ops import resize

    tree = tmp_path / "tree"
    tree.mkdir()
    for i in range(3):
        pixels = np.random.default_rng(i).integers(0, 256, (300, 400, 3), dtype=np.uint8)
        Image.fromarray(pixels).save(tree / f"a{i}.png")

    def lost(*_args):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(resize, "_taps", lost)
    processor.SCALAR_RETRIES.clear()
    node = Node(tmp_path / "data", watch_locations=False)
    try:
        lib = node.libraries.create("card")
        scan_location(lib, create_location(lib, tree)["id"])
        assert node.jobs.wait_idle(120)
        jobs = {r["name"]: r for r in lib.db.query("SELECT * FROM job")}
        assert jobs["media_processor"]["status"] == JobStatus.FAILED
        assert "illegal memory access" in jobs["media_processor"]["errors_text"]
        assert not list(node.data_dir.glob("thumbnails/*/*.webp"))
    finally:
        node.shutdown()
    assert not processor.SCALAR_RETRIES


def test_heif_decode_then_the_card_resize_matches_the_cpu(card, tmp_path):
    """HEIF images decoded by libheif and box-reduced on the host, as the
    thumbnailer does, then resized on the card: 0 values differ from the
    CPU's resize. Skips where libheif or its encoder is missing."""
    from spacedrive_tpu_torch.native import NativeBuildError, heif_native
    from spacedrive_tpu_torch.objects.media import thumbnail
    from spacedrive_tpu_torch.ops import resize

    try:
        if not heif_native.available():
            pytest.skip("the libheif runtime (libheif.so.1) is not present on this machine")
    except NativeBuildError as e:
        pytest.skip(f"the libheif binding does not build here: {e}")
    arrays = []
    for i, (h, w) in enumerate([(2016, 1512), (1512, 2016), (480, 640), (48, 64)]):
        rng = np.random.default_rng(i)
        y, x = np.mgrid[0:h, 0:w].astype(np.float32)
        phase = rng.uniform(0, 6.28, 3)
        rgb = np.stack([127 + 100 * np.sin(x / (41 + 9 * c) + y / (53 + 5 * c) + phase[c])
                        for c in range(3)], axis=-1)
        path = tmp_path / f"p{i}.heic"
        if not heif_native.encode_file(path, np.clip(rgb, 0, 255).astype(np.uint8)):
            pytest.skip("this libheif build has no HEVC or AV1 encoder")
        arrays.append(thumbnail._decode_for_device(path))
    assert [a.shape[:2] for a in arrays] == [(1008, 756), (756, 1008), (480, 640), (48, 64)]
    resize.reset_counts()
    got = resize.resize_batch_host(arrays, card)
    assert resize.CALLS == {("cuda", (4, 1008, 1008)): 1}
    want = resize.resize_batch_host(arrays, torch.device("cpu"))
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g, w)


# --------------------------------------------------------------------------
# windows of long messages: the object validator and the mesh's seq axis
# --------------------------------------------------------------------------

def window_edges(W: int, F: int) -> tuple[int, ...]:
    """Message lengths at the long route's edges for windows of W chunks
    merged F at a time."""
    return (0, 1, 1024, 1025, W * 1024 - 1, W * 1024, W * 1024 + 1, 2 * W * 1024,
            W * F * 1024 + 1, W * F * 1024 + 17)


def test_blake3_windows_with_offsets_match_plain(card):
    """Rows that are windows of longer messages: chunk offsets across the
    counter's high word, a window holding only the final short chunk, one
    past the end, beside whole messages; and a null offset array against
    offsets 0 with totals equal to the lengths: the same words."""
    C = 4
    bases = [0, 3, 2**32 - 2, 2**32, 5, 2**40 + 7, 9, 0]
    totals = [3000, 4 * 1024 + 1, (2**32 + 3) * 1024, (2**32 + 1) * 1024 + 77, 5 * 1024,
              (2**40 + 9) * 1024 + 5, 9 * 1024, 0]
    msgs = []
    for i, (b, t) in enumerate(zip(bases, totals)):
        msgs.append(blob(i, max(0, min(C * 1024, t - b * 1024))))
    rows, lengths = b3.pack_rows(msgs, C)
    r, n = torch.from_numpy(rows).to(card), torch.from_numpy(lengths).to(card)
    base = torch.tensor(bases, device=card)
    total = torch.tensor(totals, device=card)
    cvs = b3.chunk_cvs(r, n, base, total)
    assert torch.equal(b3.u32(cvs), b3.chunk_cvs_plain(r, n, base, total))
    root = torch.tensor([True, False] * 4, device=card)
    assert torch.equal(b3.u32(b3.merge(cvs, n, root)),
                       b3.merge_plain(b3.chunk_cvs_plain(r, n, base, total), n, root))
    whole = b3.chunk_cvs(r, n)
    assert torch.equal(whole, b3.chunk_cvs(r, n, torch.zeros_like(base),
                                           n.to(torch.int64)))
    assert torch.equal(b3.merge(whole, n), b3.merge(whole, n, torch.ones_like(root)))


@pytest.mark.parametrize("W, F", [(4, 4), (2048, 4), (2048, 2048)],
                         ids=["W4-F4", "default-window-F4", "default"])
def test_blake3_long_route_on_the_card(card, W, F):
    """The edge set through the long route on the card, against the same
    route through the plain versions on the card and, where it is small
    enough, the Python oracle; every window batch one launch pair."""
    sizes = [n for n in window_edges(W, F) if n <= 64 << 20]
    msgs = [blob(n % 1000, n) for n in sizes]
    src = [b3.BytesMessage(m) for m in msgs]
    _kernels.reset_counts()
    stats: dict = {}
    got = b3.blake3_long_hex(src, card, window_chunks=W, fan_in=F, stats=stats)
    assert _kernels.LAUNCHES["blake3_chunk_cvs"] == stats["batches"]
    assert _kernels.LAUNCHES["blake3_merge"] == stats["batches"] + stats["levels"]
    assert got == b3.blake3_long_hex(src, card, window_chunks=W, fan_in=F, plain=True)
    for m, g in zip(msgs, got):
        if len(m) <= 20_000:
            assert g == blake3(m).hex()


def test_validator_host_memory_stays_bounded(card, tmp_path):
    """A 2 GiB sparse file through ``full_file_hashes`` on the card: after a
    warm-up (the CUDA context, the kernels, the pinned staging buffers),
    the process's peak RSS grows by under 600 MiB, the reference's slack in
    tests/test_blake3.py. The peak is sampled from /proc/self/statm every
    2 ms while the file hashes (not every kernel reports VmHWM)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    big = tmp_path / "big.bin"
    with open(big, "wb") as fh:
        fh.truncate(2 << 30)
    small = tmp_path / "small.bin"
    small.write_bytes(blob(1, 3 << 20))
    code = f"""
import os, threading, time
def rss_kb():
    with open('/proc/self/statm') as fh:
        return int(fh.read().split()[1]) * os.sysconf('SC_PAGE_SIZE') // 1024
from spacedrive_tpu_torch.objects.validator import full_file_hashes
full_file_hashes([{str(small)!r}])
before = peak = rss_kb()
done = threading.Event()
def sample():
    global peak
    while not done.is_set():
        peak = max(peak, rss_kb())
        time.sleep(0.002)
t = threading.Thread(target=sample)
t.start()
(h,) = full_file_hashes([{str(big)!r}])
done.set()
t.join()
grew = max(peak, rss_kb()) - before
print(h, grew)
assert len(h) == 64, h
assert grew < 600 * 1024, f"peak RSS grew {{grew}} kB hashing a 2 GiB file"
"""
    repo = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=repo, env={**os.environ, "PYTHONPATH": str(repo)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    print(proc.stdout)


def test_mesh_of_two_shards_on_one_card_gives_the_one_device_bytes(card):
    """``["cuda:0"] * 2`` with seq = 2 (one batch shard, its chunks split
    into two windows) and with seq = 1 (two batch shards): every program
    equals the one-device call."""
    from spacedrive_tpu_torch.ops.resize import target_dims
    from spacedrive_tpu_torch.parallel import mesh as tm

    msgs = [blob(i, n) for i, n in enumerate((0, 1, 1024, 1025, 4000, 8192, 5000, 7777))]
    words, lengths = b3.pack_messages(msgs, 8)
    one = tm.sharded_hasher(tm.make_mesh(devices=["cuda:0"]))(words, lengths)
    assert one.is_cuda and b3.digests_to_hex(one) == [blake3(m).hex() for m in msgs]
    for seq in (1, 2):
        mesh = tm.make_mesh(seq=seq, devices=["cuda:0"] * 2)
        assert torch.equal(tm.sharded_hasher(mesh)(words, lengths), one)
        rows, lens = b3.pack_rows(msgs, 8)
        assert torch.equal(tm.sharded_row_hasher(mesh)(rows, lens), one)
        digests, dup = tm.identify_step(mesh)(*b3.pack_messages(msgs + msgs[2:4], 8))
        assert torch.equal(digests[:, :8], one)
        assert dup.tolist() == [False] * 8 + [True, True]
    imgs = np.random.default_rng(3).integers(0, 256, (4, 90, 120, 3), dtype=np.uint8)
    th, tw = target_dims(120, 90)
    src = np.tile(np.int32([90, 120]), (4, 1))
    tgt = np.tile(np.int32([th, tw]), (4, 1))
    mesh = tm.make_mesh(devices=["cuda:0"] * 2)
    assert torch.equal(tm.sharded_resizer(mesh)(imgs, src, tgt),
                       tm.sharded_resizer(tm.make_mesh(devices=["cuda:0"]))(imgs, src, tgt))


def test_the_server_serves_search_from_the_card(card, tmp_path, monkeypatch):
    """A CUDA node's Server answers search.paths over HTTP with the SQL
    answer, byte for byte, while the queries launch all three search
    kernels (a substring, a directory and a date range)."""
    import json

    from spacedrive_tpu_torch.models import FilePath, Location
    from spacedrive_tpu_torch.node import Node
    from spacedrive_tpu_torch.server import Server
    from tests.torch_serve_client import rspc_get

    monkeypatch.setenv("SD_SEARCH_ENGINE", "device")
    node = Node(tmp_path / "data", watch_locations=False)
    server = Server(node, "127.0.0.1", 0)
    try:
        lib = node.libraries.create("served")
        loc = lib.db.insert(Location, {"pub_id": "l", "name": "l", "path": "/x"})
        lib.db.insert_many(FilePath, [{
            "pub_id": f"fp-{i}", "location_id": loc, "materialized_path": f"/d{i % 7}/",
            "name": f"report-{i:05d}", "extension": "pdf", "is_dir": 0, "hidden": 0,
            "size_in_bytes": i * 1000, "date_created": f"2026-0{1 + i % 9}-11T00:00:00+00:00"}
            for i in range(5000)])
        node.emit("db.commit", None, lib.id)
        node.search_engine.refresh_now(lib)
        server.start()
        url = f"http://127.0.0.1:{server.port}"
        before = dict(_kernels.LAUNCHES)
        for arg in ({"search": "report-01", "take": 50}, {"materialized_path": "/d3/"},
                    {"date_range": ["2026-03-01T00:00:00+00:00", "2026-05-30T00:00:00+00:00"]}):
            node.search_engine.set_enabled(False)
            sql = node.router.resolve("search.paths", arg, lib.id)
            node.search_engine.set_enabled(True)
            assert sql["items"]
            got = rspc_get(url, "search.paths", arg, lib.id).decode()
            assert got == json.dumps({"result": sql}, default=str)
        for kernel in ("search_substring", "search_exact", "search_lex"):
            assert _kernels.LAUNCHES[kernel] > before.get(kernel, 0), kernel
    finally:
        server.stop()
        node.shutdown()


def test_two_card_nodes_scan_sync_and_search_each_other(card, tmp_path, monkeypatch):
    """Two nodes on the card, emission on through the feature flag, each
    scan their own half of a seeded tree at once; each pulls the other's
    operations through an Actor (4 lanes on one side); both end with equal
    rows, the BLAKE3 and Gear kernels launched for both scans, and each
    node's search.paths on the rows the other scanned equals the SQL
    answer and launched the substring kernel."""
    import threading

    from spacedrive_tpu_torch.locations import create_location, scan_location
    from spacedrive_tpu_torch.models import Location
    from spacedrive_tpu_torch.node import Node
    from spacedrive_tpu_torch.sync import Actor
    from tests.torch_sync_cases import pair_libraries, synced_rows

    monkeypatch.setenv("SD_CHUNK_MANIFESTS", "1")
    monkeypatch.setenv("SD_SEARCH_ENGINE", "device")
    halves = []
    for side in ("a", "b"):
        root = tmp_path / f"tree_{side}"
        for d in range(4):
            (root / f"{side}{d}").mkdir(parents=True)
            for i in range(32):
                (root / f"{side}{d}" / f"{side}file{d}-{i:03d}.bin").write_bytes(
                    blob(1000 * d + i + (7 if side == "b" else 0), 200 + 9000 * (i % 9)))
        halves.append(root)
    nodes = []
    try:
        for side in ("a", "b"):
            node = Node(tmp_path / f"data_{side}", watch_locations=False)
            assert node.config.toggle_feature("syncEmitMessages")
            nodes.append(node)
        libs = [n.libraries.create(f"pair-{i}") for i, n in enumerate(nodes)]
        pair_libraries(*libs)
        before = dict(_kernels.LAUNCHES)
        locs = []
        for lib, root in zip(libs, halves):
            loc = create_location(lib, root)
            lib.sync.write_ops(
                [lib.sync.shared_update(Location, loc["pub_id"], "generate_preview_media", False)],
                lambda db, i=loc["id"]: db.update(Location, {"id": i},
                                                  {"generate_preview_media": False}))
            locs.append(loc)
        scans = [threading.Thread(target=scan_location, args=(lib, loc["id"]))
                 for lib, loc in zip(libs, locs)]
        for t in scans:
            t.start()
        for t in scans:
            t.join()
        assert all(n.jobs.wait_idle(300) for n in nodes)
        for kernel in ("blake3_chunk_cvs", "blake3_merge", "gear_candidates"):
            assert _kernels.LAUNCHES[kernel] > before.get(kernel, 0), kernel
        for i, lanes in ((0, "1"), (1, "4")):
            monkeypatch.setenv("SD_SYNC_INGEST_LANES", lanes)
            peer = libs[1 - i]
            actor = Actor(libs[i], transport=lambda c, n, p=peer: p.sync.get_ops(c, n))
            actor.notify()
            assert actor.wait_idle(120)
            actor.stop()
        assert synced_rows(libs[0].db) == synced_rows(libs[1].db)
        for node, lib, needle in ((nodes[1], libs[1], "afile2-"), (nodes[0], libs[0], "bfile3-")):
            node.search_engine.refresh_now(lib)
            node.search_engine.set_enabled(False)
            sql = node.router.resolve("search.paths", {"search": needle, "take": 100}, lib.id)
            node.search_engine.set_enabled(True)
            launched = _kernels.LAUNCHES["search_substring"]
            got = node.router.resolve("search.paths", {"search": needle, "take": 100}, lib.id)
            assert got == sql and len(sql["items"]) == 32
            assert _kernels.LAUNCHES["search_substring"] > launched
    finally:
        for node in nodes:
            node.shutdown()


def test_two_processes_pair_sync_and_hash_over_the_card(card, tmp_path, monkeypatch):
    """p2p on the card between this process and a child
    (``tests/torch_p2p_peer.py``): pair over the encrypted wire, hash this
    node's cas messages on the child's card through ``H_HASH`` (both BLAKE3
    kernels launched there, none here, no fallback), scan both sides and
    converge over the sync sessions."""
    from spacedrive_tpu_torch.locations import create_location, scan_location
    from spacedrive_tpu_torch.node import Node
    from spacedrive_tpu_torch.objects.cas import generate_cas_id
    from spacedrive_tpu_torch.objects.hasher import RemoteHasher
    from spacedrive_tpu_torch.p2p import manager
    from tests.torch_p2p_cases import PeerProcess, rows_digest, small_tree, wait_for

    monkeypatch.delenv("SD_P2P_DISABLED", raising=False)
    trees = {side: small_tree(tmp_path / f"tree-{side}", seed, side)
             for seed, side in enumerate(("a", "b"))}
    peer = PeerProcess(tmp_path / "b", trees["b"], "cuda", tmp_path / "peer.log")
    node = None
    try:
        peer.wait_ready()
        node = Node(tmp_path / "a", watch_locations=False)
        node.router.resolve("toggleFeatureFlag", "syncEmitMessages")
        ident = peer.ready["identity"]
        node.router.resolve("p2p.pair", {"peer_id": f"127.0.0.1:{peer.ready['port']}"})
        lib = wait_for(lambda: next((x for x in node.libraries.list()
                                     if x.id == peer.ready["library_id"]), None),
                       msg="the mirrored library")
        wait_for(lambda: RemoteHasher(node)._pick_peer() == ident, msg="the peer's card")
        RemoteHasher.reset_counts()
        manager.reset_counts()
        _kernels.reset_counts()
        loc = create_location(lib, str(trees["a"]), hasher="remote")
        scan_location(lib, loc["id"])
        assert node.jobs.wait_idle(120)
        rows = lib.db.query("SELECT * FROM file_path WHERE is_dir = 0 AND location_id = ?",
                            [loc["id"]])
        assert len(rows) == 17
        for r in rows:
            path = trees["a"] / r["materialized_path"].strip("/") / f"{r['name']}.bin"
            assert r["cas_id"] == (generate_cas_id(path) if r["size_in_bytes"] else None)
        assert not RemoteHasher.FALLBACKS and manager.STATS["hash_requests"] >= 1
        assert not any(n for (_k, tag, _s), n in _kernels.LAUNCHES_BY_SHAPE.items()
                       if tag == "cas")
        served = peer.ask("counts")["by_origin"].get("hash-serve", {})
        assert served.get("blake3_chunk_cvs") and served.get("blake3_merge"), served
        peer.ask("scan")
        assert peer.ask("wait_scan")["idle"]
        wait_for(lambda: rows_digest(lib.db)[0] == peer.ask("rows")["digest"], timeout=60,
                 interval=0.5, msg="equal rows in both processes")
        assert peer.quit() == 0
    finally:
        if node is not None:
            node.shutdown()
        peer.close()


def cuda_handles(pid: int) -> tuple[set, bool]:
    """A process's open ``/dev/nvidia*`` files and whether it maps libcuda."""
    import os

    devices = set()
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            target = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if target.startswith("/dev/nvidia"):
            devices.add(target)
    with open(f"/proc/{pid}/maps") as fh:
        return devices, any("libcuda.so" in line for line in fh)


def test_a_replica_query_on_the_card_and_pool_workers_without_cuda(card, tmp_path, monkeypatch):
    """A child node on the card (``tests/torch_p2p_peer.py``, the search
    engine armed beside a reader pool of 2) serves this node's
    ``search.pathsCount`` over ``H_QUERY`` from its device index, not its
    pool: every answer is its local answer and this node's in-process one,
    and its launches under origin ``replica-serve`` grow for the three
    search kernels; ``search.objectsCount``, which the index does not
    answer, is served by its pool. Then a reader pool started beside this
    process's CUDA context answers a page, and its workers hold no
    ``/dev/nvidia*`` file."""
    import json
    import os

    from spacedrive_tpu_torch.api.router import last_rung
    from spacedrive_tpu_torch.node import Node
    from spacedrive_tpu_torch.server.pool import ReaderPool
    from tests.torch_p2p_cases import PeerProcess, rows_digest, small_tree, wait_for

    monkeypatch.delenv("SD_P2P_DISABLED", raising=False)
    monkeypatch.delenv("SD_SEARCH_ENGINE", raising=False)
    tree = small_tree(tmp_path / "tree-b", 1, "b")
    peer = PeerProcess(tmp_path / "b", tree, "cuda", tmp_path / "peer.log",
                       env={"SD_SEARCH_ENGINE": "device", "SD_SERVE_WORKERS": "2"})
    node = pool = None
    try:
        peer.wait_ready()
        node = Node(tmp_path / "a", watch_locations=False)
        node.router.resolve("toggleFeatureFlag", "syncEmitMessages")
        node.router.resolve("p2p.pair", {"peer_id": f"127.0.0.1:{peer.ready['port']}"})
        lib = wait_for(lambda: next((x for x in node.libraries.list()
                                     if x.id == peer.ready["library_id"]), None),
                       msg="the mirrored library")
        peer.ask("scan")
        assert peer.ask("wait_scan")["idle"]
        wait_for(lambda: rows_digest(lib.db)[0] == peer.ask("rows")["digest"], timeout=60,
                 interval=0.5, msg="equal rows in both processes")
        assert peer.ask("refresh")["fresh"]
        dates = sorted(r["d"] for r in lib.db.query(
            "SELECT date_created AS d FROM file_path WHERE is_dir = 0"))
        pooled = peer.ask("pool")
        assert pooled["status"]["alive"] == 2, pooled
        before = peer.ask("counts")["by_origin"].get("replica-serve", {})
        count = node.router.procedures["search.pathsCount"].fn
        for arg in ({"search": "b0"}, {"materialized_path": "/d1/"},
                    {"date_range": [dates[2], dates[-3]]}):
            wait_for(lambda: node.router.resolve("search.pathsCount", arg, lib.id) is not None
                     and last_rung() == "replica", timeout=10, msg="the replica rung")
            got = node.router.resolve("search.pathsCount", arg, lib.id, raw=True)
            assert last_rung() == "replica"
            assert got.data == peer.ask("local", key="search.pathsCount", arg=arg)[
                "raw"].encode() == json.dumps(count(node, lib, arg)).encode()
        after = peer.ask("counts")["by_origin"].get("replica-serve", {})
        for kernel in ("search_substring", "search_exact", "search_lex"):
            assert after.get(kernel, 0) > before.get(kernel, 0), (kernel, after)
        assert peer.ask("pool")["stats"].get("requests_ok", 0) == \
            pooled["stats"].get("requests_ok", 0)
        n_objects = node.router.resolve("search.objectsCount", None, lib.id, raw=True)
        assert last_rung() == "replica"
        assert json.loads(n_objects.data) == lib.db.query("SELECT COUNT(*) n FROM object")[0]["n"]
        assert peer.ask("pool")["stats"]["requests_ok"] == \
            pooled["stats"].get("requests_ok", 0) + 1
        assert peer.quit() == 0
        # a pool beside this process's CUDA context
        torch.ones(1, device=card)
        torch.cuda.synchronize()
        node.replica_router = None
        pool = node.reader_pool = ReaderPool(node, workers=2).start()
        got = node.router.resolve("search.paths", {"take": 100}, lib.id, raw=True)
        assert last_rung() == "pool"
        pool.set_enabled(False)
        want = node.router.resolve("search.paths", {"take": 100}, lib.id)
        assert got.data == json.dumps(want, default=str).encode()
        pool.set_enabled(True)
        devices, _libcuda = cuda_handles(os.getpid())
        assert devices
        for pid in pool.worker_pids():
            # a context needs the device files; a worker may map libcuda
            # without them, which is not a context
            assert cuda_handles(pid)[0] == set(), pid
    finally:
        if pool is not None:
            pool.stop()
            node.reader_pool = None
        if node is not None:
            node.shutdown()
        peer.close()


def test_encrypt_rescan_decrypt_rescan_on_the_card(card, tmp_path, monkeypatch):
    """A node on the card scans a seeded tree with manifests on, encrypts
    its files through ``files.encryptFiles`` with a stored key (the
    originals erased), rescans: every ``.bytes`` file gets a cas_id through
    the BLAKE3 kernels, none equal to a plaintext's; then decrypts them with
    the same key and rescans: every file is back with its first cas_id and
    its bytes, and the BLAKE3 and Gear kernels launched for both rescans."""
    from spacedrive_tpu_torch.locations import create_location, scan_location
    from spacedrive_tpu_torch.models import Location
    from spacedrive_tpu_torch.node import Node

    monkeypatch.setenv("SD_CHUNK_MANIFESTS", "1")
    monkeypatch.setenv("SD_P2P_DISABLED", "1")
    root = tmp_path / "vault"
    root.mkdir()
    sizes = (1, 700, 90 << 10, 150 << 10, 2 << 20, (2 << 20) + 17)
    files = {f"f{i}.bin": blob(500 + i, n) for i, n in enumerate(sizes)}
    for name, data in files.items():
        (root / name).write_bytes(data)
    node = Node(tmp_path / "data", watch_locations=False)
    try:
        lib = node.libraries.create("vault")
        loc = create_location(lib, root)
        lib.db.update(Location, {"id": loc["id"]}, {"generate_preview_media": False})

        def rescan() -> dict:
            before = dict(_kernels.LAUNCHES)
            scan_location(lib, loc["id"])
            assert node.jobs.wait_idle(300)
            for kernel in ("blake3_chunk_cvs", "blake3_merge", "gear_candidates"):
                assert _kernels.LAUNCHES[kernel] > before.get(kernel, 0), kernel
            return {f"{r['name']}.{r['extension']}": r for r in lib.db.query(
                "SELECT id, name, extension, cas_id FROM file_path WHERE is_dir = 0")}

        first = rescan()
        r = node.router.resolve
        r("keys.setup", "master-pw")
        kid = r("keys.add", {"name": "vault"})
        r("files.encryptFiles", {"sources": [first[n]["id"] for n in files], "key_uuid": kid,
                                 "metadata": True, "erase_original": True}, lib.id)
        assert node.jobs.wait_idle(300)
        sealed = rescan()
        assert set(sealed) == {f"{n}.bytes" for n in files}
        plain_ids = {first[n]["cas_id"] for n in files}
        assert all(row["cas_id"] for row in sealed.values())
        assert not {row["cas_id"] for row in sealed.values()} & plain_ids
        r("files.decryptFiles", {"sources": [row["id"] for row in sealed.values()],
                                 "key_uuid": kid, "erase_original": True}, lib.id)
        assert node.jobs.wait_idle(300)
        back = rescan()
        assert {n: row["cas_id"] for n, row in back.items()} == \
            {n: first[n]["cas_id"] for n in files}
        for name, data in files.items():
            assert (root / name).read_bytes() == data
    finally:
        node.shutdown()


def test_a_hash_batch_on_the_card_sets_the_mfu_against_its_roofline(card):
    """``sd_hash_mfu`` of a batch of sampled messages on the card is in
    (0, 1] of the roofline ``ops/roofline.py`` reads from the card (its SM
    count, its maximum SM clock, 680 INT32 operations a block), and the
    batch counts once under the ``cuda`` backend."""
    from spacedrive_tpu_torch import telemetry
    from spacedrive_tpu_torch.objects.hasher import DeviceHasher
    from spacedrive_tpu_torch.ops import roofline

    roof = roofline.card_roofline(card)
    props = torch.cuda.get_device_properties(card)
    assert roof["sms"] == props.multi_processor_count and roof["sm_clock_mhz"] > 0
    assert roof["int32_ops_per_s"] == pytest.approx(roof["sms"] * 64 * roof["sm_clock_mhz"] * 1e6)
    assert roofline.card_roofline(torch.device("cpu")) is None
    telemetry.reset()
    msgs = [blob(i, 57352) for i in range(256)]
    assert DeviceHasher(card).hash_gathered(msgs) == \
        [blake3(m).hex()[:16] for m in msgs]
    assert telemetry.value("sd_hash_batches_total", backend="cuda") == 1
    assert telemetry.value("sd_hash_files_total", backend="cuda") == 256
    assert telemetry.value("sd_hash_bytes_total", backend="cuda") == 256 * 57352
    assert 0 < telemetry.value("sd_hash_mfu") <= 1
