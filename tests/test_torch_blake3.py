"""The port's BLAKE3 (spacedrive_tpu_torch/ops/blake3.py) against the JAX
package's (ops/blake3_jax.py, XLA rung) and the pure-Python oracle.

Everything here runs the plain PyTorch version on the CPU; the CUDA kernels
are held to the same plain version on the card by
tests/test_torch_on_card.py and by chip_smoke.py. Digests are bytes, so
every comparison is exact (tolerance zero).
"""

import struct

import numpy as np
import pytest
import torch

from spacedrive_tpu.objects import blake3_ref as jax_ref
from spacedrive_tpu.objects import cas as jax_cas
from spacedrive_tpu.ops import blake3_jax, blake3_pallas
from spacedrive_tpu.ops import cdc as jax_cdc
from spacedrive_tpu_torch.objects import blake3_ref, cas
from spacedrive_tpu_torch.objects.hasher import DeviceHasher
from spacedrive_tpu_torch.ops import blake3 as b3
from spacedrive_tpu_torch.ops.tables import port_tables, tables_from_reference
from tests.torch_scan_cases import one_torch_thread  # noqa: F401

EDGE_LENGTHS = (0, 1, 63, 64, 65, 1023, 1024, 1025, 2048, 2049, 57352, 102408)


def blob(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, size=n, dtype=np.uint8).tobytes()


EDGE = [blob(100 + i, n) for i, n in enumerate(EDGE_LENGTHS)]


@pytest.fixture(scope="module")
def edge_digests():
    """(port, jax, oracle) hex digests of the edge messages, one call each
    in the 101-chunk bucket (a non-power-of-two chunk count)."""
    port = b3.blake3_batch_hex(EDGE, max_chunks=101, device="cpu")
    jax = blake3_jax.blake3_batch_hex(EDGE, max_chunks=101, kernel="xla")
    oracle = [blake3_ref.blake3(m).hex() for m in EDGE]
    return port, jax, oracle


@pytest.mark.parametrize("i", range(len(EDGE_LENGTHS)), ids=[str(n) for n in EDGE_LENGTHS])
def test_edge_length_digest(edge_digests, i):
    port, jax, oracle = edge_digests
    assert port[i] == jax[i] == oracle[i]


@pytest.mark.parametrize("n", EDGE_LENGTHS)
def test_port_oracle_matches_jax_oracle(n):
    msg = blob(n, n)
    assert blake3_ref.blake3(msg) == jax_ref.blake3(msg)


def test_sampled_layout_matches_jax(tmp_path):
    """Files over 100 KiB: the port's gather builds the same 57,352-byte
    message as the JAX package's, and the 64-chunk bucket hashes it to the
    same digest."""
    sizes = [102401, 150_000, 300_007, 1_000_003, 5 * 1024 * 1024 + 11]
    paths = []
    for i, size in enumerate(sizes):
        p = tmp_path / f"f{i}.bin"
        p.write_bytes(blob(i, size))
        paths.append(p)
    port_msgs = cas.read_sampled_batch(paths, sizes)
    jax_msgs = jax_cas.read_sampled_batch(paths, sizes)
    assert port_msgs == jax_msgs
    assert all(len(m) == cas.SAMPLED_MESSAGE_LEN for m in port_msgs)
    assert b3.blake3_batch_hex(port_msgs, max_chunks=64, device="cpu") == \
        blake3_jax.blake3_batch_hex(jax_msgs, max_chunks=64, kernel="xla")
    for p, size in zip(paths, sizes):
        assert cas.generate_cas_id(p) == jax_cas.generate_cas_id(p, size)


def test_small_file_messages_and_hasher_buckets(tmp_path):
    """Whole-file messages below 100 KiB, bucketed by the port's hasher,
    give the cas_ids of the JAX oracle path; a vanished file passes through
    as its exception."""
    sizes = [1, 100, 1024, 1025, 5000, 70_000, 102400]
    paths = []
    for i, size in enumerate(sizes):
        p = tmp_path / f"s{i}.txt"
        p.write_bytes(blob(50 + i, size))
        paths.append(p)
    paths.append(tmp_path / "gone.txt")
    sizes.append(10)
    got = DeviceHasher(torch.device("cpu")).hash_batch(paths, sizes)
    assert got[:-1] == [jax_cas.generate_cas_id(p, s) for p, s in zip(paths, sizes[:-1])]
    assert isinstance(got[-1], OSError)


def test_batch_rows_and_jax_layout_agree():
    msgs = [blob(7, n) for n in (0, 5, 1024, 3000, 4096)] + [b""] * 3
    rows, lengths = b3.pack_rows(msgs, 4)
    words, lengths2 = b3.pack_messages(msgs, 4)
    jwords, jlengths = blake3_jax.pack_messages(msgs, 4)
    assert np.array_equal(words, jwords) and np.array_equal(lengths, jlengths)
    assert np.array_equal(lengths, lengths2)
    by_rows = b3.blake3_batch_rows(torch.from_numpy(rows), torch.from_numpy(lengths))
    by_words = b3.blake3_batch(torch.from_numpy(words.astype(np.int64)),
                               torch.from_numpy(lengths))
    assert torch.equal(by_rows, by_words)
    jax_rows = np.asarray(blake3_jax.blake3_batch_rows(rows.view(np.uint32), lengths,
                                                       kernel="xla"))
    assert np.array_equal(b3.u32(by_rows).numpy().astype(np.uint32), jax_rows)
    assert b3.digests_to_hex(by_rows) == blake3_jax.digests_to_hex(jax_rows)


def test_batch_tiers_match_jax():
    assert b3.BATCH_TIERS == blake3_jax.BATCH_TIERS
    for n in list(range(1, 70)) + [511, 512, 513, 4095, 4096, 4097, 9000]:
        assert b3._pad_to_tier(n) == blake3_jax._pad_to_tier(n)


def test_compress_matches_oracle():
    rng = np.random.default_rng(5)
    lanes = 6
    cv = rng.integers(0, 2**32, size=(8, lanes), dtype=np.uint64)
    m = rng.integers(0, 2**32, size=(16, lanes), dtype=np.uint64)
    counter = rng.integers(0, 2**32, size=lanes, dtype=np.uint64)
    block_len = rng.integers(0, 65, size=lanes, dtype=np.uint64)
    flags = rng.integers(0, 16, size=lanes, dtype=np.uint64)
    t = lambda a: torch.from_numpy(a.astype(np.int64))  # noqa: E731
    out = b3.compress([t(w) for w in cv], [t(w) for w in m], t(counter), t(block_len), t(flags))
    for j in range(lanes):
        want = jax_ref.compress([int(x) for x in cv[:, j]], [int(x) for x in m[:, j]],
                                int(counter[j]), int(block_len[j]), int(flags[j]))[:8]
        assert [int(w[j]) for w in out] == want


def test_chunk_cvs_zero_past_chunk_count_and_root_on_single_chunk():
    msgs = [blob(9, 10), blob(9, 3000)] + [b""] * 6
    rows, lengths = b3.pack_rows(msgs, 4)
    cvs = b3.chunk_cvs(torch.from_numpy(rows), torch.from_numpy(lengths))
    assert cvs.shape == (8, 4, 8)
    assert not cvs[0, 1:].any() and not cvs[1, 3:].any() and cvs[1, :3].all()
    # a one-chunk message's chunk CV is its digest (ROOT on the final block)
    digest = struct.unpack("<8I", blake3_ref.blake3(msgs[0]))
    assert [int(x) for x in cvs[0, 0]] == list(digest)


def test_lengths_past_the_row_are_clamped_like_the_kernels():
    rows, lengths = b3.pack_rows([blob(3, 2048)] + [b""] * 7, 2)
    too_long = torch.from_numpy(lengths).clone()
    too_long[0] = 10_000
    a = b3.blake3_batch_rows(torch.from_numpy(rows), too_long)
    too_long[0] = 2048
    assert torch.equal(a, b3.blake3_batch_rows(torch.from_numpy(rows), too_long))


def test_tables_from_reference_match_port_tables():
    ref = tables_from_reference(jax_cdc.GEAR, np.asarray(jax_ref.IV, np.uint32),
                                np.asarray(jax_ref.MSG_PERMUTATION))
    own = port_tables()
    assert set(ref) == set(own) == {"gear", "iv", "perm", "schedule"}
    for key in own:
        assert torch.equal(ref[key], own[key]), key
    assert own["schedule"].tolist() == [list(r) for r in blake3_pallas.MSG_SCHEDULE]
    assert b3.MSG_SCHEDULE == blake3_pallas.MSG_SCHEDULE


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        b3.blake3_batch_hex([b"abc"])
