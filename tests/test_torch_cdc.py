"""The port's Gear CDC (spacedrive_tpu_torch/ops/cdc.py) against the JAX
package's numpy rung and per-byte oracle (ops/cdc.py), with the small
geometry of tests/test_cdc.py: candidate bitmaps, boundaries, chunk ids and
manifests are bytes, so every comparison is exact (tolerance zero).

The CUDA kernel is held to the same plain version on the card by
tests/test_torch_on_card.py and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from spacedrive_tpu.ops import cdc as jax_cdc
from spacedrive_tpu_torch.ops import cdc

SMALL = (64, 256, 1024)
GEOMETRIES = [SMALL, (256, 1024, 4096)]


def blob(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, size=n, dtype=np.uint8).tobytes()


DATASETS = [b"", b"a", blob(7, 255), blob(8, 256), blob(9, 4096), blob(10, 70_000),
            b"\x00" * 4096, b"\xff" * 3000]


def params(geom):
    return cdc.ChunkParams(*geom), jax_cdc.ChunkParams(*geom)


def test_gear_table_is_the_pinned_table():
    assert cdc.GEAR.dtype == torch.int64 and cdc.GEAR.shape == (256,)
    assert np.array_equal(cdc.GEAR.numpy().astype(np.uint32), jax_cdc.GEAR)
    assert cdc.gear_table() == [int(x) for x in jax_cdc._gear_table()]


@pytest.mark.parametrize("geom", GEOMETRIES, ids=str)
def test_bitmaps_match_numpy_rung(geom):
    port_p, jax_p = params(geom)
    got = cdc.candidate_bitmaps(DATASETS, port_p, device="cpu")
    want = jax_cdc.candidate_bitmaps(DATASETS, jax_p, kernel="numpy")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == bool and np.array_equal(g, w)


@pytest.mark.parametrize("geom", GEOMETRIES, ids=str)
def test_boundaries_match_numpy_rung_and_oracle(geom):
    port_p, jax_p = params(geom)
    got = cdc.chunk_batch(DATASETS, port_p, device="cpu")
    assert got == jax_cdc.chunk_batch(DATASETS, jax_p, kernel="numpy")
    assert got == [jax_cdc.chunk_ref(d, jax_p) for d in DATASETS]


@pytest.mark.parametrize("i", range(len(DATASETS)))
def test_per_byte_oracle_matches_jax(i):
    port_p, jax_p = params(SMALL)
    assert cdc.chunk_boundaries_ref(DATASETS[i], port_p) == \
        jax_cdc.chunk_boundaries_ref(DATASETS[i], jax_p)


def test_chunk_ids_match_jax():
    port_p, jax_p = params(SMALL)
    chunks = cdc.chunk_batch(DATASETS, port_p, device="cpu")
    got = cdc.chunk_ids(DATASETS, chunks, port_p, device="cpu")
    assert got == jax_cdc.chunk_ids(DATASETS, chunks, jax_p, kernel="numpy")
    assert all(len(cid) == cdc.CHUNK_ID_HEX for ids in got for cid in ids)


def test_manifest_matches_jax_at_default_geometry():
    data = blob(11, 150_000)
    assert cdc.build_manifest(data, device="cpu") == jax_cdc.build_manifest(data, kernel="numpy")


@pytest.mark.parametrize("cands,n", [([], 2500), ([], 1024), ([], 10),
                                     ([10, 30, 63, 100], 500), ([500], 3000),
                                     (list(range(1, 5000)), 5000)])
def test_resolve_cuts_matches_jax(cands, n):
    port_p, jax_p = params(SMALL)
    assert cdc.resolve_cuts(cands, n, port_p) == jax_cdc.resolve_cuts(cands, n, jax_p)


def test_tiers_match_jax():
    for n in [1, 255, 256, 257, 4096, 70_000, 1 << 22, (1 << 22) + 1]:
        assert cdc._len_tier(n) == jax_cdc._len_tier(n)
    for b in [1, 8, 9, 32, 33, 512, 513, 2000]:
        assert cdc._batch_tier(b) == jax_cdc._batch_tier(b)
    assert cdc._CELL_BUDGET == jax_cdc._CELL_BUDGET


@pytest.mark.parametrize("bits", range(1, 13))
def test_positions_before_the_file_start_contribute_zero(bits):
    """A window reaching before byte 0 sums only real bytes. Had it summed
    GEAR[0] for the missing bytes, position 0 of a row starting with byte b
    would test GEAR[b] - 2*GEAR[0] instead of GEAR[b]; rows starting with
    each of the 256 byte values at every mask width catch that."""
    rng = np.random.default_rng(bits)
    plane = rng.integers(0, 256, size=(256, 48), dtype=np.uint8)
    plane[:, 0] = np.arange(256)
    lengths = np.full(256, 40, np.int32)  # past-length positions are masked too
    mask = (1 << bits) - 1
    got = cdc.gear_candidates(torch.from_numpy(plane), torch.from_numpy(lengths), mask)
    want = jax_cdc._candidates_numpy(plane, lengths, mask)
    assert np.array_equal(got.numpy().astype(bool), want)
