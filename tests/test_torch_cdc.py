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
from tests.torch_gear_edges import edge_plane
from tests.torch_scan_cases import one_torch_thread  # noqa: F401

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


# --------------------------------------------------------------------------
# the CUDA kernel's index arithmetic (csrc/cdc.cu), emulated with numpy
# --------------------------------------------------------------------------

LANES, SEG = 32, 16  # csrc/cdc.cu kLanes, kSeg
UNIT = LANES * SEG   # positions per warp unit


def emulate_gear_kernel(plane: np.ndarray, lengths: np.ndarray, mask: int) -> np.ndarray:
    """``gear_candidates_kernel`` step by step in wrapping uint32 numpy: warp
    units of 512 positions, 16 per lane read only where the lane starts
    before the length (0 bytes otherwise, and past L), each lane's sum
    E = sum_i G[b_i] << (15 - i), the unit's 32-byte halo (0 at the row
    start), the hash before each lane as E_{l-1} + (E_{l-2} << 16) by
    shuffles, 16 recurrence steps, the length cut, and nothing stored past L.
    Units at or past the length store zeros."""
    B, L = plane.shape
    units = -(-L // UNIT)
    gear = cdc.GEAR.numpy().astype(np.uint32)
    lens = np.clip(lengths.astype(np.int64), 0, L)
    flat = np.zeros((B, units * UNIT), np.uint8)
    flat[:, :L] = plane
    lane_start = np.arange(units * LANES).reshape(units, LANES) * SEG  # (U, 32)
    read = lane_start[None] < lens[:, None, None]                      # (B, U, 32)
    g = gear[np.where(read[..., None], flat.reshape(B, units, LANES, SEG), 0)]
    e = np.zeros((B, units, LANES), np.uint32)
    for i in range(SEG):
        e = (e << np.uint32(1)) + g[..., i]
    # halo bytes p0-32 .. p0-1 of every unit but the first of a row
    halo_pos = (np.arange(units) * UNIT)[:, None] - 32 + np.arange(32)[None, :]  # (U, 32)
    hb = gear[flat[:, np.maximum(halo_pos, 0)]]                                   # (B, U, 32)
    hb[:, 0] = 0
    shifts = np.uint32(15) - (np.arange(32) % 16).astype(np.uint32)
    terms = hb << shifts
    e_m2 = terms[..., :16].sum(-1, dtype=np.uint32)
    e_m1 = terms[..., 16:].sum(-1, dtype=np.uint32)
    e1 = np.concatenate([e_m1[..., None], e[..., :-1]], axis=-1)
    e2 = np.concatenate([e_m2[..., None], e_m1[..., None], e[..., :-2]], axis=-1)
    h = e1 + (e2 << np.uint32(16))
    flags = np.zeros((B, units, LANES, SEG), bool)
    for i in range(SEG):
        h = (h << np.uint32(1)) + g[..., i]
        flags[..., i] = (h & np.uint32(mask)) == 0
    pos = np.arange(units * UNIT).reshape(units, LANES, SEG)
    flags &= pos[None] < lens[:, None, None, None]
    return flags.reshape(B, units * UNIT)[:, :L]


@pytest.mark.parametrize("mask", [0, 255, 8191, 0xFF000000])
@pytest.mark.parametrize("L", [256, 4096, 1000])
def test_kernel_arithmetic_matches_plain_and_jax(L, mask):
    """L = 256 is a row shorter than a unit, 4096 crosses seven unit
    boundaries, 1000 is not a multiple of 16 (the kernel's byte path). A
    mask of low bits reads only the last bytes of the window; 0xFF000000
    reads the bytes 24-31 back, which lanes 0-1 take from the halo and the
    others from E_{l-2}. Tolerance zero."""
    plane, lengths = edge_plane(L, L + mask)
    got = emulate_gear_kernel(plane, lengths, mask)
    plain = cdc.gear_candidates(torch.from_numpy(plane), torch.from_numpy(lengths), mask)
    assert np.array_equal(got, plain.numpy().astype(bool))
    assert np.array_equal(got, jax_cdc._candidates_numpy(plane, lengths, mask))
    if mask == 0:  # every position below the length is a candidate
        assert np.array_equal(got.sum(1), lengths)


def test_launches_count_by_tag_and_shape(monkeypatch):
    """``_kernels.launch`` counts each launch by kernel and by (kernel, the
    thread's tag, shape); tags nest, and another thread's launches stay
    untagged. The C library is replaced by a stub that reports success."""
    import threading
    import types

    from spacedrive_tpu_torch.ops import _kernels

    monkeypatch.setattr(_kernels, "library",
                        lambda source: types.SimpleNamespace(gear_candidates=lambda *a: 0))
    _kernels.reset_counts()
    with _kernels.tagged("chunk-ids"):
        _kernels.launch("cdc", "gear_candidates", shape=(32, 4096))
        with _kernels.tagged("cas"):
            _kernels.launch("cdc", "gear_candidates", shape=(32, 4096))
        worker = threading.Thread(
            target=lambda: _kernels.launch("cdc", "gear_candidates", shape=(8, 256)))
        worker.start()
        worker.join()
        _kernels.launch("cdc", "gear_candidates", shape=(32, 4096))
    assert _kernels.LAUNCHES["gear_candidates"] == 4
    assert dict(_kernels.LAUNCHES_BY_SHAPE) == {
        ("gear_candidates", "chunk-ids", (32, 4096)): 2,
        ("gear_candidates", "cas", (32, 4096)): 1,
        ("gear_candidates", None, (8, 256)): 1}
    _kernels.reset_counts()
    assert not _kernels.LAUNCHES and not _kernels.LAUNCHES_BY_SHAPE
