"""The Gear kernel's edge-length plane, shared by tests/test_torch_cdc.py
(on the CPU, against the JAX package) and tests/test_torch_on_card.py (on
the card, no jax). It imports numpy and the port only."""

import numpy as np

from spacedrive_tpu_torch.ops import cdc

#: lengths at the Gear kernel's edges: its 16-position lanes, 32-byte halo
#: and 512-position units (L - 1 and L added per plane)
GEAR_EDGES = (0, 1, 15, 16, 17, 30, 31, 32, 33, 511, 512, 513, 1023, 1024, 1025)


def edge_plane(L: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """One row per edge length (those <= L, plus L - 1 and L) in a plane
    padded to its batch tier with rows of length 0; every byte, past the
    lengths and in the padding rows too, is random, and row 1 starts with a
    run of equal bytes."""
    lens = sorted({n for n in GEAR_EDGES + (L - 1, L) if 0 <= n <= L})
    rng = np.random.default_rng(seed)
    plane = rng.integers(0, 256, size=(cdc._batch_tier(len(lens)), L), dtype=np.uint8)
    plane[1, :600] = 0
    lengths = np.zeros(plane.shape[0], np.int32)
    lengths[: len(lens)] = lens
    return plane, lengths
