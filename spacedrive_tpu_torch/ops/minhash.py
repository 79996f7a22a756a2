"""MinHash near-duplicate detection: signatures and the all-pairs compare on
the node's device, LSH banding on the host.

Counterpart of ``spacedrive_tpu/ops/minhash.py``. The reference's
signature and all-pairs functions are jitted XLA programs, not Pallas
kernels, so they port as PyTorch ops that run on the tensors' device (the
card, or the CPU in the tests); banding and verification stay numpy on the
host, as in the reference.

- :func:`minhash_rows`: (B, W) u32 rows, the layout ``blake3_batch_rows``
  reads, → (B, K) signatures. A shingle is a consecutive u32 pair (8 bytes
  at an 8-byte stride); each of the K hashes mixes ``lo * a + hi * b + c``
  through a murmur-style finalizer and takes the min over a row's shingles.
- :func:`similar_pairs_count`: the blocked all-pairs compare of (N, K)
  signatures: the count of pairs with at least ``threshold_k`` equal
  components, and a per-row flag for an earlier similar row.

PyTorch implements no arithmetic on uint32 tensors on the CPU, so the
signatures take one of two exact forms of the u32 arithmetic:

- on the CPU, u32 words in int64 masked with 0xFFFFFFFF: a product mod
  2**32 is taken through the multiplier's 16-bit halves (:func:`_mul32`), so
  no int64 product can overflow; the shifts then act on non-negative values
  (logical), and the min of non-negative values is the unsigned min;
- on the card, the words' int32 bit patterns (:func:`_minhash_pass_i32`):
  ``+`` and ``*`` wrap mod 2**32 as u32 arithmetic does, a logical shift is
  the arithmetic one masked to its low 32 - s bits, and flipping the sign
  bit maps the unsigned order onto the signed one for the min. It moves
  half the bytes of the int64 form and needs no product split.

The pair total is int64 (the reference's is int32 unless x64 is on).

``DEVICE_CALLS`` counts the calls of the two device functions on CUDA
tensors, by function.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

MASK = 0xFFFFFFFF

#: signature width (hash count): 64 keeps the estimator's std near 0.05
K = 64

#: deterministic odd multipliers and offsets of the K universal hashes, the
#: reference's (``default_rng(0x5D)``, minhash.py:35-41)
_rng = np.random.default_rng(0x5D)
_A = (_rng.integers(0, 1 << 32, K, dtype=np.uint64) | 1).astype(np.uint32)
_B = (_rng.integers(0, 1 << 32, K, dtype=np.uint64) | 1).astype(np.uint32)
_C = _rng.integers(0, 1 << 32, K, dtype=np.uint64).astype(np.uint32)

DEVICE_CALLS: collections.Counter = collections.Counter()


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32): the products with
    ``c``'s 16-bit halves stay under 2**48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def _mix(x: torch.Tensor) -> torch.Tensor:
    """xorshift-multiply finalizer (murmur-style avalanche) on u32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def minhash_rows(rows: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Signatures of B messages on the rows' device. ``rows``: (B, W) u32
    words in any integer carrier (int32 from the gather's bytes, uint32,
    int64); ``lengths``: (B,) true byte lengths. Returns (B, K) int64
    values in [0, 2**32)."""
    if rows.dim() != 2 or rows.shape[1] % 2:
        raise ValueError(f"rows must be (B, W) words with W even, got {tuple(rows.shape)}")
    if lengths.shape != (rows.shape[0],):
        raise ValueError("lengths must be (B,)")
    if rows.is_cuda:
        DEVICE_CALLS["minhash_rows"] += 1
    B, W = rows.shape
    if B == 0:
        return torch.zeros((0, K), dtype=torch.int64, device=rows.device)
    one_pass, itemsize = (_minhash_pass_i32, 4) if rows.is_cuda else (_minhash_pass, 8)
    step = max(1, PASS_BYTES[rows.device.type] // (W // 2 * itemsize))
    return torch.cat([one_pass(rows[s : s + step], lengths[s : s + step])
                      for s in range(0, B, step)])


#: bytes of one (rows, W/2) temporary of a :func:`minhash_rows` pass, which
#: bounds the passes' memory: 256 MiB on the card (an 8192-row batch of
#: int32 in one pass), 4 MiB on the CPU
PASS_BYTES = {"cpu": 1 << 22, "cuda": 1 << 28}


def _minhash_pass(rows: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    words = rows.to(torch.int64) & MASK
    lo, hi = words[:, 0::2], words[:, 1::2]                      # (B, W/2)
    n_shingles = (lengths.to(torch.int64) // 8).clamp_min(1)
    idx = torch.arange(lo.shape[1], device=rows.device)[None, :]
    invalid = idx >= n_shingles[:, None]
    sigs = []
    for a, b, c in zip(_A.tolist(), _B.tolist(), _C.tolist()):
        h = _mix((_mul32(lo, a) + _mul32(hi, b) + c) & MASK)
        sigs.append(h.masked_fill_(invalid, MASK).amin(dim=1))
    return torch.stack(sigs, dim=1)


def _s32(v: int) -> int:
    """The int32 whose bit pattern is the u32 ``v``."""
    return v - (1 << 32) if v >= 1 << 31 else v


#: the int32 sign bit: xor with it maps u32 order onto int32 order
_SIGN = -(1 << 31)


def _mix_i32(x: torch.Tensor) -> torch.Tensor:
    """:func:`_mix` on int32 bit patterns."""
    x = x ^ ((x >> 16) & 0xFFFF)
    x = x * _s32(0x7FEB352D)
    x = x ^ ((x >> 15) & 0x1FFFF)
    x = x * _s32(0x846CA68B)
    return x ^ ((x >> 16) & 0xFFFF)


def _minhash_pass_i32(rows: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """:func:`_minhash_pass` on the words' int32 bit patterns (the card's
    form, held exact against the int64 form on edge rows)."""
    if rows.dtype in (torch.int32, torch.uint32):
        words = rows.view(torch.int32)
    else:
        words = (rows.to(torch.int64) & MASK).to(torch.int32)
    lo, hi = words[:, 0::2], words[:, 1::2]                      # (B, W/2)
    n_shingles = (lengths.to(torch.int64) // 8).clamp_min(1)
    idx = torch.arange(lo.shape[1], device=rows.device)[None, :]
    invalid = idx >= n_shingles[:, None]
    sigs = []
    for a, b, c in zip(_A.tolist(), _B.tolist(), _C.tolist()):
        h = _mix_i32(lo * _s32(a) + hi * _s32(b) + _s32(c)) ^ _SIGN
        sigs.append(h.masked_fill_(invalid, (1 << 31) - 1).amin(dim=1))
    return (torch.stack(sigs, dim=1) ^ _SIGN).to(torch.int64) & MASK


#: rows per compare block: the (BLOCK, N, K) comparison stays under 2.2 GB
#: at N = 65,536
BLOCK = 512


def similar_pairs_count(sigs: torch.Tensor, valid: torch.Tensor,
                        threshold_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """All-pairs signature compare on the signatures' device.

    ``sigs``: (N, K) integer signatures, N a multiple of BLOCK (pad with
    invalid rows, :func:`pad_for_blocks`); ``valid``: (N,) bool. A pair
    (i < j) is similar when at least ``threshold_k`` of K components match.
    Returns (the int64 count of similar pairs, a (N,) bool flag of rows
    with a similar earlier row)."""
    N = sigs.shape[0]
    if N % BLOCK:
        raise ValueError(f"N = {N} is not a multiple of BLOCK = {BLOCK}; pad_for_blocks first")
    if sigs.is_cuda:
        DEVICE_CALLS["similar_pairs_count"] += 1
    valid = valid.to(torch.bool)
    row_idx = torch.arange(N, device=sigs.device)
    total = torch.zeros((), dtype=torch.int64, device=sigs.device)
    dup = torch.zeros(N, dtype=torch.bool, device=sigs.device)
    for start in range(0, N, BLOCK):
        blk = sigs[start : start + BLOCK]
        eq = (blk[:, None, :] == sigs[None, :, :]).sum(dim=2)     # (BLOCK, N)
        hits = ((eq >= threshold_k) & valid[start : start + BLOCK, None] & valid[None, :]
                & (row_idx[start : start + BLOCK, None] > row_idx[None, :]))
        total += hits.sum()
        dup[start : start + BLOCK] = hits.any(dim=1)
    return total, dup


def similar_pairs_count_cpu(sigs: np.ndarray, valid: np.ndarray,
                            threshold_k: int) -> tuple[int, np.ndarray]:
    """The same blocked algorithm in numpy (the reference's baseline)."""
    N, _k = sigs.shape
    total = 0
    dup = np.zeros(N, bool)
    row_idx = np.arange(N)
    for start in range(0, N, BLOCK):
        blk = sigs[start : start + BLOCK]
        eq = (blk[:, None, :] == sigs[None, :, :]).sum(axis=2)
        pairmask = (eq >= threshold_k) & valid[start : start + BLOCK, None] & valid[None, :]
        earlier = (start + np.arange(blk.shape[0]))[:, None] > row_idx[None, :]
        hits = pairmask & earlier
        total += int(hits.sum())
        dup[start : start + BLOCK] = hits.any(axis=1)
    return total, dup


def pad_for_blocks(sigs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pad N up to a BLOCK multiple; padding rows are invalid."""
    N = sigs.shape[0]
    Np = -(-N // BLOCK) * BLOCK
    valid = np.zeros(Np, bool)
    valid[:N] = True
    if Np != N:
        sigs = np.concatenate([sigs, np.zeros((Np - N, sigs.shape[1]), sigs.dtype)])
    return sigs, valid


# ---------------------------------------------------------------------------
# LSH banding (host numpy, as in the reference): candidate pairs from shared
# band buckets in O(N * BANDS), then exact verification of the candidates
# ---------------------------------------------------------------------------

BANDS = 16
BAND_ROWS = K // BANDS  # 4

#: buckets larger than this pair members against one representative
#: instead of all-pairs (a bucket of thousands of identical signatures must
#: stay detected without going quadratic); callers report how many
MAX_BUCKET = 256


def band_keys(sigs: np.ndarray) -> np.ndarray:
    """(N, BANDS) uint64 bucket keys: an FNV-style fold of each band's rows,
    salted per band. Two rows sharing a band key are candidates; with true
    similarity s, P[candidate] = 1 - (1 - s**BAND_ROWS)**BANDS."""
    n = sigs.shape[0]
    bands = sigs.reshape(n, BANDS, BAND_ROWS).astype(np.uint64)
    with np.errstate(over="ignore"):
        key = np.full((n, BANDS), 0xCBF29CE484222325, np.uint64)
        for r in range(BAND_ROWS):
            key ^= bands[:, :, r]
            key *= np.uint64(0x100000001B3)
        key ^= np.arange(BANDS, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    return key


def banded_candidate_pairs(keys: np.ndarray,
                           valid: np.ndarray) -> tuple[np.ndarray, int]:
    """Candidate pairs ((P, 2) int64, i < j, unique) from shared band
    buckets, and the count of oversized buckets, which pair (first member,
    each other member). Per band a sort groups equal keys into runs; runs
    batch by length, each batch emitting its pairs with one triu gather;
    the union over bands dedups through packed ``(i << 32) | j`` codes."""
    valid = np.asarray(valid, bool)
    if valid.shape[0] != keys.shape[0]:
        raise ValueError(f"valid mask has {valid.shape[0]} entries for "
                         f"{keys.shape[0]} signatures")
    idx_valid = np.flatnonzero(valid)
    chunks: list[np.ndarray] = []
    oversized = 0
    for b in range(BANDS):
        k = keys[idx_valid, b]
        order = np.argsort(k, kind="stable")
        ks = k[order]
        ids = idx_valid[order]
        if ks.size == 0:
            continue
        run_start = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
        run_len = np.diff(np.r_[run_start, ks.size])
        for length in np.unique(run_len):
            if length < 2:
                continue
            starts = run_start[run_len == length]
            members = ids[starts[:, None] + np.arange(length)]
            if length > MAX_BUCKET:
                oversized += len(starts)
                a = np.repeat(members[:, 0], length - 1)
                c = members[:, 1:].ravel()
            else:
                iu, ju = np.triu_indices(int(length), 1)
                a = members[:, iu].ravel()
                c = members[:, ju].ravel()
            lo = np.minimum(a, c).astype(np.uint64)
            hi = np.maximum(a, c).astype(np.uint64)
            chunks.append((lo << np.uint64(32)) | hi)
    if not chunks:
        return np.empty((0, 2), np.int64), oversized
    packed = np.unique(np.concatenate(chunks))
    pairs = np.empty((packed.size, 2), np.int64)
    pairs[:, 0] = (packed >> np.uint64(32)).astype(np.int64)
    pairs[:, 1] = (packed & np.uint64(0xFFFFFFFF)).astype(np.int64)
    return pairs, oversized


def verify_pairs(sigs: np.ndarray, pairs, threshold_k: int) -> list:
    """Exact signature compare over candidate pairs; returns
    ``[(i, j, matching_components)]`` of the pairs at the threshold or above.
    ``pairs``: the (P, 2) array :func:`banded_candidate_pairs` returns, or a
    set of tuples."""
    if isinstance(pairs, np.ndarray):
        arr = pairs
    else:
        if not pairs:
            return []
        arr = np.asarray(sorted(pairs), np.int64)
    if arr.size == 0:
        return []
    out = []
    for start in range(0, len(arr), 65536):
        chunk = arr[start : start + 65536]
        eq = (sigs[chunk[:, 0]] == sigs[chunk[:, 1]]).sum(axis=1)
        keep = eq >= threshold_k
        for (i, j), m in zip(chunk[keep], eq[keep]):
            out.append((int(i), int(j), int(m)))
    return out
