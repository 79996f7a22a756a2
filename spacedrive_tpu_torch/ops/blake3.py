"""Batched BLAKE3 — the cas_id and chunk-id hash, on the card.

Counterpart of ``spacedrive_tpu/ops/blake3_jax.py`` (orchestration) plus
``ops/blake3_pallas.py`` (the compression kernel). The public functions keep
the JAX signatures and layouts:

- :func:`blake3_batch` takes ``(16 blocks, 16 words, C chunks, B)`` u32 words
  and ``(B,)`` int32 byte lengths and returns ``(8, B)`` digest words;
- :func:`blake3_batch_rows` takes ``(B, C*256)`` u32 rows, one message per
  row in natural byte order (the layout the kernels read);
- :func:`pack_messages`, :func:`digests_to_hex`, ``BATCH_TIERS`` and
  :func:`blake3_batch_hex` as in the JAX module.

On a CUDA tensor the hash is two kernel launches (``csrc/blake3.cu``):
``blake3_chunk_cvs`` (one thread per real chunk: lanes numbered over the
batch's chunks through a prefix of the per-message chunk counts built on the
card, all 16 blocks in registers, ROOT on the final block of one-chunk
messages, zeros past each message's chunk count) then ``blake3_merge`` (one
block per group of messages; at each level the pairs of all the group's
messages form one list, merged in place in shared memory). On a CPU
tensor the same two phases run as the plain PyTorch version below: the
``compress`` function and the two-phase orchestration of
``_blake3_batch_impl``/``_single_chunk_root``. u32 words are kept in int64
and masked with 0xFFFFFFFF because CPU builds of PyTorch implement no
arithmetic on uint32 tensors; on the card, words travel as int32 tensors
(the same 32 bits), which is what the kernels return.

Messages are zero-padded to their row: bytes past a message's length must be
zero, as in the JAX module.
"""

from __future__ import annotations

import numpy as np
import torch

from ..objects.blake3_ref import (BLOCK_LEN, CHUNK_END, CHUNK_LEN, CHUNK_START,
                                  IV, MSG_PERMUTATION, PARENT, ROOT)
from . import _kernels

BLOCKS_PER_CHUNK = CHUNK_LEN // BLOCK_LEN
WORDS_PER_CHUNK = CHUNK_LEN // 4
MASK = 0xFFFFFFFF

#: chunks per message row the kernels take: the merge kernel keeps a
#: message's C chaining values in shared memory (32 bytes a chunk, merged in
#: place), 112 KiB at this bound, under the 227 KB a block may take
MAX_CHUNKS = 3584


def message_schedule(perm) -> tuple[tuple[int, ...], ...]:
    """Per-round message word order: round r, slot s reads original word
    ``schedule[r][s]`` (the permutation baked into the schedule, as the
    Pallas kernel bakes it, ``blake3_pallas.py:54-65``)."""
    rounds = [tuple(range(16))]
    for _ in range(6):
        rounds.append(tuple(rounds[-1][int(p)] for p in perm))
    return tuple(rounds)


MSG_SCHEDULE = message_schedule(MSG_PERMUTATION)


# --------------------------------------------------------------------------
# plain PyTorch version (int64 words masked to 32 bits)
# --------------------------------------------------------------------------


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & MASK


def _g(v, a, b, c, d, mx, my) -> None:
    v[a] = (v[a] + v[b] + mx) & MASK
    v[d] = _rotr(v[d] ^ v[a], 16)
    v[c] = (v[c] + v[d]) & MASK
    v[b] = _rotr(v[b] ^ v[c], 12)
    v[a] = (v[a] + v[b] + my) & MASK
    v[d] = _rotr(v[d] ^ v[a], 8)
    v[c] = (v[c] + v[d]) & MASK
    v[b] = _rotr(v[b] ^ v[c], 7)


def compress(cv, m, counter, block_len, flags) -> list[torch.Tensor]:
    """One BLAKE3 compression broadcast over the lane shape. ``cv``: 8 int64
    tensors; ``m``: 16 int64 tensors; ``counter``/``block_len``/``flags``:
    int64 tensors broadcastable to the lanes (counter high word is 0).
    Returns the 8 output words (chaining value / digest head)."""
    shape = torch.broadcast_shapes(cv[0].shape, m[0].shape, counter.shape,
                                   block_len.shape, flags.shape)
    zero = torch.zeros(shape, dtype=torch.int64, device=cv[0].device)
    v = [w + zero for w in cv]
    v += [zero + IV[i] for i in range(4)]
    v += [counter + zero, zero, block_len + zero, flags + zero]
    for r in range(7):
        s = MSG_SCHEDULE[r]
        _g(v, 0, 4, 8, 12, m[s[0]], m[s[1]])
        _g(v, 1, 5, 9, 13, m[s[2]], m[s[3]])
        _g(v, 2, 6, 10, 14, m[s[4]], m[s[5]])
        _g(v, 3, 7, 11, 15, m[s[6]], m[s[7]])
        _g(v, 0, 5, 10, 15, m[s[8]], m[s[9]])
        _g(v, 1, 6, 11, 12, m[s[10]], m[s[11]])
        _g(v, 2, 7, 8, 13, m[s[12]], m[s[13]])
        _g(v, 3, 4, 9, 14, m[s[14]], m[s[15]])
    return [v[i] ^ v[i + 8] for i in range(8)]


def u32(t: torch.Tensor) -> torch.Tensor:
    """Any carrier of u32 words (int32 from a kernel, uint32, int64) as
    int64 values in [0, 2**32)."""
    return t.to(torch.int64) & MASK


def _clamped_lengths(lengths: torch.Tensor, C: int) -> torch.Tensor:
    # the kernels clamp the same way, so a length past the row cannot read
    # or merge out of bounds; valid inputs (<= C*1024) are unaffected
    return lengths.to(torch.int64).clamp(0, C * CHUNK_LEN)


def _n_chunks(lengths: torch.Tensor) -> torch.Tensor:
    return ((lengths + (CHUNK_LEN - 1)) // CHUNK_LEN).clamp_min(1)


def _note_plain(kernel: str, t: torch.Tensor) -> None:
    if t.is_cuda:
        _kernels.PLAIN_ON_CUDA[kernel] += 1


def chunk_cvs_plain(rows: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Phase 1: every chunk's chaining value, ``(B, C, 8)`` int64. A
    one-chunk message's chunk 0 takes CHUNK_END|ROOT on its final block, so
    its CV is the digest (``_single_chunk_root``). Chunks past a message's
    chunk count are zero."""
    _note_plain("blake3_chunk_cvs", rows)
    B, W = rows.shape
    C = W // WORDS_PER_CHUNK
    words = u32(rows).reshape(B, C, BLOCKS_PER_CHUNK, 16)
    lengths = _clamped_lengths(lengths, C)
    n_chunks = _n_chunks(lengths)                                   # (B,)
    chunk_idx = torch.arange(C, dtype=torch.int64, device=rows.device)[None, :]
    chunk_len = (lengths[:, None] - chunk_idx * CHUNK_LEN).clamp(0, CHUNK_LEN)
    n_blocks = ((chunk_len + (BLOCK_LEN - 1)) // BLOCK_LEN).clamp_min(1)
    single = (n_chunks[:, None] == 1) & (chunk_idx == 0)           # (B, C)
    cv = [torch.full((B, C), IV[w], dtype=torch.int64, device=rows.device)
          for w in range(8)]
    for j in range(BLOCKS_PER_CHUNK):
        block_len = (chunk_len - j * BLOCK_LEN).clamp(0, BLOCK_LEN)
        final = n_blocks == j + 1
        flags = (final.long() * CHUNK_END
                 + (final & single).long() * ROOT + (CHUNK_START if j == 0 else 0))
        out = compress(cv, [words[:, :, j, w] for w in range(16)],
                       chunk_idx, block_len, flags)
        keep = j < n_blocks
        cv = [torch.where(keep, out[w], cv[w]) for w in range(8)]
    valid = chunk_idx < n_chunks[:, None]
    return torch.where(valid[..., None], torch.stack(cv, dim=-1), 0)


def merge_plain(cvs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Phase 2: the log-depth merkle merge over ``(B, C, 8)`` chunk CVs →
    ``(8, B)`` int64 digest words. Level-wise adjacent pairing with the odd
    tail promoted is BLAKE3's left-heavy tree; the pair taken when two nodes
    remain carries PARENT|ROOT (``blake3_jax.py:218-243``)."""
    _note_plain("blake3_merge", cvs)
    B, C, _ = cvs.shape
    cvs = u32(cvs)
    root = cvs[:, 0, :]               # one-chunk messages: already the digest
    if C > 1:
        remaining = _n_chunks(_clamped_lengths(lengths, C))
        Cp = 1 << (C - 1).bit_length()
        nodes = torch.cat([cvs, cvs.new_zeros(B, Cp - C, 8)], dim=1)
        half = Cp // 2
        pair_idx = torch.arange(half, dtype=torch.int64, device=cvs.device)[None, :]
        zero = torch.zeros((B, half), dtype=torch.int64, device=cvs.device)
        for _ in range(Cp.bit_length() - 1):
            left, right = nodes[:, 0::2], nodes[:, 1::2]            # (B, half, 8)
            has_right = (2 * pair_idx + 1) < remaining[:, None]
            is_root = (pair_idx == 0) & (remaining[:, None] == 2)
            parent = compress([zero + IV[w] for w in range(8)],
                              [left[..., w] for w in range(8)]
                              + [right[..., w] for w in range(8)],
                              zero, zero + BLOCK_LEN,
                              PARENT + is_root.long() * ROOT)
            parent = torch.stack(parent, dim=-1)
            merged = torch.where(has_right[..., None], parent, left)
            root = torch.where((remaining == 2)[:, None], parent[:, 0, :], root)
            nodes = torch.cat([merged, torch.zeros_like(merged)], dim=1)
            remaining = (remaining + 1) // 2
    return root.T.contiguous()


# --------------------------------------------------------------------------
# kernel wrappers: the CUDA kernel on a CUDA tensor, the plain version on CPU
# --------------------------------------------------------------------------


def _check_rows(rows: torch.Tensor, lengths: torch.Tensor) -> int:
    if rows.dim() != 2 or rows.shape[1] % WORDS_PER_CHUNK or rows.shape[1] == 0:
        raise ValueError(f"rows must be (B, C*256) words, got {tuple(rows.shape)}")
    if lengths.shape != (rows.shape[0],):
        raise ValueError("lengths must be (B,)")
    C = rows.shape[1] // WORDS_PER_CHUNK
    if rows.is_cuda:
        if rows.dtype not in (torch.int32, torch.uint32) or lengths.dtype != torch.int32:
            raise TypeError("kernel takes int32/uint32 rows and int32 lengths")
        if not (rows.is_contiguous() and lengths.is_contiguous()):
            raise ValueError("kernel takes contiguous rows and lengths")
        if lengths.device != rows.device:
            raise ValueError("rows and lengths must share a device")
        if rows.data_ptr() % 16:
            raise ValueError("kernel reads rows with 16-byte loads; align them")
        if C > MAX_CHUNKS:
            raise ValueError(f"at most {MAX_CHUNKS} chunks per message row")
    return C


def chunk_cvs(rows: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Phase 1 wrapper: ``(B, C, 8)`` chunk chaining values (int32 words from
    the kernel, int64 from the plain version)."""
    C = _check_rows(rows, lengths)
    if not rows.is_cuda:
        return chunk_cvs_plain(rows, lengths)
    B = rows.shape[0]
    out = torch.empty((B, C, 8), dtype=torch.int32, device=rows.device)
    _kernels.launch("blake3", "blake3_chunk_cvs", rows.data_ptr(),
                    lengths.data_ptr(), out.data_ptr(), B, C,
                    rows.device.index or 0, _kernels.stream_of(rows.device), shape=(B, C))
    return out


def merge(cvs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Phase 2 wrapper: ``(8, B)`` digest words."""
    if not cvs.is_cuda:
        return merge_plain(cvs, lengths)
    B, C, _ = cvs.shape
    if cvs.dtype != torch.int32 or not cvs.is_contiguous() or C > MAX_CHUNKS:
        raise ValueError("merge kernel takes contiguous int32 (B, C<=3584, 8) CVs")
    if (lengths.dtype != torch.int32 or not lengths.is_contiguous()
            or lengths.shape != (B,) or lengths.device != cvs.device):
        raise ValueError("merge kernel takes contiguous int32 (B,) lengths on the CVs' device")
    out = torch.empty((8, B), dtype=torch.int32, device=cvs.device)
    _kernels.launch("blake3", "blake3_merge", cvs.data_ptr(),
                    lengths.data_ptr(), out.data_ptr(), B, C,
                    cvs.device.index or 0, _kernels.stream_of(cvs.device), shape=(B, C))
    return out


def blake3_batch_rows(rows: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Hash B messages laid out one per row: ``rows`` (B, C*256) u32 words
    (int32/uint32 on the card, any integer type on the CPU), ``lengths``
    (B,) int32 true byte lengths, each <= C*1024. Returns (8, B) digest
    words — 32 bytes little-endian per message."""
    return merge(chunk_cvs(rows, lengths), lengths)


def blake3_batch(words: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """JAX-layout entry: ``words`` (16 blocks, 16 words, C chunks, B); the
    permutation to rows happens on the tensor's device."""
    _, _, C, B = words.shape
    rows = words.permute(3, 2, 0, 1).reshape(B, C * WORDS_PER_CHUNK).contiguous()
    return blake3_batch_rows(rows, lengths)


# --------------------------------------------------------------------------
# host packing
# --------------------------------------------------------------------------


def pack_rows(messages: list[bytes], max_chunks: int) -> tuple[np.ndarray, np.ndarray]:
    """Zero-pad B messages into (B, max_chunks*256) int32 rows (u32 words,
    little-endian) plus (B,) int32 lengths."""
    B = len(messages)
    cap = max_chunks * CHUNK_LEN
    buf = np.zeros((B, cap), np.uint8)
    lengths = np.empty(B, np.int32)
    for i, msg in enumerate(messages):
        n = len(msg)
        if n > cap:
            raise ValueError(f"message {i} ({n}B) exceeds capacity {cap}B")
        buf[i, :n] = np.frombuffer(msg, np.uint8)
        lengths[i] = n
    return buf.view("<i4"), lengths


def pack_messages(messages: list[bytes], max_chunks: int) -> tuple[np.ndarray, np.ndarray]:
    """The JAX layout: (16, 16, max_chunks, B) uint32 words plus (B,) int32
    lengths."""
    rows, lengths = pack_rows(messages, max_chunks)
    words = rows.view("<u4").reshape(len(messages), max_chunks, BLOCKS_PER_CHUNK, 16)
    return np.ascontiguousarray(words.transpose(2, 3, 1, 0)), lengths


def digests_to_hex(digest_words) -> list[str]:
    """(8, B) u32 words (tensor or array, any integer carrier) → per-message
    64-char hex digests (cas_id takes [:16])."""
    if isinstance(digest_words, torch.Tensor):
        digest_words = digest_words.cpu().numpy()
    words = np.asarray(digest_words).astype("<u4")
    b = np.ascontiguousarray(words.T).tobytes()
    return [b[i * 32 : (i + 1) * 32].hex() for i in range(words.shape[1])]


#: batch-size tiers: every call pads its lane count up to a tier, so the
#: kernels see the same handful of shapes as the JAX hasher sends the TPU
BATCH_TIERS = (8, 64, 512, 1024, 2048, 4096)


def _pad_to_tier(n: int) -> int:
    for t in BATCH_TIERS:
        if t >= n:
            return t
    return -(-n // BATCH_TIERS[-1]) * BATCH_TIERS[-1]


def blake3_batch_hex(messages: list[bytes], max_chunks: int | None = None,
                     device: str | torch.device | None = None) -> list[str]:
    """One-shot: pack → hash on ``device`` (default the card) → hex digests.
    Each call of at most ``BATCH_TIERS[-1]`` messages is padded to a tier
    with empty messages; longer lists go in slices of that size, which keeps
    the packed rows bounded (4096 × 64 KiB at the chunk-id bucket)."""
    from .. import resolve_device

    if not messages:
        return []
    dev = resolve_device(device)
    if max_chunks is None:
        need = max(1, max((len(m) + CHUNK_LEN - 1) // CHUNK_LEN for m in messages))
        max_chunks = 1 << (need - 1).bit_length()  # tier to a power of two
    out: list[str] = []
    step = BATCH_TIERS[-1]
    for s in range(0, len(messages), step):
        part = messages[s : s + step]
        padded = part + [b""] * (_pad_to_tier(len(part)) - len(part))
        rows, lengths = pack_rows(padded, max_chunks)
        digest = blake3_batch_rows(torch.from_numpy(rows).to(dev),
                                   torch.from_numpy(lengths).to(dev))
        out.extend(digests_to_hex(digest)[: len(part)])
    return out
