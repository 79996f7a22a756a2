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

import time

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


def _rotr_(x: torch.Tensor, n: int) -> torch.Tensor:
    """Rotate each 32-bit word right by ``n``, in place."""
    low = x >> n
    return x.bitwise_left_shift_(32 - n).bitwise_or_(low).bitwise_and_(MASK)


def _g(v, a, b, c, d, mx, my) -> None:
    """The G function on the state words ``v`` (tensors the caller owns),
    in place: no tensor is allocated but one a rotation."""
    va, vb, vc, vd = v[a], v[b], v[c], v[d]
    va.add_(vb).add_(mx).bitwise_and_(MASK)
    _rotr_(vd.bitwise_xor_(va), 16)
    vc.add_(vd).bitwise_and_(MASK)
    _rotr_(vb.bitwise_xor_(vc), 12)
    va.add_(vb).add_(my).bitwise_and_(MASK)
    _rotr_(vd.bitwise_xor_(va), 8)
    vc.add_(vd).bitwise_and_(MASK)
    _rotr_(vb.bitwise_xor_(vc), 7)


def compress(cv, m, counter, block_len, flags, counter_hi=None) -> list[torch.Tensor]:
    """One BLAKE3 compression broadcast over the lane shape. ``cv``: 8 int64
    tensors; ``m``: 16 int64 tensors; ``counter``/``block_len``/``flags``
    (and ``counter_hi``, the counter's high word, 0 when None): int64
    tensors broadcastable to the lanes. Returns the 8 output words (chaining
    value / digest head)."""
    shape = torch.broadcast_shapes(cv[0].shape, m[0].shape, counter.shape,
                                   block_len.shape, flags.shape)
    zero = torch.zeros(shape, dtype=torch.int64, device=cv[0].device)
    v = [w + zero for w in cv]
    v += [zero + IV[i] for i in range(4)]
    v += [counter + zero, zero if counter_hi is None else counter_hi + zero,
          block_len + zero, flags + zero]
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
        _kernels.count(_kernels.PLAIN_ON_CUDA, kernel)


def _window(lengths: torch.Tensor, C: int, base, total) -> tuple[torch.Tensor, torch.Tensor]:
    """(first chunk index, message byte length) per row, int64: a whole
    message (``base`` None: chunk 0 on, the row's clamped length) or a
    window of ``C`` chunks at chunk ``base`` of a ``total``-byte message."""
    if base is None:
        return torch.zeros_like(lengths, dtype=torch.int64), _clamped_lengths(lengths, C)
    return base.to(torch.int64).clamp_min(0), total.to(torch.int64).clamp_min(0)


def chunk_cvs_plain(rows: torch.Tensor, lengths: torch.Tensor, base: torch.Tensor | None = None,
                    total: torch.Tensor | None = None) -> torch.Tensor:
    """Phase 1: every chunk's chaining value, ``(B, C, 8)`` int64. A
    one-chunk message's chunk 0 takes CHUNK_END|ROOT on its final block, so
    its CV is the digest (``_single_chunk_root``). Chunks past a message's
    chunk count are zero.

    With ``base`` and ``total`` ((B,) int64), row b holds chunks
    ``base[b]``, ``base[b] + 1``, ... of a message of ``total[b]`` bytes
    (``lengths`` is not read): chunk c is hashed with counter ``base + c``
    (both words), length ``clamp(total - (base + c) * 1024, 0, 1024)``, is
    zero once ``base + c`` reaches the message's chunk count, and takes ROOT
    only when the whole message is one chunk."""
    _note_plain("blake3_chunk_cvs", rows)
    B, W = rows.shape
    C = W // WORDS_PER_CHUNK
    words = rows.reshape(B * C, BLOCKS_PER_CHUNK, 16)
    first, total = _window(lengths, C, base, total)
    n_chunks = _n_chunks(total)                                     # (B,)
    chunk_idx = first[:, None] + torch.arange(C, dtype=torch.int64, device=rows.device)[None, :]
    chunk_len = (total[:, None] - chunk_idx * CHUNK_LEN).clamp(0, CHUNK_LEN)
    valid = chunk_idx < n_chunks[:, None]
    single = (n_chunks[:, None] == 1) & valid                      # (B, C)
    out = torch.zeros((B * C, 8), dtype=torch.int64, device=rows.device)
    # only the chunks that exist are hashed: a batch pads its rows to its
    # longest window
    sel = valid.reshape(-1).nonzero().squeeze(1)
    if sel.numel():
        out[sel] = _chunk_lanes(words[sel], chunk_len.reshape(-1)[sel],
                                chunk_idx.reshape(-1)[sel], single.reshape(-1)[sel])
    return out.reshape(B, C, 8)


def _chunk_lanes(words: torch.Tensor, chunk_len: torch.Tensor, chunk_idx: torch.Tensor,
                 single: torch.Tensor) -> torch.Tensor:
    """The CVs ``(L, 8)`` of ``L`` existing chunks: their words ``(L, 16,
    16)`` (any u32 carrier), byte lengths, chunk indices and whether each
    is a whole one-chunk message; blocks past the longest chunk are not
    compressed."""
    words = u32(words)
    n_blocks = ((chunk_len + (BLOCK_LEN - 1)) // BLOCK_LEN).clamp_min(1)
    counter, counter_hi = chunk_idx & MASK, chunk_idx >> 32
    cv = [torch.full(chunk_len.shape, IV[w], dtype=torch.int64, device=words.device)
          for w in range(8)]
    for j in range(int(n_blocks.max())):
        block_len = (chunk_len - j * BLOCK_LEN).clamp(0, BLOCK_LEN)
        final = n_blocks == j + 1
        flags = (final.long() * CHUNK_END
                 + (final & single).long() * ROOT + (CHUNK_START if j == 0 else 0))
        out = compress(cv, [words[:, j, w] for w in range(16)],
                       counter, block_len, flags, counter_hi)
        keep = j < n_blocks
        cv = [torch.where(keep, out[w], cv[w]) for w in range(8)]
    return torch.stack(cv, dim=-1)


def merge_plain(cvs: torch.Tensor, lengths: torch.Tensor,
                root: torch.Tensor | None = None) -> torch.Tensor:
    """Phase 2: the log-depth merkle merge over ``(B, C, 8)`` chunk CVs →
    ``(8, B)`` int64 digest words. Level-wise adjacent pairing with the odd
    tail promoted is BLAKE3's left-heavy tree; the pair taken when two nodes
    remain carries PARENT|ROOT (``blake3_jax.py:218-243``). Where ``root``
    ((B,) bool) is False that pair takes PARENT alone, and the row's output
    is its subtree's chaining value (a window of a longer message)."""
    _note_plain("blake3_merge", cvs)
    B, C, _ = cvs.shape
    cvs = u32(cvs)
    root_ok = (torch.ones(B, dtype=torch.bool, device=cvs.device) if root is None
               else root.to(device=cvs.device, dtype=torch.bool))
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
            is_root = (pair_idx == 0) & (remaining[:, None] == 2) & root_ok[:, None]
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


def _check_window(rows: torch.Tensor, base, total) -> None:
    if (base is None) != (total is None):
        raise ValueError("a window needs both base and total")
    if base is None:
        return
    B = rows.shape[0]
    for name, t in (("base", base), ("total", total)):
        if t.shape != (B,):
            raise ValueError(f"{name} must be (B,)")
        if rows.is_cuda and (t.dtype != torch.int64 or not t.is_contiguous()
                             or t.device != rows.device):
            raise ValueError(f"kernel takes a contiguous int64 (B,) {name} on the rows' device")


def chunk_cvs(rows: torch.Tensor, lengths: torch.Tensor, base: torch.Tensor | None = None,
              total: torch.Tensor | None = None) -> torch.Tensor:
    """Phase 1 wrapper: ``(B, C, 8)`` chunk chaining values (int32 words from
    the kernel, int64 from the plain version). ``base`` / ``total`` make
    each row a window of a longer message (:func:`chunk_cvs_plain`)."""
    C = _check_rows(rows, lengths)
    _check_window(rows, base, total)
    if not rows.is_cuda:
        return chunk_cvs_plain(rows, lengths, base, total)
    B = rows.shape[0]
    out = torch.empty((B, C, 8), dtype=torch.int32, device=rows.device)
    _kernels.launch("blake3", "blake3_chunk_cvs", rows.data_ptr(), lengths.data_ptr(),
                    None if base is None else base.data_ptr(),
                    None if total is None else total.data_ptr(), out.data_ptr(), B, C,
                    rows.device.index or 0, _kernels.stream_of(rows.device), shape=(B, C))
    return out


def merge(cvs: torch.Tensor, lengths: torch.Tensor,
          root: torch.Tensor | None = None) -> torch.Tensor:
    """Phase 2 wrapper: ``(8, B)`` digest words; where ``root`` ((B,) bool)
    is False, the row's subtree chaining value instead."""
    if not cvs.is_cuda:
        return merge_plain(cvs, lengths, root)
    B, C, _ = cvs.shape
    if cvs.dtype != torch.int32 or not cvs.is_contiguous() or C > MAX_CHUNKS:
        raise ValueError("merge kernel takes contiguous int32 (B, C<=3584, 8) CVs")
    if (lengths.dtype != torch.int32 or not lengths.is_contiguous()
            or lengths.shape != (B,) or lengths.device != cvs.device):
        raise ValueError("merge kernel takes contiguous int32 (B,) lengths on the CVs' device")
    if root is not None and (root.dtype != torch.bool or not root.is_contiguous()
                             or root.shape != (B,) or root.device != cvs.device):
        raise ValueError("merge kernel takes a contiguous bool (B,) root on the CVs' device")
    out = torch.empty((8, B), dtype=torch.int32, device=cvs.device)
    _kernels.launch("blake3", "blake3_merge", cvs.data_ptr(), lengths.data_ptr(),
                    None if root is None else root.data_ptr(), out.data_ptr(), B, C,
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


# --------------------------------------------------------------------------
# long messages: windows through both kernels, then the tree above them
# --------------------------------------------------------------------------

#: chunks of one window of the long-message route (2 MiB): a power of two
#: under MAX_CHUNKS, so every full window is one of BLAKE3's subtrees
WINDOW_CHUNKS = 2048
#: chaining values one merge row above the windows takes: a power of two, so
#: each level's groups are subtrees too
FAN_IN = 2048
#: bytes of one host staging buffer (two on the card, pinned, double
#: buffered): what bounds the route's host and device memory, whatever the
#: messages' sizes
STAGING_BYTES = 64 << 20
#: threads that read a batch's windows into its staging buffer
READ_THREADS = 8


class BytesMessage:
    """A message in memory, as a source of :func:`blake3_long_hex`. A
    source has a ``length`` and ``read_into(offset, out)``, which fills the
    writable buffer ``out`` with the message's bytes from ``offset`` or
    raises ``OSError``."""

    def __init__(self, data: bytes) -> None:
        self.data = memoryview(data).cast("B")
        self.length = len(self.data)

    def read_into(self, offset: int, out: memoryview) -> None:
        out[:] = self.data[offset : offset + len(out)]


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _window_batches(windows: list[tuple[int, int, int]],
                    staging_bytes: int) -> list[tuple[int, list[int]]]:
    """(C, window indices) of each launch pair: windows longest first, each
    batch in rows of C chunks (a power of two) that fill one staging buffer."""
    order = sorted(range(len(windows)), key=lambda j: -windows[j][2])
    batches, s = [], 0
    while s < len(order):
        C = _pow2_at_least(windows[order[s]][2])
        n = max(1, staging_bytes // (C * CHUNK_LEN))
        batches.append((C, order[s : s + n]))
        s += n
    return batches


class _Clock:
    """Seconds of the long route's copies and kernels: CUDA events around
    each launch pair on the card (read once the device is done), the host
    clock around each on the CPU."""

    def __init__(self, cuda: bool) -> None:
        self.cuda = cuda
        self.events: list = []
        self.cpu_s = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()
        if self.cuda:
            self.events.append([torch.cuda.Event(enable_timing=True) for _ in range(3)])
            self.events[-1][0].record()

    def copied(self):
        """Mark the end of this pair's host-to-device copies; returns the
        event a staging buffer waits on before it is refilled."""
        if self.cuda:
            self.events[-1][1].record()
            return self.events[-1][1]
        return None

    def done(self) -> None:
        if self.cuda:
            self.events[-1][2].record()
        else:
            self.cpu_s += time.perf_counter() - self._t0

    def seconds(self) -> tuple[float, float]:
        """(H2D, kernels), once the device has synchronized."""
        h2d = sum(a.elapsed_time(b) for a, b, _c in self.events) / 1e3
        return h2d, self.cpu_s + sum(b.elapsed_time(c) for _a, b, c in self.events) / 1e3


def _hash_windows(messages: list, windows: list, n_windows: list, first_slot: list,
                  level: torch.Tensor, W: int, staging: int, fns: tuple, clock: _Clock,
                  st: dict) -> dict:
    """Every window through one launch pair a batch, its CV (or a
    one-window message's digest) into ``level`` at the window's slot;
    returns the messages whose reads failed, with their errors."""
    from concurrent.futures import ThreadPoolExecutor

    chunk_fn, merge_fn = fns
    dev = level.device
    max_rows = staging // CHUNK_LEN
    bufs = [(torch.empty(staging, dtype=torch.uint8, pin_memory=clock.cuda),
             torch.empty(5 * max_rows, dtype=torch.int64, pin_memory=clock.cuda))
            for _ in range(2 if clock.cuda else 1)]
    copied: list = [None] * len(bufs)  # event: that buffer's copy has landed
    failed: dict[int, Exception] = {}

    def read_rows(buf, jobs, t: int) -> None:
        for r in range(t, len(jobs), READ_THREADS):
            i, off, n, row_off, zero_to = jobs[r]
            if i in failed:
                continue
            try:
                messages[i].read_into(off, memoryview(buf[row_off : row_off + n]))
            except OSError as e:
                failed[i] = e
            buf[row_off + n : row_off + zero_to] = 0  # the last block's tail

    with ThreadPoolExecutor(READ_THREADS) as pool:
        for k, (C, batch) in enumerate(_window_batches(windows, staging)):
            host, meta = bufs[k % len(bufs)]
            if copied[k % len(bufs)] is not None:
                copied[k % len(bufs)].synchronize()
            buf, B = host.numpy(), len(batch)
            meta = meta[: 5 * B].view(5, B)  # offset, total, bytes, root, slot a row
            jobs, m = [], meta.numpy()
            for r, j in enumerate(batch):
                i, w, chunks = windows[j]
                off = w * W * CHUNK_LEN
                n = max(0, min(messages[i].length - off, chunks * CHUNK_LEN))
                jobs.append((i, off, n, r * C * CHUNK_LEN,
                             min(C * CHUNK_LEN, max(CHUNK_LEN, -(-n // CHUNK_LEN) * CHUNK_LEN))))
                m[:, r] = (w * W, messages[i].length, n, n_windows[i] == 1, first_slot[i] + w)
                st["bytes"] += n
            t0 = time.perf_counter()
            list(pool.map(lambda t: read_rows(buf, jobs, t), range(READ_THREADS)))
            st["read_s"] += time.perf_counter() - t0
            clock.start()
            rows = host[: B * C * CHUNK_LEN].view(torch.int32).view(B, C * WORDS_PER_CHUNK)
            rows = rows.to(dev, non_blocking=True)
            meta_d = meta.to(dev, non_blocking=True)
            copied[k % len(bufs)] = clock.copied()
            lengths = meta_d[2].to(torch.int32)
            cvs = chunk_fn(rows, lengths, meta_d[0].contiguous(), meta_d[1].contiguous())
            out = merge_fn(cvs, lengths, meta_d[3].bool())
            level.index_copy_(0, meta_d[4], out.T.to(level.dtype))
            clock.done()
            st["batches"] += 1
    return failed


def _merge_levels(level: torch.Tensor, nodes: dict, final: torch.Tensor, fan_in: int,
                  merge_fn, clock: _Clock) -> int:
    """Merge each message's window CVs (``nodes``: message -> slots in
    ``level``) a level at a time, groups of at most ``fan_in`` a row, one
    launch a level, ROOT on the row that holds a message's last nodes; the
    digests land in ``final``. Returns the number of levels."""
    levels = 0
    while nodes:
        groups = [(i, ns[g : g + fan_in], len(ns) <= fan_in)
                  for i, ns in nodes.items() for g in range(0, len(ns), fan_in)]
        idx = np.full((len(groups), _pow2_at_least(max(len(g) for _i, g, _r in groups))),
                      level.shape[0] - 1, np.int64)  # padding: the zero row
        for r, (_i, g, _r) in enumerate(groups):
            idx[r, : len(g)] = g
        clock.start()
        lengths = torch.tensor([len(g) * CHUNK_LEN for _i, g, _r in groups], dtype=torch.int32)
        root = torch.tensor([r for _i, _g, r in groups], dtype=torch.bool)
        idx_d, lengths, root = (t.to(level.device) for t in (torch.from_numpy(idx), lengths, root))
        clock.copied()
        up = merge_fn(level[idx_d].contiguous(), lengths, root).T.to(level.dtype)
        level = torch.cat([up, up.new_zeros(1, 8)])
        done = [r for r, (_i, _g, is_root) in enumerate(groups) if is_root]
        if done:
            final[[groups[r][0] for r in done]] = level[done]
        clock.done()
        levels += 1
        nodes = {}
        for r, (i, _g, is_root) in enumerate(groups):
            if not is_root:
                nodes.setdefault(i, []).append(r)
    return levels


def blake3_long_hex(messages: list, device: str | torch.device | None = None, *,
                    window_chunks: int = WINDOW_CHUNKS, fan_in: int = FAN_IN,
                    staging_bytes: int = STAGING_BYTES, plain: bool = False,
                    stats: dict | None = None) -> list:
    """BLAKE3 hex digests of messages of any length, on ``device`` (default
    the card).

    ``messages`` holds sources (:class:`BytesMessage`, or anything with its
    ``length`` and ``read_into``); an Exception entry passes through in
    place, and so does the ``OSError`` a source raises while it is read.

    Each message is cut into windows of ``window_chunks`` chunks aligned at
    multiples of the window from chunk 0. The windows of all the messages go
    through the chunk and merge kernels in batches, one launch pair a batch
    (rows of a power-of-two chunk count, longest windows first, each batch
    one staging buffer): a message of one window gets its digest there; the
    others get one subtree chaining value a window (chunk counters from the
    window's offset, no ROOT). Those are merged a level at a time, at most
    ``fan_in`` a row, one merge launch a level, with ROOT only on the row
    that holds a message's last nodes. Windows and groups aligned at powers
    of two make this BLAKE3's left-heavy tree, the one ``merge_plain``'s
    level-wise pairing builds. On the card a batch's windows are read into
    one of two pinned buffers while the other's copy and kernels run.

    ``plain=True`` runs the plain versions on the tensors' device (to hold
    the kernels to them). ``stats``, if given, gains ``read_s``, ``h2d_s``
    and ``kernel_s`` (CUDA-event times on the card), ``bytes``,
    ``windows``, ``batches`` and ``levels``."""
    from .. import resolve_device

    dev = resolve_device(device)
    for name, v in (("window_chunks", window_chunks), ("fan_in", fan_in)):
        if v < 1 or v & (v - 1) or v > MAX_CHUNKS:
            raise ValueError(f"{name} must be a power of two <= {MAX_CHUNKS}, got {v}")
    W = window_chunks
    out: list = [m if isinstance(m, Exception) else None for m in messages]
    n_windows = [0] * len(messages)
    first_slot = [0] * len(messages)
    windows: list[tuple[int, int, int]] = []  # (message, window, chunks)
    for i, m in enumerate(messages):
        if out[i] is not None:
            continue
        n_total = max(1, -(-m.length // CHUNK_LEN))
        n_windows[i] = -(-n_total // W)
        first_slot[i] = len(windows)
        windows += [(i, k, min(W, n_total - k * W)) for k in range(n_windows[i])]
    if not windows:
        return out

    fns = (chunk_cvs_plain, merge_plain) if plain else (chunk_cvs, merge)
    dtype = torch.int32 if dev.type == "cuda" and not plain else torch.int64
    clock = _Clock(dev.type == "cuda")
    st = {"read_s": 0.0, "bytes": 0, "windows": len(windows), "batches": 0}
    # the row past the last slot stays zero: the padding of the levels above
    level = torch.zeros((len(windows) + 1, 8), dtype=dtype, device=dev)
    final = torch.zeros((len(messages), 8), dtype=dtype, device=dev)
    failed = _hash_windows(messages, windows, n_windows, first_slot, level, W,
                           max(staging_bytes, W * CHUNK_LEN), fns, clock, st)
    singles = [i for i, n in enumerate(n_windows) if n == 1 and i not in failed]
    if singles:
        final[singles] = level[[first_slot[i] for i in singles]]
    nodes = {i: list(range(first_slot[i], first_slot[i] + n)) for i, n in enumerate(n_windows)
             if n > 1 and i not in failed}
    st["levels"] = _merge_levels(level, nodes, final, fan_in, fns[1], clock)
    hexes = digests_to_hex(final.cpu().T)
    st["h2d_s"], st["kernel_s"] = clock.seconds()
    if stats is not None:
        for key, v in st.items():
            stats[key] = stats.get(key, 0) + v
    for i in range(len(messages)):
        if out[i] is None:
            out[i] = failed.get(i, hexes[i])
    return out
