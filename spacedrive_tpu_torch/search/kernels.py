"""Predicate scorers for the columnar search index, on the card.

Counterpart of ``spacedrive_tpu/search/kernels.py``. The index keeps each
byte column row-major, ``(CAP, W)`` u8 with row ``r`` holding the
zero-padded value of index slot ``r`` (the JAX package keeps the transpose,
``(W, CAP)`` planes). Each scorer returns one result per row over the whole
capacity; callers slice ``[:n]``:

- :func:`substring` — SQLite ``LIKE '%needle%'`` over ASCII-folded names,
  ``(CAP,)`` bool;
- :func:`exact` — SQL ``=`` under BINARY collation: the zero-padded value
  equals the zero-padded needle, ``(CAP,)`` bool. On the card it also takes
  the column's keys, :func:`row_keys` of its rows, which the index keeps
  beside the path and extension rows: the kernel reads a row only where its
  key equals the needle's;
- :func:`lex_cmp` — the memcmp verdict (-1 | 0 | 1) of each zero-padded
  value against the zero-padded bound, ``(CAP,)`` int8. On the card it also
  takes the column's prefixes, :func:`date_prefix_of` of its rows, which the
  index keeps beside the date rows: the kernel reads a row past its first 8
  bytes only where its prefix equals the bound's.

On a CUDA tensor each launches its kernel in ``csrc/search.cu``
(``search_substring``, ``search_exact``, ``search_lex``) or raises; on a CPU
tensor it runs the plain PyTorch version beside it. The contract of the JAX
entry points (``substring_jnp`` :355, ``exact_jnp`` :376, ``lex_cmp_jnp``
:393) holds on both: an empty needle, or one longer than ``min(W,
MAX_NEEDLE)``, matches nothing for substring; a needle longer than W matches
nothing for exact; the bound is clipped to W for lex_cmp. Those cases launch
nothing.

Rows are zero-padded past their length and needles never contain NUL, so
padding gives no false substring match; values truncated at W are re-decided
on the host by the caller (``columnar._patch_overflow``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import _kernels

#: longest substring needle the index answers (longer ones stay on SQLite)
MAX_NEEDLE = 48

#: capacity granule: the device index holds a whole number of tiles of rows
TILE_ROWS = 32
LANES = 128
TILE = TILE_ROWS * LANES

#: widths each kernel is built for: the index's name (64), path (96),
#: extension (12) and date (40) columns (columnar.W_*)
KERNEL_WIDTHS = {"search_substring": (64,), "search_exact": (12, 96), "search_lex": (40,)}


def _splitmix64(seed: int, n: int) -> list[int]:
    out, mask = [], (1 << 64) - 1
    for _ in range(n):
        seed = (seed + 0x9E3779B97F4A7C15) & mask
        z = ((seed ^ (seed >> 30)) * 0xBF58476D1CE4E5B9) & mask
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
        out.append(z ^ (z >> 31))
    return out


#: the row key's multipliers: one odd 64-bit constant per 4-byte word of the
#: widest keyed column (paths, 96 bytes)
KEY_MULTIPLIERS = np.array([m | 1 for m in _splitmix64(0x5EA2C4, 24)], dtype=np.uint64)


def row_keys(rows: np.ndarray) -> np.ndarray:
    """(N, W) u8 zero-padded rows → (N,) int32 keys: the high 32 bits of
    the sum of each little-endian u32 word times its odd 64-bit multiplier,
    mod 2**64 (multiply-shift hashing: two different rows share a key with
    probability about 2**-31). A zero row's key is 0, so a column's padding
    and NULL rows need no fill of their own. Held as int32, as the card
    holds u32 words."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    n, width = rows.shape
    if width % 4 or width // 4 > len(KEY_MULTIPLIERS):
        raise ValueError(f"row_keys takes widths that are multiples of 4 up to 96, not {width}")
    words = rows.view("<u4").astype(np.uint64)
    h = words @ KEY_MULTIPLIERS[: width // 4]  # wraps mod 2**64
    return (h >> np.uint64(32)).astype(np.uint32).view(np.int32)


def date_prefix_of(rows: np.ndarray) -> np.ndarray:
    """(N, W) u8 zero-padded rows, W >= 8 → (N,) int64: each row's first 8
    bytes read big-endian, so that an unsigned compare of two prefixes is
    memcmp of those bytes. Held as int64 (torch has no uint64 arithmetic on
    the CPU); the card compares the bits as uint64, which a signed compare
    would get wrong for a row whose first byte is >= 0x80. A zero row's
    prefix is 0, so a column's padding and NULL rows need no fill of their
    own."""
    rows = np.asarray(rows, dtype=np.uint8)
    if rows.ndim != 2 or rows.shape[1] < 8:
        raise ValueError(f"date_prefix_of takes (N, W >= 8) rows, not {rows.shape}")
    head = np.ascontiguousarray(rows[:, :8]).view(">u8")[:, 0]
    return head.astype(np.uint64).view(np.int64)


def _padded_row(raw: bytes, width: int) -> np.ndarray:
    """``raw`` zero-padded to a (1, width) u8 row."""
    padded = np.zeros((1, width), dtype=np.uint8)
    padded[0, : len(raw)] = np.frombuffer(raw, dtype=np.uint8)
    return padded


def needle_key(needle: bytes, width: int) -> int:
    """The key of ``needle`` zero-padded to ``width`` bytes."""
    return int(row_keys(_padded_row(needle, width))[0])


def bound_prefix(bound: bytes, width: int) -> int:
    """The prefix of ``bound`` clipped and zero-padded to ``width`` bytes,
    as the unsigned 64-bit integer the kernel compares."""
    return int(date_prefix_of(_padded_row(bound[:width], width))[0].view(np.uint64))


def fold(raw: bytes) -> bytes:
    """ASCII-fold (A-Z → a-z) — exactly SQLite's default LIKE folding;
    non-ASCII bytes compare exact there and here."""
    return raw.lower() if raw.isascii() else \
        bytes(b + 32 if 0x41 <= b <= 0x5A else b for b in raw)


def pad_cap(n: int) -> int:
    """Device capacity for ``n`` rows: a whole number of tiles."""
    return max(TILE, -(-n // TILE) * TILE)


def _note_plain(kernel: str, rows: torch.Tensor) -> None:
    if rows.is_cuda:
        _kernels.PLAIN_ON_CUDA[kernel] += 1


def _padded(raw: bytes, width: int, device: torch.device) -> torch.Tensor:
    out = torch.zeros(width, dtype=torch.uint8)
    if raw:
        out[: len(raw)] = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    return out.to(device)


def _substring_ok(width: int, needle: bytes) -> bool:
    return 1 <= len(needle) <= min(width, MAX_NEEDLE)


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------


def substring_plain(rows: torch.Tensor, needle: bytes) -> torch.Tensor:
    """(CAP, W) u8 rows → (CAP,) bool: some offset j ≤ W−L where all L needle
    bytes match. One compare per needle byte over all offsets at once."""
    _note_plain("search_substring", rows)
    cap, width = rows.shape
    if not _substring_ok(width, needle):
        return torch.zeros(cap, dtype=torch.bool, device=rows.device)
    offsets = width - len(needle) + 1
    eq = rows[:, :offsets] == needle[0]
    for k in range(1, len(needle)):
        eq &= rows[:, k : k + offsets] == needle[k]
    return eq.any(dim=1)


def exact_plain(rows: torch.Tensor, needle: bytes) -> torch.Tensor:
    """(CAP, W) u8 rows → (CAP,) bool byte equality with the zero-padded
    needle (SQL ``=``)."""
    _note_plain("search_exact", rows)
    cap, width = rows.shape
    if len(needle) > width:
        return torch.zeros(cap, dtype=torch.bool, device=rows.device)
    return (rows == _padded(needle, width, rows.device)).all(dim=1)


def lex_cmp_plain(rows: torch.Tensor, bound: bytes) -> torch.Tensor:
    """(CAP, W) u8 rows → (CAP,) int8 memcmp verdict against the zero-padded
    bound clipped to W (SQLite's BINARY collation: a proper prefix is
    smaller, which zero padding preserves). The first differing byte
    decides."""
    _note_plain("search_lex", rows)
    width = rows.shape[1]
    padded = _padded(bound[:width], width, rows.device)
    gt = rows > padded
    lt = rows < padded
    first = (gt | lt).to(torch.uint8).argmax(dim=1, keepdim=True)  # 0 if none
    return (gt.gather(1, first).to(torch.int8)
            - lt.gather(1, first).to(torch.int8)).squeeze(1)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def _check_rows(kernel: str, rows: torch.Tensor) -> tuple[int, int]:
    """(CAP, W) of rows a kernel takes; raises on any other."""
    if rows.dim() != 2 or rows.dtype != torch.uint8:
        raise TypeError("the search kernels take (CAP, W) uint8 rows")
    cap, width = rows.shape
    if width not in KERNEL_WIDTHS[kernel]:
        raise ValueError(f"{kernel} takes widths {KERNEL_WIDTHS[kernel]}, not {width}")
    if not rows.is_contiguous() or rows.data_ptr() % 16:
        raise ValueError("the search kernels take contiguous, 16-byte aligned rows")
    if cap >= 1 << 31:
        raise ValueError("at most 2**31 - 1 rows per launch")
    return cap, width


def _check_column(kernel: str, col: torch.Tensor | None, dtype: torch.dtype,
                  rows: torch.Tensor, what: str) -> None:
    """Raises unless ``col`` is a (CAP,) ``dtype`` column beside ``rows``:
    contiguous, 16-byte aligned, on the rows' card."""
    if (col is None or col.dtype != dtype or tuple(col.shape) != (rows.shape[0],)
            or col.device != rows.device or not col.is_contiguous() or col.data_ptr() % 16):
        raise ValueError(f"{kernel} takes {what}: (CAP,) {dtype}, contiguous, 16-byte "
                         "aligned, on the rows' card")


def substring(rows: torch.Tensor, needle: bytes) -> torch.Tensor:
    """(CAP,) bool LIKE-substring mask: the ``search_substring`` kernel on a
    CUDA tensor, the plain version on CPU."""
    if not rows.is_cuda:
        return substring_plain(rows, needle)
    cap, width = _check_rows("search_substring", rows)
    if not _substring_ok(width, needle):
        return torch.zeros(cap, dtype=torch.bool, device=rows.device)
    out = torch.empty(cap, dtype=torch.uint8, device=rows.device)
    _kernels.launch("search", "search_substring", rows.data_ptr(), width, cap, needle,
                    len(needle), out.data_ptr(), rows.device.index or 0,
                    _kernels.stream_of(rows.device), shape=(cap, width, len(needle)))
    return out.view(torch.bool)


def exact(rows: torch.Tensor, needle: bytes, keys: torch.Tensor | None = None) -> torch.Tensor:
    """(CAP,) bool equality mask: the ``search_exact`` kernel on a CUDA
    tensor, which needs ``keys``, the (CAP,) int32 :func:`row_keys` of
    ``rows`` on the same card, and raises without them; the plain version
    on CPU, where ``keys`` is not read."""
    if not rows.is_cuda:
        return exact_plain(rows, needle)
    cap, width = _check_rows("search_exact", rows)
    _check_column("search_exact", keys, torch.int32, rows, "the rows' key column")
    if len(needle) > width:
        return torch.zeros(cap, dtype=torch.bool, device=rows.device)
    out = torch.empty(cap, dtype=torch.uint8, device=rows.device)
    _kernels.launch("search", "search_exact", rows.data_ptr(), keys.data_ptr(), width, cap,
                    needle, len(needle), needle_key(needle, width), out.data_ptr(),
                    rows.device.index or 0, _kernels.stream_of(rows.device),
                    shape=(cap, width, len(needle)))
    return out.view(torch.bool)


def lex_cmp(rows: torch.Tensor, bound: bytes,
            prefix: torch.Tensor | None = None) -> torch.Tensor:
    """(CAP,) int8 memcmp verdict, -1 / 0 / 1: the ``search_lex`` kernel on
    a CUDA tensor, which needs ``prefix``, the (CAP,) int64
    :func:`date_prefix_of` of ``rows`` on the same card, and raises without
    it; the plain version on CPU, where ``prefix`` is not read."""
    if not rows.is_cuda:
        return lex_cmp_plain(rows, bound)
    cap, width = _check_rows("search_lex", rows)
    _check_column("search_lex", prefix, torch.int64, rows, "the rows' prefix column")
    clipped = bound[:width]
    out = torch.empty(cap, dtype=torch.int8, device=rows.device)
    _kernels.launch("search", "search_lex", rows.data_ptr(), prefix.data_ptr(), width, cap,
                    clipped, len(clipped), bound_prefix(clipped, width), out.data_ptr(),
                    rows.device.index or 0, _kernels.stream_of(rows.device),
                    shape=(cap, width, len(clipped)))
    return out
