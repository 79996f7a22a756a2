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
  value against the zero-padded bound, ``(CAP,)`` int8.

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


def needle_key(needle: bytes, width: int) -> int:
    """The key of ``needle`` zero-padded to ``width`` bytes."""
    padded = np.zeros((1, width), dtype=np.uint8)
    padded[0, : len(needle)] = np.frombuffer(needle, dtype=np.uint8)
    return int(row_keys(padded)[0])


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


def _launch(kernel: str, rows: torch.Tensor, raw: bytes) -> torch.Tensor:
    """Launch the substring or lex scorer over every row; returns its (CAP,)
    u8 flags."""
    cap, width = _check_rows(kernel, rows)
    out = torch.empty(cap, dtype=torch.uint8, device=rows.device)
    _kernels.launch("search", kernel, rows.data_ptr(), width, cap, raw, len(raw),
                    out.data_ptr(), rows.device.index or 0, _kernels.stream_of(rows.device),
                    shape=(cap, width, len(raw)))
    return out


def substring(rows: torch.Tensor, needle: bytes) -> torch.Tensor:
    """(CAP,) bool LIKE-substring mask: the ``search_substring`` kernel on a
    CUDA tensor, the plain version on CPU."""
    if not rows.is_cuda:
        return substring_plain(rows, needle)
    if not _substring_ok(rows.shape[1], needle):
        return torch.zeros(rows.shape[0], dtype=torch.bool, device=rows.device)
    return _launch("search_substring", rows, needle).view(torch.bool)


def exact(rows: torch.Tensor, needle: bytes, keys: torch.Tensor | None = None) -> torch.Tensor:
    """(CAP,) bool equality mask: the ``search_exact`` kernel on a CUDA
    tensor, which needs ``keys``, the (CAP,) int32 :func:`row_keys` of
    ``rows`` on the same card, and raises without them; the plain version
    on CPU, where ``keys`` is not read."""
    if not rows.is_cuda:
        return exact_plain(rows, needle)
    cap, width = _check_rows("search_exact", rows)
    if (keys is None or keys.dtype != torch.int32 or tuple(keys.shape) != (cap,)
            or keys.device != rows.device or not keys.is_contiguous() or keys.data_ptr() % 16):
        raise ValueError("search_exact takes the rows' key column: (CAP,) int32, contiguous, "
                         "16-byte aligned, on the rows' card")
    if len(needle) > width:
        return torch.zeros(cap, dtype=torch.bool, device=rows.device)
    out = torch.empty(cap, dtype=torch.uint8, device=rows.device)
    _kernels.launch("search", "search_exact", rows.data_ptr(), keys.data_ptr(), width, cap,
                    needle, len(needle), needle_key(needle, width), out.data_ptr(),
                    rows.device.index or 0, _kernels.stream_of(rows.device),
                    shape=(cap, width, len(needle)))
    return out.view(torch.bool)


def lex_cmp(rows: torch.Tensor, bound: bytes) -> torch.Tensor:
    """(CAP,) int8 memcmp verdict: the ``search_lex`` kernel (0 = eq, 1 = gt,
    2 = lt, as the Pallas kernel writes it) mapped to 0 / 1 / -1 on a CUDA
    tensor, the plain version on CPU."""
    if not rows.is_cuda:
        return lex_cmp_plain(rows, bound)
    code = _launch("search_lex", rows, bound[: rows.shape[1]])
    return (code == 1).to(torch.int8) - (code == 2).to(torch.int8)
