"""Predicate scorers for the columnar search index, on the card.

Counterpart of ``spacedrive_tpu/search/kernels.py``. The index keeps each
byte column row-major, ``(CAP, W)`` u8 with row ``r`` holding the
zero-padded value of index slot ``r`` (the JAX package keeps the transpose,
``(W, CAP)`` planes). Each scorer returns one result per row over the whole
capacity; callers slice ``[:n]``:

- :func:`substring` — SQLite ``LIKE '%needle%'`` over ASCII-folded names,
  ``(CAP,)`` bool;
- :func:`exact` — SQL ``=`` under BINARY collation: the zero-padded value
  equals the zero-padded needle, ``(CAP,)`` bool;
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


def _launch(kernel: str, rows: torch.Tensor, raw: bytes) -> torch.Tensor:
    """Launch one scorer over every row; returns its (CAP,) u8 flags."""
    if rows.dim() != 2 or rows.dtype != torch.uint8:
        raise TypeError("the search kernels take (CAP, W) uint8 rows")
    cap, width = rows.shape
    if width not in KERNEL_WIDTHS[kernel]:
        raise ValueError(f"{kernel} takes widths {KERNEL_WIDTHS[kernel]}, not {width}")
    if not rows.is_contiguous() or rows.data_ptr() % 16:
        raise ValueError("the search kernels take contiguous, 16-byte aligned rows")
    if cap >= 1 << 31:
        raise ValueError("at most 2**31 - 1 rows per launch")
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


def exact(rows: torch.Tensor, needle: bytes) -> torch.Tensor:
    """(CAP,) bool equality mask: the ``search_exact`` kernel on a CUDA
    tensor, the plain version on CPU."""
    if not rows.is_cuda:
        return exact_plain(rows, needle)
    if len(needle) > rows.shape[1]:
        return torch.zeros(rows.shape[0], dtype=torch.bool, device=rows.device)
    return _launch("search_exact", rows, needle).view(torch.bool)


def lex_cmp(rows: torch.Tensor, bound: bytes) -> torch.Tensor:
    """(CAP,) int8 memcmp verdict: the ``search_lex`` kernel (0 = eq, 1 = gt,
    2 = lt, as the Pallas kernel writes it) mapped to 0 / 1 / -1 on a CUDA
    tensor, the plain version on CPU."""
    if not rows.is_cuda:
        return lex_cmp_plain(rows, bound)
    code = _launch("search_lex", rows, bound[: rows.shape[1]])
    return (code == 1).to(torch.int8) - (code == 2).to(torch.int8)
