"""Search-kernel inputs shared by tests/test_torch_search.py,
tests/test_torch_search_layout.py and tests/test_torch_lex_layout.py (on the
CPU, against the JAX package) and tests/test_torch_on_card.py (on the card,
no jax): seeded value rows, the substring kernel's edge cases, a pair of rows
with one key and the range kernel's date rows and bounds. It imports numpy
and the port only."""

import numpy as np

from spacedrive_tpu_torch.search import kernels

#: threads of a warp: the substring kernel verifies a warp's rows together
WARP = 32


def value_rows(values: list[bytes], width: int) -> np.ndarray:
    """(N, W) zero-padded rows, each value clipped at W."""
    rows = np.zeros((len(values), width), dtype=np.uint8)
    for i, raw in enumerate(values):
        clip = raw[:width]
        rows[i, : len(clip)] = np.frombuffer(clip, dtype=np.uint8)
    return rows


def seeded_values(width: int, seed: int, n: int = 300) -> list[bytes]:
    """Names over a small alphabet (many partial matches), with non-ASCII
    bytes, values of exactly W bytes, longer ones, and empty ones."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abc.-\xc3\xbc", dtype=np.uint8)
    out = []
    for i in range(n):
        length = [0, width, width + 7][i % 3] if i % 10 == 0 else int(rng.integers(1, width))
        out.append(rng.choice(alphabet, size=length).tobytes())
    return out


def edge_names(seed: int, n: int = 8 * WARP * 3 + 11) -> np.ndarray:
    """(n, 64) folded name rows over a small alphabet with bytes >= 0x80,
    empty rows and rows of exactly 64 bytes (n is not a multiple of 32)."""
    return value_rows([kernels.fold(v) for v in seeded_values(64, seed, n)], 64)


def substring_cases() -> list[tuple[str, np.ndarray, bytes]]:
    """(label, rows, needle): the edge cases chip_smoke.py holds on the
    card, at a small size."""
    rows = edge_names(11)
    cases = [(f"L{L}", rows, bytes(rows[3, :L]) if rows[3, L - 1] else b"abca"[:L] * 12)
             for L in (1, 2, 3, 4, 5)]
    cases.append(("L48", rows, (b"ab.c-" * 10)[:48]))
    # the first gram in every other row, the needle nowhere
    common = rows.copy()
    for i in range(0, len(common), 2):
        common[i, i % 61 : i % 61 + 4] = np.frombuffer(b"abca", dtype=np.uint8)
    cases.append(("common-gram", common, b"abca" + b"\xc3" * 9))
    # a match only at offset 0, and one only at offset W-L
    at = rows.copy()
    at[5] = np.frombuffer(b"q" * 64, dtype=np.uint8)
    at[5, :9] = np.frombuffer(b"zz-start-", dtype=np.uint8)
    at[6] = np.frombuffer(b"q" * 64, dtype=np.uint8)
    at[6, 64 - 9 :] = np.frombuffer(b"zz-start-", dtype=np.uint8)
    cases.append(("offset-0-and-W-L", at, b"zz-start-"))
    # every offset a candidate: rows of one byte, a needle that fails late
    same = rows.copy()
    same[::3] = ord("a")
    cases += [("every-offset-L6", same, b"aaaaab"), ("every-offset-L4", same, b"aaab"),
              ("every-offset-L48", same, b"a" * 47 + b"b"),
              ("every-offset-match", same, b"a" * 20)]
    # bytes >= 0x80, a NUL inside the needle, and a needle past the end
    cases += [("high-bytes", rows, "ü".encode() + b"a"), ("high-L2", rows, b"\xc3\xbc"),
              ("nul", rows, b"c\x00"), ("nul-gram", rows, b"a\x00\x00\x00\x00"),
              ("too-long", rows, b"a" * 49), ("empty", rows, b"")]
    return cases


def birthday_pair(width: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Two different rows with one key, from 2**18 random rows."""
    rows = np.random.default_rng(seed).integers(1, 256, size=(1 << 18, width), dtype=np.uint8)
    keys = kernels.row_keys(rows)
    order = np.argsort(keys, kind="stable")
    same = np.flatnonzero(keys[order][1:] == keys[order][:-1])
    assert len(same), "no key collision among 2**18 rows"
    a, b = rows[order[same[0]]], rows[order[same[0] + 1]]
    assert not np.array_equal(a, b)
    return a, b


#: the search benchmark's date bound: its first 8 bytes (``2026-06-``)
#: decide every row outside its month
LEX_BOUND = b"2026-06-01T00:00:00+00:00"
#: bounds of 0, 1, 7, 8, 9, 25, 40 and 41 bytes (the last clipped to 40),
#: and bounds whose first byte is >= 0x80
LEX_BOUNDS = (b"", LEX_BOUND[:1], LEX_BOUND[:7], LEX_BOUND[:8], LEX_BOUND[:9], LEX_BOUND,
              LEX_BOUND + b"Z" * 15, LEX_BOUND + b"Z" * 16, b"\xc3", b"\xc3\xa9t\xc3")


def lex_rows(seed: int, n: int = 8 * WARP * 3 + 11) -> np.ndarray:
    """(n, 40) date rows (n is not a multiple of 4): ISO dates of 2026, and
    planted among them rows equal to LEX_BOUND, rows that tie with its first
    8 bytes and differ at byte 8 or 9, rows that tie with its 40-byte form
    (LEX_BOUND + 15 x "Z") up to byte 39, rows whose first byte is >= 0x80,
    rows of 1-7 bytes of the bound, rows of 40 bytes over a small alphabet,
    and zero rows."""
    rng = np.random.default_rng(seed)
    long_bound = LEX_BOUND + b"Z" * 15
    values = []
    for i in range(n):
        kind = i % 13
        if kind == 0:
            value = b""
        elif kind == 1:
            value = LEX_BOUND
        elif kind in (2, 3):  # differs at byte 8 or 9, above or below
            raw = bytearray(LEX_BOUND)
            raw[6 + kind] = int(rng.choice(np.frombuffer(b"0123", dtype=np.uint8)))
            value = bytes(raw)
        elif kind == 4:  # ties with the 40-byte bound up to byte 39
            value = long_bound[:39] + bytes([int(rng.choice(np.frombuffer(b"YZ[", np.uint8)))])
        elif kind == 5:  # a first byte >= 0x80: negative as int64
            value = bytes([int(rng.integers(0x80, 0x100))]) + LEX_BOUND[1:]
        elif kind == 6:
            value = LEX_BOUND[: int(rng.integers(1, 8))]
        elif kind == 7:
            value = rng.choice(np.frombuffer(b"2026-\xc3\xff", np.uint8), size=40).tobytes()
        else:
            month, day, hour = rng.integers(1, 13), rng.integers(1, 29), rng.integers(0, 24)
            value = f"2026-{month:02d}-{day:02d}T{hour:02d}:00:00+00:00".encode()
        values.append(value)
    return value_rows(values, 40)
