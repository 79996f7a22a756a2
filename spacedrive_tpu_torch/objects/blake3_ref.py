"""Pure-Python BLAKE3 — the port's correctness oracle.

A copy of the spec constants and the incremental chunk-stack hasher from the
public BLAKE3 specification, with its keyed_hash and derive_key modes (the same construction as
``spacedrive_tpu/objects/blake3_ref.py``, kept here so the port imports
nothing of that package). Throughput is irrelevant: the hot path runs in
``csrc/blake3.cu``; this module defines the bytes it must produce.
"""

from __future__ import annotations

import struct

OUT_LEN = 32
BLOCK_LEN = 64
CHUNK_LEN = 1024

CHUNK_START = 1 << 0
CHUNK_END = 1 << 1
PARENT = 1 << 2
ROOT = 1 << 3
KEYED_HASH = 1 << 4
DERIVE_KEY_CONTEXT = 1 << 5
DERIVE_KEY_MATERIAL = 1 << 6

IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

MSG_PERMUTATION = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

_MASK = 0xFFFFFFFF


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _MASK


def _g(state: list[int], a: int, b: int, c: int, d: int, mx: int, my: int) -> None:
    state[a] = (state[a] + state[b] + mx) & _MASK
    state[d] = _rotr(state[d] ^ state[a], 16)
    state[c] = (state[c] + state[d]) & _MASK
    state[b] = _rotr(state[b] ^ state[c], 12)
    state[a] = (state[a] + state[b] + my) & _MASK
    state[d] = _rotr(state[d] ^ state[a], 8)
    state[c] = (state[c] + state[d]) & _MASK
    state[b] = _rotr(state[b] ^ state[c], 7)


def _round(state: list[int], m: list[int]) -> None:
    # columns
    _g(state, 0, 4, 8, 12, m[0], m[1])
    _g(state, 1, 5, 9, 13, m[2], m[3])
    _g(state, 2, 6, 10, 14, m[4], m[5])
    _g(state, 3, 7, 11, 15, m[6], m[7])
    # diagonals
    _g(state, 0, 5, 10, 15, m[8], m[9])
    _g(state, 1, 6, 11, 12, m[10], m[11])
    _g(state, 2, 7, 8, 13, m[12], m[13])
    _g(state, 3, 4, 9, 14, m[14], m[15])


def compress(cv, block_words: list[int], counter: int, block_len: int,
             flags: int) -> list[int]:
    """The 7-round compression function; returns all 16 output words."""
    state = [
        cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
        IV[0], IV[1], IV[2], IV[3],
        counter & _MASK, (counter >> 32) & _MASK, block_len, flags,
    ]
    m = list(block_words)
    for r in range(7):
        _round(state, m)
        if r < 6:
            m = [m[i] for i in MSG_PERMUTATION]
    for i in range(8):
        state[i] ^= state[i + 8]
        state[i + 8] ^= cv[i]
    return state


def _words_from_block(block: bytes) -> list[int]:
    if len(block) < BLOCK_LEN:
        block = block + b"\x00" * (BLOCK_LEN - len(block))
    return list(struct.unpack("<16I", block))


def _chunk_output(chunk: bytes, chunk_counter: int, key_words=IV, base_flags: int = 0):
    """Process a whole chunk except its final compression; returns
    (input_cv, final_block_words, counter, final_block_len, final_flags).
    ``key_words`` and ``base_flags`` select the mode (hash, keyed_hash or
    derive_key)."""
    cv: list[int] = list(key_words)
    blocks = [chunk[i : i + BLOCK_LEN] for i in range(0, len(chunk), BLOCK_LEN)] or [b""]
    for i, block in enumerate(blocks[:-1]):
        flags = base_flags | (CHUNK_START if i == 0 else 0)
        cv = compress(cv, _words_from_block(block), chunk_counter, BLOCK_LEN, flags)[:8]
    last = blocks[-1]
    flags = base_flags | CHUNK_END | (CHUNK_START if len(blocks) == 1 else 0)
    return cv, _words_from_block(last), chunk_counter, len(last), flags


def _parent_args(left_cv: list[int], right_cv: list[int], key_words=IV, base_flags: int = 0):
    return list(key_words), left_cv + right_cv, 0, BLOCK_LEN, PARENT | base_flags


def _root_bytes(args, out_len: int) -> bytes:
    """Extended output: re-run the root compression with incrementing counter."""
    cv, block_words, _, block_len, flags = args
    out = bytearray()
    counter = 0
    while len(out) < out_len:
        words = compress(cv, block_words, counter, block_len, flags | ROOT)
        out += struct.pack("<16I", *words)
        counter += 1
    return bytes(out[:out_len])


def blake3(data: bytes, out_len: int = OUT_LEN, key_words=IV, base_flags: int = 0) -> bytes:
    """One-shot BLAKE3 via the incremental chunk-stack construction; the
    plain hash unless ``key_words`` and ``base_flags`` select another mode."""
    mode = (key_words, base_flags)
    chunks = [data[i : i + CHUNK_LEN] for i in range(0, len(data), CHUNK_LEN)] or [b""]
    if len(chunks) == 1:
        return _root_bytes(_chunk_output(chunks[0], 0, *mode), out_len)

    # chunk stack: push each chunk CV, merging completed subtrees whose size
    # is a power of two (count-trailing-zeros rule from the spec)
    stack: list[list[int]] = []
    total = 0
    for i, chunk in enumerate(chunks[:-1]):
        new_cv = compress(*_chunk_output(chunk, i, *mode))[:8]
        total += 1
        t = total
        while t & 1 == 0:
            new_cv = compress(*_parent_args(stack.pop(), new_cv, *mode))[:8]
            t >>= 1
        stack.append(new_cv)

    # final chunk stays un-finalized; fold the stack right-to-left
    right_cv = compress(*_chunk_output(chunks[-1], len(chunks) - 1, *mode))[:8]
    while len(stack) > 1:
        right_cv = compress(*_parent_args(stack.pop(), right_cv, *mode))[:8]
    return _root_bytes(_parent_args(stack[0], right_cv, *mode), out_len)


def _key_words(key: bytes) -> tuple[int, ...]:
    if len(key) != 32:
        raise ValueError("BLAKE3 key must be exactly 32 bytes")
    return struct.unpack("<8I", key)


def blake3_keyed(key: bytes, data: bytes, out_len: int = OUT_LEN) -> bytes:
    """keyed_hash mode: the 32-byte key replaces the IV (spec section 2.6)."""
    return blake3(data, out_len, _key_words(key), KEYED_HASH)


def derive_key(context: str | bytes, key_material: bytes, out_len: int = OUT_LEN) -> bytes:
    """derive_key mode (spec section 2.6): the context string hashed in
    DERIVE_KEY_CONTEXT mode keys the material, hashed in
    DERIVE_KEY_MATERIAL mode. The key derivation of :mod:`..crypto`."""
    ctx = context.encode() if isinstance(context, str) else context
    context_key = blake3(ctx, 32, IV, DERIVE_KEY_CONTEXT)
    return blake3(key_material, out_len, _key_words(context_key), DERIVE_KEY_MATERIAL)


def blake3_hex(data: bytes, out_len: int = OUT_LEN) -> str:
    return blake3(data, out_len).hex()
