"""XChaCha20-Poly1305 over ``cryptography``'s IETF ChaCha20Poly1305.

Counterpart of ``spacedrive_tpu/crypto/xchacha.py``. The extended-nonce
construction (draft-irtf-cfrg-xchacha): HChaCha20 over the key and the
first 16 nonce bytes gives a subkey, which runs ChaCha20Poly1305 with the
12-byte nonce 0x00000000 || the last 8 nonce bytes. HChaCha20 is plain
Python from the quarter-round of RFC 8439 section 2.1: it runs once a
stream, not once a block. Without ``cryptography`` the module imports and
the AEAD raises when it is made.
"""

from __future__ import annotations

import struct

try:
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
except ImportError:  # the AEAD raises at use
    class ChaCha20Poly1305:  # type: ignore[no-redef]
        def __init__(self, *_a: object, **_k: object) -> None:
            raise RuntimeError("AEAD crypto requires the 'cryptography' package")

_MASK = 0xFFFFFFFF
_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)  # "expand 32-byte k"

NONCE_LEN = 24


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & _MASK


def _quarter(state: list[int], a: int, b: int, c: int, d: int) -> None:
    state[a] = (state[a] + state[b]) & _MASK
    state[d] = _rotl(state[d] ^ state[a], 16)
    state[c] = (state[c] + state[d]) & _MASK
    state[b] = _rotl(state[b] ^ state[c], 12)
    state[a] = (state[a] + state[b]) & _MASK
    state[d] = _rotl(state[d] ^ state[a], 8)
    state[c] = (state[c] + state[d]) & _MASK
    state[b] = _rotl(state[b] ^ state[c], 7)


def hchacha20(key: bytes, nonce16: bytes) -> bytes:
    """20 ChaCha rounds without the final addition; the subkey is state
    words 0-3 and 12-15."""
    if len(key) != 32 or len(nonce16) != 16:
        raise ValueError("hchacha20 needs a 32-byte key and 16-byte nonce")
    state = list(_CONSTANTS) + list(struct.unpack("<8I", key)) \
        + list(struct.unpack("<4I", nonce16))
    for _ in range(10):
        _quarter(state, 0, 4, 8, 12)
        _quarter(state, 1, 5, 9, 13)
        _quarter(state, 2, 6, 10, 14)
        _quarter(state, 3, 7, 11, 15)
        _quarter(state, 0, 5, 10, 15)
        _quarter(state, 1, 6, 11, 12)
        _quarter(state, 2, 7, 8, 13)
        _quarter(state, 3, 4, 9, 14)
    return struct.pack("<8I", *(state[i] for i in (0, 1, 2, 3, 12, 13, 14, 15)))


class XChaCha20Poly1305:
    """The call surface of ``cryptography``'s AEAD classes, 24-byte nonces."""

    def __init__(self, key: bytes) -> None:
        if len(key) != 32:
            raise ValueError("key must be 32 bytes")
        self._key = key

    def _inner(self, nonce: bytes) -> tuple[ChaCha20Poly1305, bytes]:
        if len(nonce) != NONCE_LEN:
            raise ValueError("XChaCha20Poly1305 nonce must be 24 bytes")
        return ChaCha20Poly1305(hchacha20(self._key, nonce[:16])), b"\x00" * 4 + nonce[16:]

    def encrypt(self, nonce: bytes, data: bytes, aad: bytes | None = None) -> bytes:
        aead, n12 = self._inner(nonce)
        return aead.encrypt(n12, data, aad)

    def decrypt(self, nonce: bytes, data: bytes, aad: bytes | None = None) -> bytes:
        aead, n12 = self._inner(nonce)
        return aead.decrypt(n12, data, aad)
