"""AEAD streams: 1 MiB blocks under the LE31 STREAM construction.

Counterpart of ``spacedrive_tpu/crypto/stream.py``: an
:class:`Encryptor` / :class:`Decryptor` over XChaCha20-Poly1305 or
AES-256-GCM. LE31 extends the caller's nonce with a 4-byte little-endian
word, a 31-bit block counter and a last-block bit, so blocks cannot be
reordered, dropped from the end or spliced across streams. The caller's
nonce is the AEAD's less those 4 bytes: 20 for XChaCha, 8 for AES-GCM. The
AAD (a file's header) is bound to block 0 only. An empty stream is one
sealed empty last block.
"""

from __future__ import annotations

import enum
from typing import BinaryIO

try:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ImportError:  # the AEAD raises at use
    class AESGCM:  # type: ignore[no-redef]
        def __init__(self, *_a: object, **_k: object) -> None:
            raise RuntimeError("AEAD crypto requires the 'cryptography' package")

from .primitives import AEAD_TAG_LEN, BLOCK_LEN, Protected, generate_nonce
from .xchacha import XChaCha20Poly1305


class CryptoError(Exception):
    pass


class Algorithm(enum.Enum):
    XCHACHA20_POLY1305 = 0
    AES_256_GCM = 1

    @property
    def nonce_len(self) -> int:
        return 20 if self is Algorithm.XCHACHA20_POLY1305 else 8

    def generate_nonce(self) -> bytes:
        return generate_nonce(self.nonce_len)

    def _aead(self, key: bytes):
        if self is Algorithm.XCHACHA20_POLY1305:
            return XChaCha20Poly1305(key)
        return AESGCM(key)


_LAST_BLOCK = 1 << 31


class _Stream:
    def __init__(self, key: Protected, nonce: bytes, algorithm: Algorithm) -> None:
        if len(nonce) != algorithm.nonce_len:
            raise CryptoError(f"nonce length mismatch: got {len(nonce)}, "
                              f"want {algorithm.nonce_len} for {algorithm.name}")
        if len(key) != 32:
            raise CryptoError("key must be 32 bytes")
        self._aead = algorithm._aead(key.expose())
        self._nonce = nonce
        self._counter = 0
        self._finished = False

    def _next_nonce(self, last: bool) -> bytes:
        if self._finished:
            raise CryptoError("stream already finalized")
        if self._counter >= _LAST_BLOCK:
            raise CryptoError("LE31 counter exhausted")
        word = self._counter | (_LAST_BLOCK if last else 0)
        if last:
            self._finished = True
        else:
            self._counter += 1
        return self._nonce + word.to_bytes(4, "little")


def _blocks(reader: BinaryIO, size: int):
    """(block, is_last) in order; an empty reader gives one empty last block."""
    block = reader.read(size)
    while True:
        nxt = reader.read(size)
        yield block, not nxt
        if not nxt:
            return
        block = nxt


class Encryptor(_Stream):
    def encrypt_next(self, plaintext: bytes, aad: bytes = b"") -> bytes:
        return self._aead.encrypt(self._next_nonce(False), plaintext, aad or None)

    def encrypt_last(self, plaintext: bytes, aad: bytes = b"") -> bytes:
        return self._aead.encrypt(self._next_nonce(True), plaintext, aad or None)

    @classmethod
    def encrypt_streams(cls, key: Protected, nonce: bytes, algorithm: Algorithm,
                        reader: BinaryIO, writer: BinaryIO, aad: bytes = b"") -> int:
        """Read, seal and write BLOCK_LEN blocks, the AAD on block 0;
        returns the ciphertext bytes written."""
        enc = cls(key, nonce, algorithm)
        written = 0
        for i, (block, last) in enumerate(_blocks(reader, BLOCK_LEN)):
            seal = enc.encrypt_last if last else enc.encrypt_next
            out = seal(block, aad if i == 0 else b"")
            writer.write(out)
            written += len(out)
        return written

    @classmethod
    def encrypt_bytes(cls, key: Protected, nonce: bytes, algorithm: Algorithm,
                      data: bytes, aad: bytes = b"") -> bytes:
        """One sealed last block: master keys in keyslots, header metadata."""
        return cls(key, nonce, algorithm).encrypt_last(data, aad)


class Decryptor(_Stream):
    def _open(self, last: bool, ciphertext: bytes, aad: bytes) -> bytes:
        try:
            return self._aead.decrypt(self._next_nonce(last), ciphertext, aad or None)
        except Exception as e:
            raise CryptoError("decryption failed (wrong key or corrupt data)") from e

    def decrypt_next(self, ciphertext: bytes, aad: bytes = b"") -> bytes:
        return self._open(False, ciphertext, aad)

    def decrypt_last(self, ciphertext: bytes, aad: bytes = b"") -> bytes:
        return self._open(True, ciphertext, aad)

    @classmethod
    def decrypt_streams(cls, key: Protected, nonce: bytes, algorithm: Algorithm,
                        reader: BinaryIO, writer: BinaryIO, aad: bytes = b"") -> int:
        dec = cls(key, nonce, algorithm)
        written = 0
        for i, (block, last) in enumerate(_blocks(reader, BLOCK_LEN + AEAD_TAG_LEN)):
            out = dec._open(last, block, aad if i == 0 else b"")
            writer.write(out)
            written += len(out)
        return written

    @classmethod
    def decrypt_bytes(cls, key: Protected, nonce: bytes, algorithm: Algorithm,
                      data: bytes, aad: bytes = b"") -> Protected:
        return Protected(cls(key, nonce, algorithm).decrypt_last(data, aad))
