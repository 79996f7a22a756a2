"""Crypto constants and small helpers.

Counterpart of ``spacedrive_tpu/crypto/primitives.py``. The constants and
the three derivation contexts are the on-disk format the two packages share:
they stay byte for byte as the reference has them, so a keystore or a
``.bytes`` file written by one package opens in the other. Every random byte
of the crypto stack is drawn through :func:`random_bytes` (the CSPRNG,
``secrets``), the one place a test seeds.
"""

from __future__ import annotations

import secrets

from ..objects import blake3_ref

#: streaming block size, 1 MiB
BLOCK_LEN = 1_048_576
#: Poly1305 / GCM tag length
AEAD_TAG_LEN = 16
#: master keys are 32 bytes
KEY_LEN = 32
#: a sealed master key: the key and its tag
ENCRYPTED_KEY_LEN = KEY_LEN + AEAD_TAG_LEN
SALT_LEN = 16
SECRET_KEY_LEN = 18

#: domain-separation contexts of the key derivation (the reference's strings)
ROOT_KEY_CONTEXT = "spacedrive_tpu 2026-07-29 root key derivation"
MASTER_PASSWORD_CONTEXT = "spacedrive_tpu 2026-07-29 master password verification"
FILE_KEY_CONTEXT = "spacedrive_tpu 2026-07-29 file key derivation"


def random_bytes(n: int) -> bytes:
    """``n`` bytes from the CSPRNG; every generator below draws here."""
    return secrets.token_bytes(n)


class Protected:
    """A secret in a bytearray, wiped on ``zeroize()`` and at collection;
    its ``repr`` never shows it. Python cannot promise erasure of the
    immutable copies a caller makes with ``expose()``."""

    __slots__ = ("_buf",)

    def __init__(self, value: bytes | bytearray | str) -> None:
        if isinstance(value, str):
            value = value.encode()
        self._buf = bytearray(value)

    def expose(self) -> bytes:
        return bytes(self._buf)

    def zeroize(self) -> None:
        for i in range(len(self._buf)):
            self._buf[i] = 0
        self._buf.clear()

    def __len__(self) -> int:
        return len(self._buf)

    def __repr__(self) -> str:
        return "Protected(<redacted>)"

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Protected):
            return secrets.compare_digest(bytes(self._buf), bytes(other._buf))
        return NotImplemented

    def __del__(self) -> None:
        try:
            self.zeroize()
        except Exception:
            pass


def generate_master_key() -> Protected:
    return Protected(random_bytes(KEY_LEN))


def generate_salt() -> bytes:
    return random_bytes(SALT_LEN)


def generate_secret_key() -> Protected:
    return Protected(random_bytes(SECRET_KEY_LEN))


def generate_nonce(length: int) -> bytes:
    return random_bytes(length)


def derive_key(key: bytes, salt: bytes, context: str) -> bytes:
    """The keyslot's KEK: BLAKE3 derive_key over key || salt under a
    domain-separation context."""
    return blake3_ref.derive_key(context, key + salt, KEY_LEN)
