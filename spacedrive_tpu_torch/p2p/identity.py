"""ed25519 instance and node identities.

Counterpart of ``spacedrive_tpu/p2p/identity.py``: a keypair whose private
half this node holds (:class:`Identity`: a library's own instance, or the
node's key from its config's ``keypair_seed``), a peer's public key
(:class:`RemoteIdentity`, which verifies the peer's handshake signatures),
and the tagged encoding stored in the ``instance.identity`` column
(:func:`encode_identity` / :func:`decode_identity`: ``I:`` and the urlsafe
base64 of the 32-byte seed when this node holds the private key, ``R:`` and
the public key when it holds only a peer's; :func:`remote_identity_of` is
the public half of either).

Keys, signatures and verification come from ``cryptography``'s ed25519
when the package is present and from the pure-Python RFC 8032 copy
(:mod:`.ed25519_ref`) otherwise, with the same bytes either way;
:data:`ROUTE` says which.
"""

from __future__ import annotations

import base64
from dataclasses import dataclass

from . import ed25519_ref

try:
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (Ed25519PrivateKey,
                                                                   Ed25519PublicKey)

    HAVE_CRYPTOGRAPHY = True
except ImportError:
    HAVE_CRYPTOGRAPHY = False

ROUTE = "cryptography" if HAVE_CRYPTOGRAPHY else "ed25519_ref"


def _generate_seed() -> bytes:
    if ROUTE == "cryptography":
        return Ed25519PrivateKey.generate().private_bytes(
            serialization.Encoding.Raw, serialization.PrivateFormat.Raw,
            serialization.NoEncryption())
    return ed25519_ref.generate_seed()


def _public_key(seed: bytes) -> bytes:
    if ROUTE == "cryptography":
        return Ed25519PrivateKey.from_private_bytes(seed).public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw)
    return ed25519_ref.public_key(seed)


def _b64e(raw: bytes) -> str:
    return base64.urlsafe_b64encode(raw).decode().rstrip("=")


def _b64d(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


@dataclass(frozen=True)
class RemoteIdentity:
    """A public key: the stable address of an instance or a node."""

    public_bytes: bytes  # 32 raw bytes

    def __post_init__(self) -> None:
        if len(self.public_bytes) != 32:
            raise ValueError("ed25519 public key must be 32 bytes")

    def verify(self, signature: bytes, message: bytes) -> bool:
        if ROUTE == "ed25519_ref":
            return ed25519_ref.verify(self.public_bytes, signature, message)
        try:
            Ed25519PublicKey.from_public_bytes(self.public_bytes).verify(signature, message)
            return True
        except (InvalidSignature, ValueError):
            return False

    def encode(self) -> str:
        return _b64e(self.public_bytes)

    @classmethod
    def decode(cls, s: str) -> "RemoteIdentity":
        return cls(_b64d(s))

    def __str__(self) -> str:
        return self.encode()


class Identity:
    """An ed25519 keypair whose private half this node holds."""

    def __init__(self, seed: bytes | None = None) -> None:
        seed = _generate_seed() if seed is None else seed
        if len(seed) != 32:
            # a short seed must fail, not derive another keypair
            raise ValueError("ed25519 private key must be 32 bytes")
        self._seed = seed

    @classmethod
    def from_seed(cls, seed: bytes | str) -> "Identity":
        if isinstance(seed, str):
            seed = bytes.fromhex(seed) if len(seed) == 64 else _b64d(seed)
        return cls(seed[:32])

    def seed(self) -> bytes:
        return self._seed

    def sign(self, message: bytes) -> bytes:
        if ROUTE == "cryptography":
            return Ed25519PrivateKey.from_private_bytes(self._seed).sign(message)
        return ed25519_ref.sign(self._seed, message)

    def to_remote_identity(self) -> RemoteIdentity:
        return RemoteIdentity(_public_key(self._seed))

    def encode(self) -> str:
        return _b64e(self._seed)

    @classmethod
    def decode(cls, s: str) -> "Identity":
        return cls.from_seed(_b64d(s))


_I_TAG, _R_TAG = "I:", "R:"


def encode_identity(value: Identity | RemoteIdentity) -> str:
    """The ``instance.identity`` column's tagged encoding."""
    if isinstance(value, Identity):
        return _I_TAG + value.encode()
    return _R_TAG + value.encode()


def decode_identity(s: str) -> Identity | RemoteIdentity:
    if s.startswith(_I_TAG):
        return Identity.decode(s[len(_I_TAG):])
    if s.startswith(_R_TAG):
        return RemoteIdentity.decode(s[len(_R_TAG):])
    raise ValueError(f"not an identity encoding: {s[:8]!r}")


def remote_identity_of(s: str) -> RemoteIdentity:
    """The public identity, whichever half of the pair the column holds."""
    v = decode_identity(s)
    return v.to_remote_identity() if isinstance(v, Identity) else v
