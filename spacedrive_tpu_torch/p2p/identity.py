"""ed25519 instance identities (trimmed).

Counterpart of ``spacedrive_tpu/p2p/identity.py``, cut to what
:meth:`..library.Libraries.create` needs: a fresh keypair for a library's
own instance row (:class:`Identity`), the public half of the node's key
(:class:`RemoteIdentity`), and the tagged encoding stored in the
``instance.identity`` column (:func:`encode_identity`: ``I:`` and the
urlsafe base64 of the 32-byte seed when this node holds the private key,
``R:`` and the public key when it holds only a peer's).

Keys come from ``cryptography``'s ed25519 when the package is present and
from the pure-Python RFC 8032 copy (:mod:`.ed25519_ref`) otherwise, with
the same bytes either way; :data:`ROUTE` says which. Signing, decoding and
the handshakes come with p2p.
"""

from __future__ import annotations

import base64
from dataclasses import dataclass

try:
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey

    def _generate_seed() -> bytes:
        return Ed25519PrivateKey.generate().private_bytes(
            serialization.Encoding.Raw, serialization.PrivateFormat.Raw,
            serialization.NoEncryption())

    def _public_key(seed: bytes) -> bytes:
        return Ed25519PrivateKey.from_private_bytes(seed).public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw)

    ROUTE = "cryptography"
except ImportError:
    from .ed25519_ref import generate_seed as _generate_seed
    from .ed25519_ref import public_key as _public_key

    ROUTE = "ed25519_ref"


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

    def encode(self) -> str:
        return _b64e(self.public_bytes)


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

    def to_remote_identity(self) -> RemoteIdentity:
        return RemoteIdentity(_public_key(self._seed))

    def encode(self) -> str:
        return _b64e(self._seed)


def encode_identity(value: Identity | RemoteIdentity) -> str:
    """The ``instance.identity`` column's tagged encoding."""
    if isinstance(value, Identity):
        return "I:" + value.encode()
    return "R:" + value.encode()
