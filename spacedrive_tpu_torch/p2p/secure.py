"""Encrypted, authenticated p2p streams.

A copy of ``spacedrive_tpu/p2p/secure.py``: the same handshake transcript,
key derivation and record layer, so a sealed record from either package
opens in the other. The upstream project rides libp2p QUIC, whose TLS handshake authenticates the
connection (crates/p2p/src/manager.rs:62-79), while its application-level
``Tunnel`` encryption is an acknowledged stub (spacetunnel/tunnel.rs:23,39).
Our TCP control plane therefore carries its own AKE + record layer:

**Handshake (SIGMA-style sign-and-encrypt):**

1. initiator → responder: ``MAGIC || e_i`` (fresh X25519 public key)
2. responder → initiator: ``e_r`` (fresh X25519 public key)
3. both derive ``k_i2r, k_r2i = HKDF(DH(e_i, e_r), info=transcript)`` and
   switch the socket to the encrypted record layer — *everything* after the
   two ephemerals (metadata, signatures, headers, sync ops, file blocks) is
   ChaCha20Poly1305-sealed.
4. responder → initiator (encrypted): ``ident_r + sign_r(T("resp", e_i,
   e_r, ident_r))`` — identity proof ONLY, no metadata yet
5. initiator → responder (encrypted): metadata + ``sign_i(T("init", e_i,
   e_r, ident_i, ident_r))``
6. responder → initiator (encrypted): metadata — sent only after the
   initiator's signature verifies (SIGMA-I ordering), so an anonymous
   prober can learn the responder's beaconed public identity but never
   harvests node names or per-library instance lists

Why this kills the round-2 signature oracle: each party only ever signs a
domain-separated transcript containing an ephemeral key **it generated
itself this connection** — there is no way to extract a signature over
attacker-chosen material that verifies in any other session. A relay
(machine-in-the-middle) fails because the victim's signature binds the
victim's own DH share, which the relay cannot reuse: the downstream leg has
a different ephemeral pair, so the relayed signature's transcript never
matches. The responder completes no application read until the initiator's
signature verifies (no pre-auth signing service beyond the self-bound
transcript), and the initiator pins the responder's identity when it dialed
a known peer, so discovery beacons cannot redirect a dial to an impostor.

**Record layer:** 4-byte big-endian ciphertext length || ChaCha20Poly1305
ciphertext. Nonce = 12-byte little-endian record counter; separate keys per
direction, so counters never collide. Plaintext is chunked to ≤64KiB per
record to bound buffering; spaceblock's large blocks simply span records.
"""

from __future__ import annotations

import asyncio

try:
    from cryptography.exceptions import InvalidTag
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey, X25519PublicKey)
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
    from cryptography.hazmat.primitives.kdf.hkdf import HKDF

    HAVE_CRYPTOGRAPHY = True
except ImportError:
    # Dependency-gated (image without ``cryptography``): importing the p2p
    # package must not explode — library creation only needs identity.py,
    # which has a pure-Python fallback. Session crypto has none (X25519 +
    # ChaCha20Poly1305 are not reimplemented here), so every entry point
    # below raises at use time and Node._start_p2p's try/except keeps
    # the node running offline.
    HAVE_CRYPTOGRAPHY = False

    class InvalidTag(Exception):  # type: ignore[no-redef]
        pass

    class _Unavailable:
        def __init__(self, *_a: object, **_k: object) -> None:
            raise RuntimeError(
                "p2p session crypto requires the 'cryptography' package")

        generate = classmethod(lambda cls: cls())
        from_public_bytes = classmethod(lambda cls, _raw: cls())

    X25519PrivateKey = X25519PublicKey = ChaCha20Poly1305 = HKDF = _Unavailable  # type: ignore[misc]
    hashes = None  # type: ignore[assignment]

from .proto import ProtocolError

RECORD_MAX = 64 * 1024          # plaintext bytes per record
_CIPHERTEXT_MAX = RECORD_MAX + 16  # + poly1305 tag

AKE_LABEL = b"SDP3-AKE1"  # versioned with manager.py's wire MAGIC (SDP3)


def gen_ephemeral() -> tuple[X25519PrivateKey, bytes]:
    """Fresh X25519 keypair; returns (private, raw 32-byte public)."""
    priv = X25519PrivateKey.generate()
    return priv, priv.public_key().public_bytes_raw()


def derive_session_keys(eph_priv: X25519PrivateKey, peer_pub: bytes,
                        e_i: bytes, e_r: bytes) -> tuple[bytes, bytes]:
    """(k_i2r, k_r2i) from the ephemeral DH, bound to the exact key shares."""
    if len(peer_pub) != 32:
        raise ProtocolError("bad ephemeral key length")
    shared = eph_priv.exchange(X25519PublicKey.from_public_bytes(peer_pub))
    okm = HKDF(algorithm=hashes.SHA256(), length=64, salt=None,
               info=AKE_LABEL + b"|keys|" + e_i + e_r).derive(shared)
    return okm[:32], okm[32:]


def transcript(role: str, e_i: bytes, e_r: bytes, *identities: str) -> bytes:
    """Domain-separated signing transcript. ``role`` breaks init/resp
    symmetry; the ephemerals bind the signature to this one connection;
    identities prevent unknown-key-share rebinding."""
    return (AKE_LABEL + b"|" + role.encode() + b"|" + e_i + e_r + b"|"
            + "|".join(identities).encode())


class SecureReader:
    """Decrypting façade over an ``asyncio.StreamReader``; implements the
    one method (`readexactly`) the wire helpers in proto.py use."""

    def __init__(self, reader: asyncio.StreamReader, key: bytes) -> None:
        self._reader = reader
        self._aead = ChaCha20Poly1305(key)
        self._counter = 0
        self._buf = bytearray()

    async def _read_record(self) -> None:
        try:
            head = await self._reader.readexactly(4)
        except asyncio.IncompleteReadError as e:
            raise ProtocolError(
                f"stream closed mid-record ({len(e.partial)}/4)") from e
        n = int.from_bytes(head, "big")
        if not 16 <= n <= _CIPHERTEXT_MAX:
            raise ProtocolError(f"bad record length {n}")
        try:
            ct = await self._reader.readexactly(n)
        except asyncio.IncompleteReadError as e:
            raise ProtocolError(
                f"stream closed mid-record ({len(e.partial)}/{n})") from e
        nonce = self._counter.to_bytes(12, "little")
        self._counter += 1
        try:
            self._buf += self._aead.decrypt(nonce, ct, None)
        except InvalidTag as e:
            raise ProtocolError("record authentication failed") from e

    async def readexactly(self, n: int) -> bytes:
        while len(self._buf) < n:
            await self._read_record()
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out


class SecureWriter:
    """Encrypting façade over an ``asyncio.StreamWriter``."""

    def __init__(self, writer: asyncio.StreamWriter, key: bytes) -> None:
        self._writer = writer
        self._aead = ChaCha20Poly1305(key)
        self._counter = 0

    def write(self, data: bytes) -> None:
        for off in range(0, len(data), RECORD_MAX):
            chunk = bytes(data[off:off + RECORD_MAX])
            nonce = self._counter.to_bytes(12, "little")
            self._counter += 1
            ct = self._aead.encrypt(nonce, chunk, None)
            self._writer.write(len(ct).to_bytes(4, "big") + ct)

    async def drain(self) -> None:
        await self._writer.drain()

    def close(self) -> None:
        self._writer.close()

    async def wait_closed(self) -> None:
        await self._writer.wait_closed()

    def get_extra_info(self, name: str, default=None):
        return self._writer.get_extra_info(name, default)
