"""Encrypted-file header and keyslots.

Counterpart of ``spacedrive_tpu/crypto/header.py``, the same bytes. Layout
(little-endian, a fixed prefix so the AAD and the payload's offset need no
parsing of variable data):

    magic        7  b"sdtpenc"
    version      2  u16 = 1
    algorithm    1  Algorithm
    nonce       20  the stream nonce, zero-padded to 20 bytes
    [the AAD ends here: it authenticates payload block 0 and the attachments]
    keyslots  2x112 two fixed-size keyslots, an empty one all zero
    metadata     u8 present, then u32 length and nonce(20) || sealed JSON
    preview      the same shape

A keyslot seals the file's master key under a KEK: the password hashed
with the content salt, then BLAKE3 derive_key(hash || salt,
FILE_KEY_CONTEXT). A header holds at most two keyslots.
"""


from __future__ import annotations

import io
import json
import struct
from dataclasses import dataclass, field
from typing import Any, BinaryIO

from .hashing import HashingAlgorithm
from .primitives import (
    ENCRYPTED_KEY_LEN,
    FILE_KEY_CONTEXT,
    SALT_LEN,
    Protected,
    derive_key,
    generate_salt,
)
from .stream import Algorithm, CryptoError, Decryptor, Encryptor

MAGIC_BYTES = b"sdtpenc"
HEADER_VERSION = 1
KEYSLOT_SIZE = 112
MAX_KEYSLOTS = 2
_NONCE_PAD = 20


def _pad_nonce(nonce: bytes) -> bytes:
    return nonce + b"\x00" * (_NONCE_PAD - len(nonce))


@dataclass
class Keyslot:
    version: int
    algorithm: Algorithm
    hashing_algorithm: HashingAlgorithm
    salt: bytes           # KEK-derivation salt
    content_salt: bytes   # password-hashing salt
    master_key: bytes     # ENCRYPTED_KEY_LEN bytes (sealed)
    nonce: bytes

    @classmethod
    def new(cls, algorithm: Algorithm, hashing_algorithm: HashingAlgorithm,
            password: Protected, master_key: Protected,
            content_salt: bytes | None = None,
            secret: Protected | None = None) -> "Keyslot":
        """Hash the password, derive the KEK, seal the master key."""
        content_salt = content_salt or generate_salt()
        salt = generate_salt()
        nonce = algorithm.generate_nonce()
        hashed = hashing_algorithm.hash(password, content_salt, secret)
        kek = Protected(derive_key(hashed.expose(), salt, FILE_KEY_CONTEXT))
        hashed.zeroize()
        sealed = Encryptor.encrypt_bytes(kek, nonce, algorithm, master_key.expose())
        kek.zeroize()
        return cls(1, algorithm, hashing_algorithm, salt, content_salt,
                   sealed, nonce)

    def unseal(self, password: Protected,
               secret: Protected | None = None) -> Protected:
        hashed = self.hashing_algorithm.hash(password, self.content_salt, secret)
        kek = Protected(derive_key(hashed.expose(), self.salt, FILE_KEY_CONTEXT))
        hashed.zeroize()
        out = Decryptor.decrypt_bytes(kek, self.nonce, self.algorithm,
                                      self.master_key)
        kek.zeroize()
        return out

    def encode(self) -> bytes:
        raw = struct.pack("<HB", self.version, self.algorithm.value) \
            + self.hashing_algorithm.encode() \
            + self.salt + self.content_salt \
            + _pad_nonce(self.nonce) + self.master_key
        assert len(raw) <= KEYSLOT_SIZE, len(raw)
        return raw + b"\x00" * (KEYSLOT_SIZE - len(raw))

    @classmethod
    def decode(cls, raw: bytes) -> "Keyslot | None":
        if not any(raw):
            return None
        version, algo = struct.unpack_from("<HB", raw, 0)
        hashing = HashingAlgorithm.decode(raw[3:5])
        off = 5
        salt = raw[off:off + SALT_LEN]; off += SALT_LEN
        content_salt = raw[off:off + SALT_LEN]; off += SALT_LEN
        algorithm = Algorithm(algo)
        nonce = raw[off:off + algorithm.nonce_len]; off += _NONCE_PAD
        master_key = raw[off:off + ENCRYPTED_KEY_LEN]
        return cls(version, algorithm, hashing, salt, content_salt,
                   master_key, nonce)


@dataclass
class FileHeader:
    version: int
    algorithm: Algorithm
    nonce: bytes
    keyslots: list[Keyslot] = field(default_factory=list)
    metadata: bytes | None = None        # sealed blob: nonce ‖ ciphertext
    preview_media: bytes | None = None   # sealed blob: nonce ‖ ciphertext

    @classmethod
    def new(cls, algorithm: Algorithm = Algorithm.XCHACHA20_POLY1305) -> "FileHeader":
        return cls(HEADER_VERSION, algorithm, algorithm.generate_nonce())

    # -- keyslots ------------------------------------------------------------
    def add_keyslot(self, password: Protected, master_key: Protected,
                    hashing_algorithm: HashingAlgorithm | None = None,
                    content_salt: bytes | None = None,
                    secret: Protected | None = None) -> None:
        if len(self.keyslots) >= MAX_KEYSLOTS:
            raise CryptoError("header already has the maximum of 2 keyslots")
        self.keyslots.append(Keyslot.new(
            self.algorithm, hashing_algorithm or HashingAlgorithm.argon2id(),
            password, master_key, content_salt, secret))

    def decrypt_master_key(self, password: Protected,
                           secret: Protected | None = None) -> Protected:
        """Try each keyslot; a wrong password is one error for all of them."""
        for slot in self.keyslots:
            try:
                return slot.unseal(password, secret)
            except CryptoError:
                continue
        raise CryptoError("incorrect password (no keyslot matched)")

    # -- optional sealed attachments ------------------------------------
    def add_metadata(self, master_key: Protected, obj: Any) -> None:
        nonce = self.algorithm.generate_nonce()
        blob = Encryptor.encrypt_bytes(
            master_key, nonce, self.algorithm,
            json.dumps(obj, separators=(",", ":")).encode(), self.aad())
        self.metadata = _pad_nonce(nonce) + blob

    def decrypt_metadata(self, master_key: Protected) -> Any:
        if self.metadata is None:
            raise CryptoError("header has no metadata")
        nonce = self.metadata[:self.algorithm.nonce_len]
        out = Decryptor.decrypt_bytes(master_key, nonce, self.algorithm,
                                      self.metadata[_NONCE_PAD:], self.aad())
        return json.loads(out.expose().decode())

    def add_preview_media(self, master_key: Protected, media: bytes) -> None:
        nonce = self.algorithm.generate_nonce()
        blob = Encryptor.encrypt_bytes(master_key, nonce, self.algorithm,
                                       media, self.aad())
        self.preview_media = _pad_nonce(nonce) + blob

    def decrypt_preview_media(self, master_key: Protected) -> bytes:
        if self.preview_media is None:
            raise CryptoError("header has no preview media")
        nonce = self.preview_media[:self.algorithm.nonce_len]
        return Decryptor.decrypt_bytes(master_key, nonce, self.algorithm,
                                       self.preview_media[_NONCE_PAD:],
                                       self.aad()).expose()

    # -- serialization -------------------------------------------------------
    def aad(self) -> bytes:
        """The authenticated fixed prefix, bound to payload block 0 and to
        the metadata and preview blobs."""
        return (MAGIC_BYTES + struct.pack("<HB", self.version, self.algorithm.value)
                + _pad_nonce(self.nonce))

    def serialize(self) -> bytes:
        out = bytearray(self.aad())
        slots = list(self.keyslots)[:MAX_KEYSLOTS]
        for slot in slots:
            out += slot.encode()
        for _ in range(MAX_KEYSLOTS - len(slots)):
            out += b"\x00" * KEYSLOT_SIZE
        for blob in (self.metadata, self.preview_media):
            if blob is None:
                out += b"\x00"
            else:
                out += b"\x01" + struct.pack("<I", len(blob)) + blob
        return bytes(out)

    def write(self, writer: BinaryIO) -> int:
        raw = self.serialize()
        writer.write(raw)
        return len(raw)

    @classmethod
    def from_reader(cls, reader: BinaryIO) -> "FileHeader":
        magic = reader.read(len(MAGIC_BYTES))
        if magic != MAGIC_BYTES:
            raise CryptoError("not an encrypted file (bad magic)")
        # a truncated or corrupt header is a CryptoError, the one error
        # the decrypt job's steps catch
        try:
            version, algo = struct.unpack("<HB", reader.read(3))
            if version != HEADER_VERSION:
                raise CryptoError(f"unsupported header version {version}")
            algorithm = Algorithm(algo)
            nonce = reader.read(_NONCE_PAD)[:algorithm.nonce_len]
            keyslots = []
            for _ in range(MAX_KEYSLOTS):
                slot = Keyslot.decode(reader.read(KEYSLOT_SIZE))
                if slot is not None:
                    keyslots.append(slot)
            blobs: list[bytes | None] = []
            for _ in range(2):
                present = reader.read(1)
                if present == b"\x01":
                    (length,) = struct.unpack("<I", reader.read(4))
                    if length > 64 * 1024 * 1024:
                        raise CryptoError("header attachment too large")
                    blobs.append(reader.read(length))
                else:
                    blobs.append(None)
        except (struct.error, KeyError, ValueError, IndexError) as e:
            raise CryptoError(f"corrupt encrypted-file header: {e}") from e
        return cls(version, algorithm, nonce, keyslots, blobs[0], blobs[1])

    @classmethod
    def from_bytes(cls, raw: bytes) -> tuple["FileHeader", int]:
        buf = io.BytesIO(raw)
        header = cls.from_reader(buf)
        return header, buf.tell()
