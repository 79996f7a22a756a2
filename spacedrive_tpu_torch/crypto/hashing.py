"""Password hashing: Argon2id and BalloonBlake3.

Counterpart of ``spacedrive_tpu/crypto/hashing.py``, with its tiers:
Argon2id (memory KiB, iterations, lanes) through OpenSSL's Argon2id in
``cryptography`` (OpenSSL 3.2 or later), and BalloonBlake3 (space blocks,
time rounds; the reference's own scaled-down tiers) over the port's
BLAKE3 oracle. A secret key, when given, is Argon2's secret and the
balloon's key. The 2-byte wire encoding (kind, tier) is the headers'.
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass

from ..objects import blake3_ref
from .primitives import KEY_LEN, Protected


class Params(enum.Enum):
    STANDARD = "standard"
    HARDENED = "hardened"
    PARANOID = "paranoid"


_ARGON2 = {  # (memory_cost KiB, iterations, lanes)
    Params.STANDARD: (131_072, 8, 4),
    Params.HARDENED: (262_144, 8, 4),
    Params.PARANOID: (524_288, 8, 4),
}

_BALLOON = {  # (space_cost blocks, time_cost)
    Params.STANDARD: (2_048, 2),
    Params.HARDENED: (4_096, 2),
    Params.PARANOID: (8_192, 2),
}
_BALLOON_DELTA = 3

_KINDS = {"Argon2id": 0, "BalloonBlake3": 1}
_TIERS = {Params.STANDARD: 0, Params.HARDENED: 1, Params.PARANOID: 2}


@dataclass(frozen=True)
class HashingAlgorithm:
    kind: str  # "Argon2id" | "BalloonBlake3"
    params: Params = Params.STANDARD

    @staticmethod
    def argon2id(params: Params = Params.STANDARD) -> "HashingAlgorithm":
        return HashingAlgorithm("Argon2id", params)

    @staticmethod
    def balloon_blake3(params: Params = Params.STANDARD) -> "HashingAlgorithm":
        return HashingAlgorithm("BalloonBlake3", params)

    def hash(self, password: Protected, salt: bytes,
             secret: Protected | None = None) -> Protected:
        if self.kind == "Argon2id":
            return _argon2id(password, salt, secret, self.params)
        if self.kind == "BalloonBlake3":
            return _balloon_blake3(password, salt, secret, self.params)
        raise ValueError(f"unknown hashing algorithm {self.kind}")

    def encode(self) -> bytes:
        return bytes([_KINDS[self.kind], _TIERS[self.params]])

    @staticmethod
    def decode(raw: bytes) -> "HashingAlgorithm":
        kinds = {v: k for k, v in _KINDS.items()}
        tiers = {v: k for k, v in _TIERS.items()}
        return HashingAlgorithm(kinds[raw[0]], tiers[raw[1]])


def _argon2id(password: Protected, salt: bytes, secret: Protected | None,
              params: Params) -> Protected:
    from cryptography.hazmat.primitives.kdf.argon2 import Argon2id

    memory, iterations, lanes = _ARGON2[params]
    kdf = Argon2id(salt=salt, length=KEY_LEN, iterations=iterations, lanes=lanes,
                   memory_cost=memory,
                   secret=secret.expose() if secret is not None else None)
    return Protected(kdf.derive(password.expose()))


def _balloon_blake3(password: Protected, salt: bytes, secret: Protected | None,
                    params: Params) -> Protected:
    """Balloon hashing (Boneh, Corrigan-Gibbs, Schechter) with BLAKE3 as H:
    a sequential fill, ``time_cost`` mixing rounds of delta = 3 dependencies
    a block, the last block out."""
    space, time_cost = _BALLOON[params]
    key = password.expose() + (secret.expose() if secret is not None else b"")

    def H(counter: int, *parts: bytes) -> bytes:
        return blake3_ref.blake3(key + struct.pack("<Q", counter) + b"".join(parts), KEY_LEN)

    counter = 0
    buf = [b""] * space
    buf[0] = H(counter, password.expose(), salt)
    counter += 1
    for i in range(1, space):
        buf[i] = H(counter, buf[i - 1])
        counter += 1
    for t in range(time_cost):
        for i in range(space):
            buf[i] = H(counter, buf[(i - 1) % space], buf[i])
            counter += 1
            for d in range(_BALLOON_DELTA):
                idx_block = H(counter, salt, struct.pack("<QQQ", t, i, d))
                counter += 1
                other = int.from_bytes(idx_block[:8], "little") % space
                buf[i] = H(counter, buf[i], buf[other])
                counter += 1
    return Protected(buf[space - 1])
