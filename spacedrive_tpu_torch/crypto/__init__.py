"""The crypto stack: AEAD streams, password hashing, encrypted headers,
the key manager and its secret stores.

Counterpart of ``spacedrive_tpu/crypto/``: XChaCha20-Poly1305 or
AES-256-GCM behind an LE31 STREAM of 1 MiB blocks, Argon2id or
BalloonBlake3 password hashing, a header with a magic and up to two
keyslots. It runs on the host, on ``cryptography``'s primitives and the
port's BLAKE3 oracle for key derivation, as the reference does. The file
format and the keystore are the reference's byte for byte.
"""

from .hashing import HashingAlgorithm, Params
from .header import MAGIC_BYTES, FileHeader, Keyslot
from .keymanager import KeyManager
from .primitives import (
    AEAD_TAG_LEN,
    BLOCK_LEN,
    ENCRYPTED_KEY_LEN,
    KEY_LEN,
    SALT_LEN,
    Protected,
    derive_key,
    generate_master_key,
    generate_nonce,
    generate_salt,
)
from .stream import Algorithm, Decryptor, Encryptor

__all__ = [
    "AEAD_TAG_LEN", "Algorithm", "BLOCK_LEN", "Decryptor", "ENCRYPTED_KEY_LEN",
    "Encryptor", "FileHeader", "HashingAlgorithm", "KEY_LEN", "KeyManager",
    "Keyslot", "MAGIC_BYTES", "Params", "Protected", "SALT_LEN", "derive_key",
    "generate_master_key", "generate_nonce", "generate_salt",
]
