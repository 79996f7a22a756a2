"""Shared by the crypto tests of the port: seeded randomness and a cheap
Argon2id tier, set in both packages at once.

The file format records a hashing tier by its id, not its costs, so a file
or keystore written under :func:`cheap_argon2` opens only under it; the
tier tables themselves and one STANDARD hash are held to the JAX package's
in ``tests/test_torch_crypto.py``.
"""

from __future__ import annotations

import random
import secrets
import types

from spacedrive_tpu.crypto import hashing as jax_hashing
from spacedrive_tpu.crypto import primitives as jax_primitives
from spacedrive_tpu_torch.crypto import hashing, primitives

#: Argon2id (memory KiB, iterations, lanes) of every tier under cheap_argon2
CHEAP_ARGON2 = (64, 1, 1)


def seed_crypto(monkeypatch, seed: int) -> None:
    """Both packages draw their next random bytes from one seeded stream
    each, equal from here on: the JAX package through its primitives
    module's ``secrets``, the port through ``primitives.random_bytes``."""
    jax_rng, port_rng = random.Random(seed), random.Random(seed)
    monkeypatch.setattr(jax_primitives, "secrets", types.SimpleNamespace(
        token_bytes=jax_rng.randbytes, compare_digest=secrets.compare_digest))
    monkeypatch.setattr(primitives, "random_bytes", port_rng.randbytes)


def cheap_argon2(monkeypatch) -> None:
    """Every Argon2id tier of both packages at :data:`CHEAP_ARGON2`."""
    for module in (jax_hashing, hashing):
        monkeypatch.setattr(module, "_ARGON2", {p: CHEAP_ARGON2 for p in module.Params})
