"""Pure-Python Ed25519 key derivation (RFC 8032), for machines without
``cryptography``.

A trimmed copy of ``spacedrive_tpu/p2p/ed25519_ref.py``: the RFC 8032
reference algorithm on the twisted Edwards curve in extended homogeneous
coordinates, cut to what a library's instance identity needs (a random
seed and its public key). Byte-compatible with any RFC 8032
implementation: the same seed gives the same public key as
``cryptography``'s. Signing and verification come with the p2p handshakes.
"""

from __future__ import annotations

import hashlib
import os

_P = 2**255 - 19
_L = 2**252 + 27742317777372353535851937790883648493
_D = (-121665 * pow(121666, _P - 2, _P)) % _P

_GY = (4 * pow(5, _P - 2, _P)) % _P
_GX_SQ = (_GY * _GY - 1) * pow(_D * _GY * _GY + 1, _P - 2, _P) % _P


def _sqrt_mod(a: int) -> int:
    x = pow(a, (_P + 3) // 8, _P)
    if (x * x - a) % _P != 0:
        x = x * pow(2, (_P - 1) // 4, _P) % _P
    if (x * x - a) % _P != 0:
        raise ValueError("not a quadratic residue")
    return x


_GX = _sqrt_mod(_GX_SQ)
if _GX % 2 != 0:
    _GX = _P - _GX
_G = (_GX, _GY, 1, _GX * _GY % _P)  # extended coords (X, Y, Z, T)
_IDENT = (0, 1, 1, 0)


def _add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % _P
    b = (y1 + x1) * (y2 + x2) % _P
    c = 2 * t1 * t2 * _D % _P
    d = 2 * z1 * z2 % _P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % _P, g * h % _P, f * g % _P, e * h % _P)


def _mul(s: int, p):
    q = _IDENT
    while s > 0:
        if s & 1:
            q = _add(q, p)
        p = _add(p, p)
        s >>= 1
    return q


def _compress(p) -> bytes:
    x, y, z, _ = p
    zinv = pow(z, _P - 2, _P)
    x, y = x * zinv % _P, y * zinv % _P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def _expand(seed: bytes) -> tuple[int, bytes]:
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def generate_seed() -> bytes:
    return os.urandom(32)


def public_key(seed: bytes) -> bytes:
    a, _prefix = _expand(seed)
    return _compress(_mul(a, _G))
