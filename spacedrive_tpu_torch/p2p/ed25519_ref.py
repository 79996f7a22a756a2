"""Pure-Python Ed25519 (RFC 8032), for machines without ``cryptography``.

A copy of ``spacedrive_tpu/p2p/ed25519_ref.py``: the RFC 8032 reference
algorithm on the twisted Edwards curve in extended homogeneous
coordinates: seeds, public keys, signatures and their verification (a few
ms each, which identity creation and the p2p handshakes tolerate).
Byte-compatible with any RFC 8032 implementation: the same seed gives the
same public key and the same signatures as ``cryptography``'s, so a node on
this route pairs with one on the other.
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


def _decompress(b: bytes):
    n = int.from_bytes(b, "little")
    sign = n >> 255
    y = n & ((1 << 255) - 1)
    if y >= _P:
        raise ValueError("invalid point encoding")
    x_sq = (y * y - 1) * pow(_D * y * y + 1, _P - 2, _P) % _P
    x = _sqrt_mod(x_sq)
    if x == 0 and sign:
        raise ValueError("invalid point encoding")
    if x & 1 != sign:
        x = _P - x
    return (x, y, 1, x * y % _P)


def _h512(*parts: bytes) -> int:
    return int.from_bytes(hashlib.sha512(b"".join(parts)).digest(), "little")


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


def sign(seed: bytes, message: bytes) -> bytes:
    a, prefix = _expand(seed)
    pub = _compress(_mul(a, _G))
    r = _h512(prefix, message) % _L
    r_enc = _compress(_mul(r, _G))
    s = (r + _h512(r_enc, pub, message) * a) % _L
    return r_enc + int.to_bytes(s, 32, "little")


def verify(pub: bytes, signature: bytes, message: bytes) -> bool:
    if len(signature) != 64 or len(pub) != 32:
        return False
    try:
        point_a = _decompress(pub)
        point_r = _decompress(signature[:32])
    except ValueError:
        return False
    s = int.from_bytes(signature[32:], "little")
    if s >= _L:
        return False
    k = _h512(signature[:32], pub, message) % _L
    left = _mul(8, _mul(s, _G))
    right = _mul(8, _add(point_r, _mul(k, point_a)))
    lz, rz = left[2], right[2]
    # compare projective points cross-multiplied (no inversions)
    return (left[0] * rz - right[0] * lz) % _P == 0 \
        and (left[1] * rz - right[1] * lz) % _P == 0
