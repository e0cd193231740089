"""Deterministic hash-to-curve (Shallue-van de Woestijne, RFC 9380 §6.6.1).

Counterpart of `sirius_tpu/curves/hash_to_curve.py`: the host map on Python
ints.  Commitment-key setup feeds it Shake256 XOF output; the judge hashes
a sample of a key's points again with it.
"""

from __future__ import annotations

from functools import lru_cache

from ..fields.constants import CurveSpec
from ..fields.gold import AffinePoint


def _is_square(a: int, p: int) -> bool:
    return a % p == 0 or pow(a, (p - 1) // 2, p) == 1


def _tonelli(a: int, p: int) -> int:
    if a == 0:
        return 0
    if not _is_square(a, p):
        raise ValueError("not a quadratic residue")
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    s, q, z = _ts_constants(p)
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, t2i = 0, t
        while t2i != 1:
            t2i = t2i * t2i % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c, t, r = i, b * b % p, t * b * b % p, r * b % p
    return r


@lru_cache(maxsize=None)
def _ts_constants(p: int) -> tuple[int, int, int]:
    """(S, Q, z): p - 1 = Q 2^S with Q odd, z the least non-residue."""
    S, Q = 0, p - 1
    while Q % 2 == 0:
        S += 1
        Q //= 2
    z = 2
    while _is_square(z, p):
        z += 1
    return S, Q, z


@lru_cache(maxsize=None)
def _svdw_constants(curve: CurveSpec) -> tuple[int, int, int, int, int]:
    """(Z, c1, c2, c3, c4) per RFC 9380 §6.6.1, Z the first of 1, -1, 2, -2, ..."""
    p = curve.base.modulus
    A, B = curve.a, curve.b

    def g(x):
        return (pow(x, 3, p) + A * x + B) % p

    for mag in range(1, 50):
        for Z in (mag, p - mag):
            gz = g(Z)
            denom = (3 * Z * Z + 4 * A) % p
            if gz == 0 or denom == 0:
                continue
            c3_sq = (-gz % p) * denom % p
            if not _is_square(c3_sq, p):
                continue
            if not (_is_square(gz, p) or _is_square(g((-Z * pow(2, -1, p)) % p), p)):
                continue
            c3 = _tonelli(c3_sq, p)
            if c3 % 2 == 1:  # sgn0(c3) must be 0
                c3 = p - c3
            c4 = (-4 * gz % p) * pow(denom, -1, p) % p
            return Z, gz, (-Z * pow(2, -1, p)) % p, c3, c4
    raise ValueError(f"no SVDW Z found for {curve.name}")


def svdw_map(curve: CurveSpec, u: int) -> AffinePoint:
    """RFC 9380 map_to_curve_svdw on host ints."""
    p = curve.base.modulus
    A, B = curve.a, curve.b
    Z, c1, c2, c3, c4 = _svdw_constants(curve)

    def inv0(x):
        return pow(x, -1, p) if x % p else 0

    u %= p
    tv1 = u * u % p * c1 % p
    tv2 = (1 + tv1) % p
    tv1 = (1 - tv1) % p
    tv3 = inv0(tv1 * tv2 % p)
    tv4 = u * tv1 % p * tv3 % p * c3 % p
    x1 = (c2 - tv4) % p
    gx1 = (pow(x1, 3, p) + A * x1 + B) % p
    x2 = (c2 + tv4) % p
    gx2 = (pow(x2, 3, p) + A * x2 + B) % p
    x3 = ((pow(tv2, 2, p) * tv3 % p) ** 2 % p * c4 + Z) % p
    if _is_square(gx1, p):
        x, gx = x1, gx1
    elif _is_square(gx2, p):
        x, gx = x2, gx2
    else:
        x = x3
        gx = (pow(x, 3, p) + A * x + B) % p
    y = _tonelli(gx, p)
    if (u % 2) != (y % 2):  # sgn0 match
        y = p - y
    return AffinePoint(curve, x, y)


def hash_bytes_to_point(curve: CurveSpec, uniform: bytes) -> AffinePoint:
    """64 uniform bytes -> two field elements -> SVDW each -> their sum."""
    if len(uniform) != 64:
        raise ValueError("expected 64 bytes")
    p = curve.base.modulus
    u0 = int.from_bytes(uniform[:32], "little") % p
    u1 = int.from_bytes(uniform[32:], "little") % p
    return svdw_map(curve, u0).add(svdw_map(curve, u1))
