"""Deterministic hash-to-curve (Shallue-van de Woestijne, RFC 9380 §6.6.1).

Counterpart of `sirius_tpu/curves/hash_to_curve.py`: the host map on Python
ints, and the batched map in plain torch (`hash_bytes_to_points_device`),
bit-identical to the host map.  Commitment-key setup feeds it Shake256 XOF
output.

Batched square roots: p = 3 (mod 4) uses a^((p+1)/4); p = 1 (mod 4)
(grumpkin's base field, bn256 Fr, 2-adicity 28) uses a constant-iteration
Tonelli-Shanks (one exponentiation a^((Q-1)/2) serves both of its
starting values).  `ops/commitment.py` maps a key in chunks.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..fields.constants import CurveSpec
from ..fields.gold import AffinePoint
from ..util.device import resolve
from ..util.profiling import span
from .jpoint import Curve, Points


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


# ---------------------------------------------------------------------------
# Batched map (plain torch, any device)
# ---------------------------------------------------------------------------


def _sqrt_device(f, a):
    """Batched sqrt attempt: y with y^2 == a iff a is a residue (callers test
    y^2 == a).  Equals the host root up to sign; SVDW's sgn0 fix makes the
    final y identical either way."""
    p = f.p
    if p % 4 == 3:
        return f.pow_int(a, (p + 1) // 4)
    S, Q, z = _ts_constants(p)
    shape, dev = a.shape[:-1], a.device
    one = f.ones(shape, dev)
    c = f.const(pow(z, Q, p), shape, dev)
    x = f.pow_int(a, (Q - 1) // 2)
    R = f.mul(a, x)  # a^((Q + 1) / 2)
    t = f.mul(R, x)  # a^Q
    for i in range(S - 1, 0, -1):
        b = t
        for _ in range(i - 1):  # b = t^(2^(i-1)) is +-1 for a residue
            b = f.square(b)
        flag = ~f.eq(b, one)
        R = f.select(flag, f.mul(R, c), R)
        c = f.square(c)
        t = f.select(flag, f.mul(t, c), t)
    return R


def svdw_map_device(curve: Curve, u_std: torch.Tensor) -> Points:
    """Batched map_to_curve_svdw: (n, 8) standard-form words of any 256-bit
    value (reduced mod p by the Montgomery lift) -> affine Points, z = 1."""
    spec, f = curve.spec, curve.fb
    p = f.p
    Z, c1, c2, c3, c4 = _svdw_constants(spec)
    n, dev = u_std.shape[0], u_std.device
    u = f.to_mont(u_std)

    def const(v):
        return f.const(v, (n,), dev)

    def g(x):
        return f.add(f.mul(f.square(x), x), f.const(spec.b, x.shape[:-1], dev))

    one = f.ones((n,), dev)
    tv1 = f.mul(f.square(u), const(c1))
    tv2 = f.add(one, tv1)
    tv1 = f.sub(one, tv1)
    tv3 = f.inv(f.mul(tv1, tv2))  # inv0: 0 -> 0
    tv4 = f.mul(f.mul(f.mul(u, tv1), tv3), const(c3))
    x1 = f.sub(const(c2), tv4)
    x2 = f.add(const(c2), tv4)
    x3 = f.add(f.mul(f.square(f.mul(f.square(tv2), tv3)), const(c4)), const(Z))

    xs = torch.cat([x1, x2, x3])
    gxs = g(xs)
    with span("h2c_sqrt"):
        ys = _sqrt_device(f, gxs)
    ok = f.eq(f.square(ys), gxs) | f.is_zero(gxs)
    sq1, sq2 = ok[:n], ok[n : 2 * n]
    x = f.select(sq1, x1, f.select(sq2, x2, x3))
    y = f.select(sq1, ys[:n], f.select(sq2, ys[n : 2 * n], ys[2 * n :]))
    y = f.select(f.is_zero(g(x)), f.zeros((n,), dev), y)

    # sgn0: parity of y must equal parity of (u mod p)
    std = f.from_mont(torch.stack([y, u]))
    flip = (std[0, :, 0] & 1) != (std[1, :, 0] & 1)
    y = f.select(flip, f.neg(y), y)
    return Points(x, y, f.ones((n,), dev))


def hash_bytes_to_points_device(curve: Curve, uniform: bytes, device=None) -> Points:
    """len(uniform) = 64 n bytes -> n affine Points (z = 1), bit-identical to
    `hash_bytes_to_point`."""
    f = curve.fb
    device = resolve(device)
    n = len(uniform) // 64
    raw = np.frombuffer(uniform, dtype="<u4").astype(np.int64).reshape(n, 16)
    u = torch.from_numpy(np.concatenate([raw[:, :8], raw[:, 8:]])).to(device)
    P = svdw_map_device(curve, u)
    S = curve.add(Points(*(c[:n] for c in P)), Points(*(c[n:] for c in P)))
    zinv = f.inv(S.z)
    zi2 = f.square(zinv)
    x, y = f.mul(torch.stack([S.x, S.y]), torch.stack([zi2, f.mul(zi2, zinv)]))
    return Points(x, y, f.ones((n,), device))
