"""Pure-Python (bignum int) gold model for field and curve arithmetic.

The port's own copy of `sirius_tpu/fields/gold.py`: the correctness oracle
the kernels are held to, and the host-side scalar engine (transcript
random oracle, commitment folds, circuit inputs).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from .constants import CurveSpec, FieldSpec


# ---------------------------------------------------------------------------
# Scalar field helpers (ints mod p). We deliberately do NOT wrap every element
# in a class on hot host paths; functions take/return plain ints.
# ---------------------------------------------------------------------------


def inv_mod(a: int, p: int) -> int:
    return pow(a, -1, p)


# ---------------------------------------------------------------------------
# Elliptic curve points (affine + jacobian), short Weierstrass a=0 curves.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AffinePoint:
    """Affine point; (None, None) encodes the identity."""

    curve: CurveSpec
    x: int | None
    y: int | None

    @property
    def is_identity(self) -> bool:
        return self.x is None

    def __post_init__(self):
        if self.x is not None:
            p = self.curve.base.modulus
            assert (
                self.y * self.y - (self.x**3 + self.curve.a * self.x + self.b_)
            ) % p == 0, "point not on curve"

    @property
    def b_(self) -> int:
        return self.curve.b

    def neg(self) -> "AffinePoint":
        if self.is_identity:
            return self
        return AffinePoint(self.curve, self.x, (-self.y) % self.curve.base.modulus)

    def add(self, other: "AffinePoint") -> "AffinePoint":
        c, p = self.curve, self.curve.base.modulus
        if self.is_identity:
            return other
        if other.is_identity:
            return self
        if self.x == other.x:
            if (self.y + other.y) % p == 0:
                return identity(c)
            # doubling
            lam = (3 * self.x * self.x + c.a) * inv_mod(2 * self.y, p) % p
        else:
            lam = (other.y - self.y) * inv_mod((other.x - self.x) % p, p) % p
        x3 = (lam * lam - self.x - other.x) % p
        y3 = (lam * (self.x - x3) - self.y) % p
        return AffinePoint(c, x3, y3)

    def double(self) -> "AffinePoint":
        return self.add(self)

    def mul(self, k: int) -> "AffinePoint":
        k %= self.curve.scalar.modulus
        acc, base = identity(self.curve), self
        while k:
            if k & 1:
                acc = acc.add(base)
            base = base.double()
            k >>= 1
        return acc


def identity(curve: CurveSpec) -> AffinePoint:
    return AffinePoint(curve, None, None)


def generator(curve: CurveSpec) -> AffinePoint:
    return AffinePoint(curve, curve.gx, curve.gy)


def msm(scalars: Sequence[int], points: Sequence[AffinePoint]) -> AffinePoint:
    """Naive MSM oracle (reference semantics: `best_multiexp`,
    `src/commitment.rs:81-90`)."""
    assert len(scalars) == len(points)
    acc = identity(points[0].curve) if points else None
    assert acc is not None
    for s, pt in zip(scalars, points):
        acc = acc.add(pt.mul(s))
    return acc


# ---------------------------------------------------------------------------
# NTT oracle (matches reference `src/fft.rs` semantics: in-place radix-2 with
# omega = ROOT_OF_UNITY^(2^(S-k))).
# ---------------------------------------------------------------------------


def omega_for_k(fs: FieldSpec, k: int) -> int:
    """Domain generator for size 2^k (reference `src/fft.rs:12-23`)."""
    assert k <= fs.two_adicity
    omega = fs.root_of_unity
    for _ in range(fs.two_adicity - k):
        omega = omega * omega % fs.modulus
    return omega


def fft(values: Sequence[int], fs: FieldSpec, inverse: bool = False) -> list[int]:
    """O(n log n) gold NTT; bit-exact semantics of reference `fft`/`ifft`
    (`src/fft.rs:160-182`)."""
    n = len(values)
    k = n.bit_length() - 1
    assert 1 << k == n
    p = fs.modulus
    omega = omega_for_k(fs, k)
    if inverse:
        omega = inv_mod(omega, p)
    a = list(values)
    # bit reversal
    for i in range(n):
        j = int(format(i, f"0{k}b")[::-1], 2) if k else 0
        if j > i:
            a[i], a[j] = a[j], a[i]
    m = 1
    while m < n:
        w_m = pow(omega, n // (2 * m), p)
        for start in range(0, n, 2 * m):
            w = 1
            for j in range(m):
                t = a[start + j + m] * w % p
                a[start + j + m] = (a[start + j] - t) % p
                a[start + j] = (a[start + j] + t) % p
                w = w * w_m % p
        m *= 2
    if inverse:
        n_inv = inv_mod(n, p)
        a = [x * n_inv % p for x in a]
    return a


