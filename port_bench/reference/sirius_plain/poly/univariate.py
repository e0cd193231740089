"""Dense univariate polynomials over a prime field (host ints).

The port's own copy of `sirius_tpu/poly/univariate.py`, with what the
port's paths use (the ProtoGalaxy F and K polynomials: coefficients and
Horner evaluation).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields.constants import FieldSpec


@dataclass
class UnivariatePoly:
    """coeffs[i] is the coefficient of X^i."""

    spec: FieldSpec
    coeffs: list[int]

    def __len__(self):
        return len(self.coeffs)

    def eval(self, x: int) -> int:
        """Horner evaluation (reference `univariate.rs:67-75`)."""
        p = self.spec.modulus
        acc = 0
        for c in reversed(self.coeffs):
            acc = (acc * x + c) % p
        return acc
