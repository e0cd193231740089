"""Lagrange basis over cyclic subgroups (host ints).

The port's own copy of `sirius_tpu/poly/lagrange.py`, with what the
port's paths use (the port imports nothing of the JAX package).

Replaces reference `src/polynomial/lagrange.rs` (SURVEY.md §2.1):
  L_i(X) = (omega^i / n) * (X^n - 1) / (X - omega^i)
with the 0/0 -> delta special case when X is itself a domain point.
"""

from __future__ import annotations

from typing import Iterator

from ..fields.constants import FieldSpec
from ..fields import gold


def iter_cyclic_subgroup(spec: FieldSpec, log_n: int) -> Iterator[int]:
    """Domain points 1, w, w^2, ... (reference `lagrange.rs:22-26`)."""
    p = spec.modulus
    w = gold.omega_for_k(spec, log_n)
    acc = 1
    for _ in range(1 << log_n):
        yield acc
        acc = acc * w % p


def iter_eval_lagrange_poly_for_cyclic_group(
    spec: FieldSpec, point: int, log_n: int
) -> Iterator[int]:
    """Evaluate every L_i at `point` (reference `lagrange.rs:50-74`)."""
    p = spec.modulus
    n = 1 << log_n
    w = gold.omega_for_k(spec, log_n)
    n_inv = pow(n, -1, p)
    vanishing = (pow(point, n, p) - 1) % p
    w_i = 1
    for _ in range(n):
        denom = (point - w_i) % p
        if denom == 0:
            # point is the i-th domain element: L_i = 1 there
            yield 1 if vanishing == 0 else 0
        else:
            yield w_i * n_inv % p * vanishing % p * pow(denom, -1, p) % p
        w_i = w_i * w % p


def eval_vanish_polynomial(spec: FieldSpec, log_n: int, point: int) -> int:
    """Z(X) = X^n - 1 (reference `lagrange.rs:83-85`)."""
    return (pow(point, 1 << log_n, spec.modulus) - 1) % spec.modulus
