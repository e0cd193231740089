"""Gate expression -> row-parallel evaluation over column tensors.

Counterpart of `sirius_tpu/poly/evaluator.py`.  The AST is walked once per
call with structural memoization (shared subexpressions evaluate once);
every node is a field op over whole (n, 8) Montgomery column tensors, so
the per-row loop disappears.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..fields.jfield import Field
from .expression import Challenge, Constant, Expression, Neg, Poly, Product, Query, Scaled, Sum


def evaluate_expressions(
    field: Field,
    exprs: Sequence[Expression],
    resolve_poly: Callable[[Query], torch.Tensor],
    resolve_challenge: Callable[[int], torch.Tensor],
    device,
) -> list[torch.Tensor]:
    """resolve_poly(query) -> the rotated (n, 8) Montgomery column;
    resolve_challenge(i) -> an (8,) Montgomery scalar."""
    f = field
    memo: dict[Expression, torch.Tensor] = {}

    def go(e: Expression) -> torch.Tensor:
        hit = memo.get(e)
        if hit is not None:
            return hit
        if isinstance(e, Constant):
            r = f.const(e.value % f.p, (), device)
        elif isinstance(e, Poly):
            r = resolve_poly(e.query)
        elif isinstance(e, Challenge):
            r = resolve_challenge(e.index)
        elif isinstance(e, Neg):
            r = f.neg(go(e.arg))
        elif isinstance(e, Sum):
            r = f.add(go(e.lhs), go(e.rhs))
        elif isinstance(e, Product):
            r = f.mul(go(e.lhs), go(e.rhs))
        elif isinstance(e, Scaled):
            r = f.mul(go(e.arg), f.const(e.scalar % f.p, (), device))
        else:
            raise TypeError(e)
        memo[e] = r
        return r

    return [go(e) for e in exprs]


def rotate_rows(col: torch.Tensor, rotation: int) -> torch.Tensor:
    """Cyclic rotation: out[i] = col[(i + rotation) mod n]."""
    if rotation == 0:
        return col
    return torch.roll(col, -rotation, 0)
