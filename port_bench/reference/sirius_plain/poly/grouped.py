"""Degree-grouped polynomials: expand P(x + r*y) by powers of r.

The port's own copy of `sirius_tpu/poly/grouped.py`, with what the port's
paths use (the port imports nothing of the JAX package).

Replaces reference `src/polynomial/grouped_poly.rs` (SURVEY.md §2.2).
`terms[d]` is the Expression coefficient of r^d; terms 1..deg-1 are the
Sangria cross-terms T_k.  The paired "incoming" variables use the shifted
index space from `QueryIndexContext.shift_*_index`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .expression import (
    Challenge,
    Constant,
    Expression,
    Neg,
    Poly,
    Product,
    Query,
    QueryIndexContext,
    QueryType,
    Scaled,
    Sum,
)


@dataclass
class GroupedPoly:
    terms: list[Optional[Expression]] = field(default_factory=list)

    @staticmethod
    def new(expr: Expression, ctx: QueryIndexContext) -> "GroupedPoly":
        if isinstance(expr, Constant):
            return GroupedPoly([expr])
        if isinstance(expr, Poly):
            terms: list[Optional[Expression]] = [expr]
            st = expr.query.subtype(ctx)
            if st == QueryType.ADVICE:
                terms.append(Poly(Query(ctx.shift_advice_index(expr.query.index), expr.query.rotation)))
            elif st == QueryType.LOOKUP:
                terms.append(Poly(Query(ctx.shift_lookup_index(expr.query.index), expr.query.rotation)))
            return GroupedPoly(terms)
        if isinstance(expr, Challenge):
            return GroupedPoly([expr, Challenge(expr.index + ctx.num_challenges)])
        if isinstance(expr, Neg):
            return GroupedPoly.new(expr.arg, ctx).neg()
        if isinstance(expr, Sum):
            return GroupedPoly.new(expr.lhs, ctx).add(GroupedPoly.new(expr.rhs, ctx))
        if isinstance(expr, Product):
            return GroupedPoly.new(expr.lhs, ctx).mul(GroupedPoly.new(expr.rhs, ctx))
        if isinstance(expr, Scaled):
            return GroupedPoly.new(expr.arg, ctx).scale(expr.scalar)
        raise TypeError(expr)

    # -- term algebra ---------------------------------------------------------
    def neg(self) -> "GroupedPoly":
        return GroupedPoly([None if t is None else Neg(t) for t in self.terms])

    def scale(self, k: int) -> "GroupedPoly":
        return GroupedPoly([None if t is None else Scaled(t, k) for t in self.terms])

    def add(self, other: "GroupedPoly") -> "GroupedPoly":
        n = max(len(self.terms), len(other.terms))
        out: list[Optional[Expression]] = []
        for d in range(n):
            a = self.terms[d] if d < len(self.terms) else None
            b = other.terms[d] if d < len(other.terms) else None
            if a is None:
                out.append(b)
            elif b is None:
                out.append(a)
            else:
                out.append(Sum(a, b))
        return GroupedPoly(out)

    def mul(self, other: "GroupedPoly") -> "GroupedPoly":
        if not self.terms or not other.terms:
            return GroupedPoly([])
        n = len(self.terms) + len(other.terms) - 1
        out: list[Optional[Expression]] = [None] * n
        for i, a in enumerate(self.terms):
            if a is None:
                continue
            for j, b in enumerate(other.terms):
                if b is None:
                    continue
                prod = Product(a, b)
                out[i + j] = prod if out[i + j] is None else Sum(out[i + j], prod)
        return GroupedPoly(out)

    # -- access ----------------------------------------------------------------
    def __len__(self):
        return len(self.terms)

    def iter_from_first(self):
        """Terms of degree >= 1 (the cross-term coefficients), reference
        `iter_from_first`."""
        return iter(self.terms[1:])

    def term(self, d: int) -> Optional[Expression]:
        return self.terms[d] if d < len(self.terms) else None
