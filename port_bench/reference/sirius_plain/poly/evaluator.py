"""Gate expression -> row-parallel evaluation over column tensors.

Counterpart of `sirius_tpu/poly/evaluator.py`.  The AST is walked once per
call with structural memoization (shared subexpressions evaluate once);
every node is a field op over whole (n, 8) Montgomery column tensors, so
the per-row loop disappears.

Products with a sparse factor run on its rows only.  A structure column
(selector or fixed) is zero on most rows of a circuit, and a product with
it is zero there; the caller's `resolve_support(query)` names the rows
where such a column may be nonzero.  The support of a product is the
intersection of its factors' supports: both factors are evaluated on
those rows alone and the product is scattered into zeros.  A Plonkish
gate is a sum of such products, so most of its multiplications never run
(the Cyclefold step circuit's gate at k = 17: about a tenth of them).
The values are the dense evaluation's, word for word.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..fields.jfield import WORDS, Field
from .expression import Challenge, Constant, Expression, Neg, Poly, Product, Query, Scaled, Sum


def evaluate_expressions(
    field: Field,
    exprs: Sequence[Expression],
    resolve_poly: Callable[[Query], torch.Tensor],
    resolve_challenge: Callable[[int], torch.Tensor],
    device,
    n: int,
    resolve_support: Callable[[Query], Optional[torch.Tensor]],
) -> list[torch.Tensor]:
    """resolve_poly(query) -> the rotated (n, 8) Montgomery column;
    resolve_challenge(i) -> an (8,) Montgomery scalar; resolve_support(query)
    -> the sorted rows where the rotated column may be nonzero, or None where
    any row may be (a witness column); n is the row count."""
    f = field
    supports: dict[Expression, Optional[torch.Tensor]] = {}
    restricted: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}
    memo: dict[tuple[Expression, int], torch.Tensor] = {}

    def support(e: Expression) -> Optional[torch.Tensor]:
        if e in supports:
            return supports[e]
        s = None
        if isinstance(e, Poly):
            s = resolve_support(e.query)
        elif isinstance(e, (Neg, Scaled)):
            s = support(e.arg)
        elif isinstance(e, Product):
            a, b = support(e.lhs), support(e.rhs)
            s = a if b is None else b if a is None or a is b else a[torch.isin(a, b)]
        supports[e] = s
        return s

    def restrict(s: torch.Tensor, rows: Optional[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
        """(the rows of s inside `rows`, their positions in `rows`)."""
        if rows is None:
            return s, s
        key = (id(s), id(rows))
        if key not in restricted:
            sub = s[torch.isin(s, rows)]
            restricted[key] = (sub, torch.searchsorted(rows, sub))
        return restricted[key]

    def go(e: Expression, rows: Optional[torch.Tensor]) -> torch.Tensor:
        """e on `rows` (None: every row): (len(rows), 8), (n, 8) or an (8,)
        scalar."""
        key = (e, id(rows))
        hit = memo.get(key)
        if hit is not None:
            return hit
        if isinstance(e, Constant):
            r = f.const(e.value % f.p, (), device)
        elif isinstance(e, Poly):
            col = resolve_poly(e.query)
            r = col if rows is None else col[rows]
        elif isinstance(e, Challenge):
            r = resolve_challenge(e.index)
        elif isinstance(e, Neg):
            r = f.neg(go(e.arg, rows))
        elif isinstance(e, Sum):
            r = f.add(go(e.lhs, rows), go(e.rhs, rows))
        elif isinstance(e, Scaled):
            r = f.mul(go(e.arg, rows), f.const(e.scalar % f.p, (), device))
        elif isinstance(e, Product):
            s = support(e)
            if s is None or s is rows:
                r = f.mul(go(e.lhs, rows), go(e.rhs, rows))
            else:
                sub, pos = restrict(s, rows)
                prod = f.mul(go(e.lhs, sub), go(e.rhs, sub))
                r = torch.zeros((n if rows is None else rows.shape[0], WORDS), dtype=torch.int64, device=device)
                r[pos] = prod.expand(sub.shape[0], WORDS)
        else:
            raise TypeError(e)
        memo[key] = r
        return r

    return [go(e, None) for e in exprs]


def rotate_rows(col: torch.Tensor, rotation: int) -> torch.Tensor:
    """Cyclic rotation: out[i] = col[(i + rotation) mod n]."""
    if rotation == 0:
        return col
    return torch.roll(col, -rotation, 0)
