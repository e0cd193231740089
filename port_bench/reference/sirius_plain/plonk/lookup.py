"""Protostar log-derivative lookup arguments.

Counterpart of `sirius_tpu/plonk/lookup.py` (reference `src/plonk/lookup.rs`).
Per lookup the five per-row vectors are (l, t, m, h, g):

    l = L(x..)   the compressed input expression
    t = T(y..)   the compressed table expression
    m_i          the number of rows of l equal to t_i, at the first
                 occurrence of t_i only
    h = 1/(l + r),  g = m/(t + r)    (zeros where the denominator is 0)
    sum h == sum g   (the log-derivative identity)

The structure-time half compresses the expressions and adds their
constraints to the gates; the verifier checks sum h == sum g
(`plonk/satisfy.is_sat_log_derivative`).  The prover's passes are left out.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from ..poly.expression import Challenge, Constant, Expression, Poly, Query, compress_expression


@dataclass
class LookupArguments:
    lookup_polys: list[Expression]
    table_polys: list[Expression]
    has_vector_lookup: bool

    @staticmethod
    def compress_from(lookups: Sequence[tuple[Sequence[Expression], Sequence[Expression]]]) -> Optional["LookupArguments"]:
        """lookups: (input_exprs, table_exprs) pairs in the global index
        space; vector lookups compress with Challenge(0)."""
        if not lookups:
            return None
        max_len = max(len(inp) for inp, _ in lookups)
        if max_len == 0:
            return None
        return LookupArguments(
            [compress_expression(list(inp), 0) for inp, _ in lookups],
            [compress_expression(list(tbl), 0) for _, tbl in lookups],
            max_len > 1,
        )

    def num_lookups(self) -> int:
        return len(self.lookup_polys)

    def vanishing_lookup_polys(self, lookup_offset: int) -> list[Expression]:
        ls = [L - Poly(Query(lookup_offset + i * 5, 0)) for i, L in enumerate(self.lookup_polys)]
        ts = [T - Poly(Query(lookup_offset + i * 5 + 1, 0)) for i, T in enumerate(self.table_polys)]
        return ls + ts

    def log_derivative_lhs_and_rhs(self, lookup_offset: int) -> list[Expression]:
        r = Challenge(1 if self.has_vector_lookup else 0)
        out = []
        for i in range(self.num_lookups()):
            l, t, m, h, g = (Poly(Query(lookup_offset + i * 5 + j, 0)) for j in range(5))
            out.append(h * (l + r) - Constant(1))
            out.append(g * (t + r) - m)
        return out

    def to_expressions(self, lookup_offset: int) -> list[Expression]:
        return self.vanishing_lookup_polys(lookup_offset) + self.log_derivative_lhs_and_rhs(lookup_offset)
