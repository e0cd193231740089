"""Evaluation domains: resolve expression queries to column tensors.

Counterpart of `sirius_tpu/plonk/eval.py`: selectors and fixed columns come
from the structure's device mirrors, folded variables from static slices of
the round witness tensors.  The rows where each structure column is nonzero
are found once per structure and device (the evaluator's sparse products).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from ..poly.evaluator import evaluate_expressions, rotate_rows
from ..poly.expression import Expression, Query
from .structure import PlonkStructure


def witness_index_map(num_advice: int, num_witness: int, index: int) -> tuple[int, int]:
    """Folded-variable index -> (round, slot)."""
    if index < num_advice:
        return (0, index)
    lookup_index, sub = divmod(index - num_advice, 5)
    first_round, sub = (True, sub) if sub < 3 else (False, sub - 3)
    if num_witness == 2:
        return (0, num_advice + lookup_index * 3 + sub) if first_round else (1, lookup_index * 2 + sub)
    if num_witness == 3:
        return (1, lookup_index * 3 + sub) if first_round else (2, lookup_index * 2 + sub)
    raise ValueError(f"invalid witness index {index} for {num_witness} rounds")


@dataclass
class PlonkEvalDomain:
    """Accumulator (W1s) and incoming (W2s) witnesses; W2s empty for plain
    satisfaction checks."""

    S: PlonkStructure
    challenges: list  # (8,) Montgomery scalars
    W1s: list  # (round_size, 8) tensors
    W2s: list

    def evaluate(self, exprs: Sequence[Expression]) -> list:
        """Each expression over every row: an (n, 8) tensor (or an (8,)
        scalar for a constant one)."""
        S = self.S
        n = S.n
        dev = self.W1s[0].device
        sel, fixed = S.selectors_on(dev), S.fixed_on(dev)
        num_sel, num_fixed = sel.shape[0], fixed.shape[0]
        max_width = S.num_fold_vars()

        def resolve_poly(q: Query):
            idx = q.index
            if idx < num_sel:
                col = sel[idx]
            elif idx < num_sel + num_fixed:
                col = fixed[idx - num_sel]
            else:
                fold_idx = idx - num_sel - num_fixed
                Ws, local = (self.W1s, fold_idx) if fold_idx < max_width else (self.W2s, fold_idx - max_width)
                rnd, slot = witness_index_map(S.num_advice_columns, len(Ws), local)
                col = Ws[rnd][slot * n : (slot + 1) * n]
            return rotate_rows(col, q.rotation)

        def resolve_support(q: Query):
            """Rows where a selector or fixed column may be nonzero."""
            if q.index >= num_sel + num_fixed:
                return None
            key = ("support", q.index, q.rotation, str(dev))
            if key not in S.cache:
                col = sel[q.index] if q.index < num_sel else fixed[q.index - num_sel]
                S.cache[key] = torch.nonzero(~S.field.is_zero(rotate_rows(col, q.rotation))).flatten()
            return S.cache[key]

        return evaluate_expressions(S.field, exprs, resolve_poly, self.challenges.__getitem__, dev, n,
                                    resolve_support)
