"""Evaluation domains: resolve expression queries to column tensors.

Counterpart of `sirius_tpu/plonk/eval.py`: selectors and fixed columns come
from the structure's device mirrors, folded variables from static slices of
the round witness tensors.  The rows where each structure column is nonzero
are found once per structure and device (the evaluator's sparse products).

Rounds held as row blocks (`parallel/rows.py`) are swept block by block:
block d evaluates today's expressions over its own n / D rows, every
rotated column built from the block and the halo rows of its cyclic
neighbours (`RowBlocks.window`, once per column and sweep), the structure
columns and their supports from the structure's per-block mirrors.  Each
expression then comes out as a one-column RowBlocks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from ..fields.jfield import WORDS
from ..parallel.rows import RowBlocks, sweeps
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
        scalar for a constant one), a one-column RowBlocks where the
        witness is row blocks."""
        if isinstance(self.W1s[0], RowBlocks):
            return self._evaluate_blocks(exprs)
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

    def _evaluate_blocks(self, exprs: Sequence[Expression]) -> list[RowBlocks]:
        """`evaluate` over row blocks: block after block, each on its device
        (a card's launches queue while the host goes on to the next)."""
        S = self.S
        mesh, n = self.W1s[0].mesh, self.W1s[0].n
        nb = n // mesh.size
        Ws1, Ws2 = ([w if isinstance(w, RowBlocks) else RowBlocks.shard(mesh, w, n) for w in Ws]
                    for Ws in (self.W1s, self.W2s))
        lo, hi = S.halo()
        num_sel, num_fixed = S.selectors.shape[0], len(S.fixed_columns)
        max_width = S.num_fold_vars()
        outs: list[list[torch.Tensor]] = [[] for _ in exprs]
        for d, dev in enumerate(mesh.devices):
            sel, fixed = S.columns_block(mesh, d, lo, hi)
            challenges = [c.to(dev) for c in self.challenges]
            windows: dict[tuple[int, int, int], torch.Tensor] = {}

            def resolve_poly(q: Query):
                idx, rot = q.index, q.rotation
                if not -lo <= rot <= hi:
                    raise ValueError(f"rotation {rot} outside the structure's halo [{-lo}, {hi}]")
                if idx < num_sel + num_fixed:
                    col = sel[idx] if idx < num_sel else fixed[idx - num_sel]
                    return col[lo + rot : lo + rot + nb]
                fold_idx = idx - num_sel - num_fixed
                Ws, side, local = (Ws1, 0, fold_idx) if fold_idx < max_width else (Ws2, 1, fold_idx - max_width)
                rnd, slot = witness_index_map(S.num_advice_columns, len(Ws), local)
                if rot == 0:
                    return Ws[rnd].blocks[d][slot * nb : (slot + 1) * nb]
                key = (side, rnd, slot)
                if key not in windows:
                    windows[key] = Ws[rnd].window(slot, d, lo, hi)
                return windows[key][lo + rot : lo + rot + nb]

            def resolve_support(q: Query):
                if q.index >= num_sel + num_fixed:
                    return None
                key = ("support", mesh, d, q.index, q.rotation)
                if key not in S.cache:
                    S.cache[key] = torch.nonzero(~S.field.is_zero(resolve_poly(q))).flatten()
                return S.cache[key]

            res = evaluate_expressions(S.field, exprs, resolve_poly, challenges.__getitem__, dev, nb, resolve_support)
            sweeps[str(dev)] += 1
            for out, r in zip(outs, res):
                out.append(r.expand(nb, WORDS))
        return [RowBlocks(mesh, n, 1, blocks) for blocks in outs]
