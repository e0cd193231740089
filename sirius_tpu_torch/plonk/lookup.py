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
constraints to the gates.  The prover passes (`evaluate_coefficient_1`,
`ArgumentCoefficient1.evaluate_coefficient_2`) keep every vector as an
(n, 8) Montgomery tensor on the witness's device: l and t through the gate
evaluator, m through `ops/lookup_kernels.m_count` (the hash-table kernel on
a CUDA tensor, its plain version `m_count_plain` beside it on a CPU one), h
and g by batch inversion.  Under row blocks (`parallel/rows.py`) l and t
come out of the evaluator as row blocks; m counts over the whole of l and
t, so those are gathered to the mesh's first device for one `m_count` there
and m goes back as row blocks; h and g run block by block.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from ..fields.jfield import WORDS
from ..ops.lookup_kernels import m_count, m_count_plain  # noqa: F401 (m's plain version, importable here)
from ..parallel.rows import RowBlocks, blockwise, expanded, gathered, home
from ..poly.expression import Challenge, Constant, Expression, Poly, Query, compress_expression
from ..util.profiling import span


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

    # -- prover passes (reference `lookup.rs:213-320`) -------------------------------
    def evaluate_coefficient_1(self, S, advice: torch.Tensor, r: int) -> "ArgumentCoefficient1":
        """l and t per row, then m.  `advice`: the advice columns as one
        (num_advice * n, 8) Montgomery tensor (the first W round's head);
        queries resolve to selectors, then fixed columns, then advice, and
        every challenge to r (the vector lookups' compression challenge)."""
        from .eval import PlonkEvalDomain

        f, n = S.field, S.n
        with span("lookup_l_t"):
            outs = PlonkEvalDomain(S, [f.encode(r % f.p, home(advice))], [advice], []).evaluate(
                self.lookup_polys + self.table_polys)
            outs = [blockwise(torch.Tensor.contiguous, expanded(o, n)) for o in outs]
        ls, ts = outs[: self.num_lookups()], outs[self.num_lookups() :]
        with span("lookup_m"):
            ms = []
            for l, t in zip(ls, ts):
                lg, tg = gathered(l), gathered(t)
                words = torch.zeros((n, WORDS), dtype=torch.int64, device=tg.device)
                words[:, 0] = m_count(lg, tg)
                m = f.to_mont(words)
                ms.append(RowBlocks.shard(t.mesh, m, n) if isinstance(t, RowBlocks) else m)
        return ArgumentCoefficient1(S, ls, ts, ms)


@dataclass
class ArgumentCoefficient1:
    """The (l, t, m) vectors of each lookup, (n, 8) Montgomery tensors."""

    S: object
    ls: list[torch.Tensor]
    ts: list[torch.Tensor]
    ms: list[torch.Tensor]

    def evaluate_coefficient_2(self, r: int) -> "ArgumentCoefficient2":
        """h = 1/(l + r), g = m/(t + r), zeros where l + r or t + r is 0
        (reference `evaluate_h_g`)."""
        f = self.S.field
        hs, gs = [], []
        rr: dict = {}

        def inv_shifted(x):  # 1 / (x + r), r encoded once a device
            if x.device not in rr:
                rr[x.device] = f.encode(r % f.p, x.device)
            return f.batch_inv(f.add(x, rr[x.device]))

        with span("lookup_h_g"):
            for l, t, m in zip(self.ls, self.ts, self.ms):
                hs.append(blockwise(inv_shifted, l))
                gs.append(blockwise(lambda mb, tb: f.mul(mb, inv_shifted(tb)), m, t))
        return ArgumentCoefficient2(hs, gs)


@dataclass
class ArgumentCoefficient2:
    """The (h, g) vectors of each lookup."""

    hs: list[torch.Tensor]
    gs: list[torch.Tensor]
