"""Satisfaction checks: row-parallel gate evaluation, log-derivative sums,
commitment openings.

Counterpart of `sirius_tpu/plonk/satisfy.py` (reference
`PlonkStructure::is_sat*`, `src/plonk/mod.rs:304-396`): `is_sat` of a plain
trace (SPS challenges re-derived, the compressed gate on every row, the
log-derivative sums, the commitments) and the log-derivative check that
Sangria's `is_sat` shares.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops.poseidon import PoseidonHash
from .eval import PlonkEvalDomain
from .sps import sps_verify
from .structure import PlonkInstance, PlonkStructure, PlonkWitness


class IsSatError(Exception):
    pass


class EvaluationMismatch(IsSatError):
    def __init__(self, mismatch_count: int, total_row: int, rows: list[int]):
        self.mismatch_count = mismatch_count
        self.rows = rows
        super().__init__(f"{mismatch_count}/{total_row} rows violate the compressed gate (first rows: {rows[:8]})")


class LogDerivativeNotSat(IsSatError):
    pass


class CommitmentMismatch(IsSatError):
    pass


def eval_gate_mismatches(S: PlonkStructure, challenges: Sequence[int], W: PlonkWitness) -> torch.Tensor:
    """The compressed gate on every row: the (n,) bool mask of violated rows."""
    f = S.field
    dev = W.W[0].device
    out = PlonkEvalDomain(S, [f.encode(c % f.p, dev) for c in challenges], list(W.W), []).evaluate(
        [S.custom_gates_lookup_compressed.compressed])[0]
    return ~f.is_zero(out.expand(S.n, out.shape[-1]))


def is_sat(S: PlonkStructure, ck, ro_nark: PoseidonHash, U: PlonkInstance, W: PlonkWitness,
           check_commit: bool = True) -> None:
    """Raises an IsSatError unless the trace satisfies S.  check_commit=False
    leaves the commitment openings to the caller (to batch them with others
    in one RLC MSM, `CommitmentKey.batched_commit_check`)."""
    sps_verify(U, ro_nark)
    mask = eval_gate_mismatches(S, U.challenges, W)
    count = int(mask.sum())
    if count:
        raise EvaluationMismatch(count, S.n, torch.nonzero(mask).flatten()[:8].tolist())
    if not is_sat_log_derivative(S, W):
        raise LogDerivativeNotSat()
    if check_commit:
        pairs = list(zip(W.W, U.W_commitments))
        bad = ck.batched_commit_check(pairs)
        if bad:
            raise CommitmentMismatch(f"rounds {bad}")


def is_sat_log_derivative(S: PlonkStructure, W: PlonkWitness) -> bool:
    """sum h == sum g per lookup (reference `plonk/mod.rs:366-396`)."""
    f = S.field
    n = S.n
    nl = S.num_lookups()
    if nl == 0:
        return True
    hg = W.W[2] if S.has_vector_lookup() else W.W[1]
    for li in range(nl):
        h = hg[2 * li * n : (2 * li + 1) * n]
        g = hg[(2 * li + 1) * n : (2 * li + 2) * n]
        if not bool(f.eq(f.sum_reduce(h), f.sum_reduce(g))):
            return False
    return True
