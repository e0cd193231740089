"""Satisfaction checks needed by Sangria `is_sat`.

Counterpart of the part of `sirius_tpu/plonk/satisfy.py` that
`nifs/sangria.py` uses: the log-derivative sum check (sum h == sum g per
lookup).  The gate and permutation checks live with their callers.
"""

from __future__ import annotations

from .structure import PlonkStructure, PlonkWitness


class IsSatError(Exception):
    pass


def is_sat_log_derivative(S: PlonkStructure, W: PlonkWitness) -> bool:
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
