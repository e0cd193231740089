"""Copy-constraint permutation check on the device.

Counterpart of `sirius_tpu/plonk/permutation.py`.  The cycle assembly and
COO matrix are the JAX package's own jax-free host code, re-exported; the
check is a torch gather + row compare: P is a permutation matrix, so
P @ Z == Z <=> Z[idx] == Z.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from sirius_tpu.plonk.permutation import Assembly, PermutationData  # noqa: F401


def perm_index_vector(triplets: Iterable[tuple[int, int, int]], total: int) -> np.ndarray:
    """COO triplets of P -> idx with (P @ Z)[r] = Z[idx[r]]."""
    idx = np.arange(total, dtype=np.int64)
    for r, c, _v in triplets:
        idx[r] = c
    return idx


def device_perm_mismatches(f, idx, head_ints: Sequence[int], W0_slice: torch.Tensor) -> int:
    """Count of rows with Z[idx] != Z, Z = [encode(head_ints) | W0_slice]
    (both Montgomery, canonical)."""
    dev = W0_slice.device
    head = f.encode([v % f.p for v in head_ints], dev).reshape(len(head_ints), -1)
    Z = torch.cat([head, W0_slice])
    idx_t = torch.as_tensor(idx, dtype=torch.int64, device=dev)
    return int((Z[idx_t] != Z).any(-1).sum())
