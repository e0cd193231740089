"""Test doubles and references.

MockCommitmentKey: a homomorphic but non-binding commitment,
commit(w) = (sum_i w_i) * G, the same double as
`sirius_tpu/util/testing.py`.  Linear like a Pedersen commitment, so every
folding identity holds bit for bit without MSM cost.  Tests only.

reference_msm: the big-integer model MSM (`sirius_tpu/fields/gold.py`), the
reference the MSM kernels are held to.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..curves.jpoint import Curve
from ..fields import gold
from .device import resolve


@dataclass
class MockCommitmentKey:
    curve: Curve
    device: torch.device | str | None = None  # None: the CUDA device
    max_len: int = 1 << 40

    def __post_init__(self):
        self.device = resolve(self.device)

    def __len__(self):
        return self.max_len

    def commit_device(self, w_mont):
        f = self.curve.fs
        s = f.decode_one(f.sum_reduce(w_mont)) if w_mont.shape[0] else 0
        return gold.generator(self.curve.spec).mul(s)

    def commit_device_many(self, w_monts):
        return [self.commit_device(w) for w in w_monts]

    def batched_commit_check(self, pairs) -> list[int]:
        """The indices of the (W, C) pairs with commit(W) != C, one by one."""
        return [i for i, (W, C) in enumerate(pairs) if self.commit_device(W) != C]

    def commit(self, v_ints):
        s = sum(v % self.curve.fs.p for v in v_ints) % self.curve.fs.p
        return gold.generator(self.curve.spec).mul(s)


def reference_msm(scalars: list[int], points: list[gold.AffinePoint]) -> gold.AffinePoint:
    """sum_i s_i * P_i on host integers (slow: ~20 ms per 254-bit scalar)."""
    return gold.msm(scalars, points)
