"""B2/B3 plain twins (best_msm) and the B1 path (msm_many) vs gold.msm, on
key points with zero scalars, p - 1 and repeated scalars.  The comparison
with the JAX `msm_bucket_fused` is in `test_torch_msm_jax.py`, the kernels
on a GPU in `test_torch_gpu.py`."""

from functools import lru_cache

import numpy as np
import pytest
import torch

from sirius_tpu_torch.curves.jpoint import BN256_G1, GRUMPKIN, Points
from sirius_tpu_torch.fields import gold
from sirius_tpu_torch.fields.jfield import ints_to_words
from sirius_tpu_torch.ops.commitment import CommitmentKey
from sirius_tpu_torch.ops.msm import best_msm, msm_many

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers

# 1: one point, a zero scalar (every digit dead); 7: odd, grumpkin, msm_many
# pads to 8 over 4 groups; 37: msm_many pads to 64 over 32 groups, two steps;
# 1024: bn256, best_msm's c = 5.  msm_many at n >= 512 (its full 256 groups)
# runs on the GPU only (test_torch_gpu.py): ~60 s here in plain torch.
BEST_SIZES = [1, 7, 1024]
MANY_SIZES = [1, 7, 37]


@lru_cache(maxsize=None)
def _key(name):
    curve = {"bn256_g1": BN256_G1, "grumpkin": GRUMPKIN}[name]
    ck = CommitmentKey.setup(curve, 10, b"torch-msm-test", use_cache=False, device="cpu")
    return curve, ck, ck.host_points()


@lru_cache(maxsize=None)
def _case(n):
    """(curve, points, scalar ints, expected gold.msm) for size n.  Every
    64th scalar is full-width, the others 60-bit: the gold model costs ~20 ms
    per full-width point on a CPU."""
    curve, ck, host = _key("grumpkin" if n % 2 else "bn256_g1")
    q = curve.spec.scalar.modulus
    rng = np.random.default_rng(n)
    ints = [int.from_bytes(rng.bytes(32), "little") % q for _ in range(n)]
    ints = [v if i % 64 == 0 else v >> 194 for i, v in enumerate(ints)]
    for i, v in ((0, 0), (1, q - 1), (2, q - 1), (3, 0)):
        if i < n:
            ints[i] = v
    if n > 6:
        ints[6] = ints[5]  # repeated scalar
    pts = Points(*(c[:n] for c in ck.points))
    return curve, pts, ints, gold.msm(ints, host[:n])


def _words(ints):
    return torch.from_numpy(ints_to_words(ints))


@pytest.mark.parametrize("n", BEST_SIZES)
def test_best_msm_plain_twins_vs_gold(n):
    curve, pts, ints, want = _case(n)
    assert best_msm(curve, _words(ints), pts) == want


@pytest.mark.parametrize("n", MANY_SIZES)
def test_msm_many_b1_path_vs_gold(n):
    curve, pts, ints, want = _case(n)
    q = curve.spec.scalar.modulus
    doubled = [2 * v % q for v in ints]
    got = msm_many(curve, torch.stack([_words(ints), _words(doubled)]), pts)
    assert got == [want, want.double()]
