"""The CUDA kernels against their plain torch twins on an NVIDIA GPU.

Needs a card (marker `gpu`; skipped elsewhere) and imports no jax, so it
also runs where only torch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from sirius_tpu.fields import gold
from sirius_tpu_torch.curves.jpoint import BN256_G1, GRUMPKIN, Points
from sirius_tpu_torch.fields.jfield import ints_to_words
from sirius_tpu_torch.ops import msm_kernels as mk
from sirius_tpu_torch.ops.commitment import CommitmentKey
from sirius_tpu_torch.ops.madd import madd_batch, madd_plain
from sirius_tpu_torch.ops.msm import best_msm, bucket_plan, msm_many

CURVES = [BN256_G1, GRUMPKIN]
IDS = ["bn256_g1", "grumpkin"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda")


def _key(curve, device):
    return CommitmentKey.setup(curve, 10, b"torch-gpu-test", use_cache=False, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("curve", CURVES, ids=IDS)
def test_madd_kernel_bit_exact(cuda_device, curve):
    ck = _key(curve, cuda_device)
    n = 512
    P = Points(*(c.clone() for c in curve.dbl(Points(*(c[n:] for c in ck.points)))))
    for c, i in zip(P, curve.identity((8,), cuda_device)):
        c[:8] = i
    qx, qy = ck.points.x[:n].contiguous(), ck.points.y[:n].contiguous()
    before = madd_batch.launches
    got = madd_batch(curve, P, qx, qy)
    assert madd_batch.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, madd_plain(curve, P, qx, qy)))


@pytest.mark.gpu
@pytest.mark.parametrize("curve", CURVES, ids=IDS)
def test_msm_kernels_match_twins_and_gold(cuda_device, curve):
    ck = _key(curve, cuda_device)
    n = 1024
    q = curve.spec.scalar.modulus
    rng = np.random.default_rng(3)
    # every 64th scalar full-width, the rest 60-bit: the gold model is slow
    ints = [int.from_bytes(rng.bytes(32), "little") % q >> (0 if i % 64 == 0 else 194) for i in range(n)]
    ints[:3] = [0, q - 1, q - 1]
    S = torch.from_numpy(ints_to_words(ints)).to(cuda_device)
    plan = bucket_plan(S)
    args = (curve, plan.entries, plan.chunk_start, plan.chunk_len, ck.points.x, ck.points.y)
    parts = mk.msm_accumulate(*args)
    assert all(torch.equal(a, b) for a, b in zip(parts, mk.msm_accumulate_plain(*args)))
    buckets = mk.msm_reduce(curve, plan.seg_off, parts)
    assert curve.decode(buckets) == curve.decode(mk.msm_reduce_plain(curve, plan.seg_off, parts))
    shaped = Points(*(b.reshape(1, plan.W, plan.B, 8) for b in buckets))
    out = mk.msm_combine(curve, shaped, plan.c)
    assert curve.decode(out) == curve.decode(mk.msm_combine_plain(curve, shaped, plan.c))
    want = gold.msm(ints, ck.host_points())
    assert curve.decode(out)[0] == want
    assert best_msm(curve, S, ck.points) == want
    assert msm_many(curve, S[None], ck.points) == [want]
