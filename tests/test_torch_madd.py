"""B1: the plain madd twin vs the JAX `k_madd_incomplete` (run as
`tests/test_limb_kernels.py` runs it: limb-first jnp on the CPU), bit for
bit, including P = identity.  The CUDA kernel vs the twin on a GPU is in
`test_torch_gpu.py`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sirius_tpu.curves.jpoint import BN256_G1, GRUMPKIN
from sirius_tpu.fields import gold
from sirius_tpu.ops.limb_kernels import KF, k_madd_incomplete
from sirius_tpu_torch.curves import jpoint as tp
from sirius_tpu_torch.ops.madd import madd_batch, madd_plain
from sirius_tpu_torch.util.interop import affine_from, to_numpy, to_torch

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers


def _lf(a):
    return jnp.transpose(jnp.asarray(a), (1, 0))


def _case(curve, seed, n=16):
    rng = np.random.default_rng(seed)
    g = gold.generator(curve.spec)
    A = [g.mul(int(rng.integers(1, 1 << 62))) for _ in range(n)]
    B = [g.mul(int(rng.integers(1, 1 << 62))) for _ in range(n)]
    P = curve.dbl(curve.encode(A))  # Jacobian, z != 1
    Q = curve.encode(B)
    P = tuple(np.asarray(c).copy() for c in P)
    one = np.asarray(curve.fb.one_mont_limbs)
    for i in (0, 5):  # identity rows (0, one, 0)
        P[0][i], P[1][i], P[2][i] = 0, one, 0
    return A, B, P, (np.asarray(Q.x), np.asarray(Q.y))


@pytest.mark.parametrize("jcurve", [BN256_G1, GRUMPKIN], ids=lambda c: c.spec.name)
def test_plain_twin_matches_k_madd_incomplete(jcurve):
    A, B, P, (qx, qy) = _case(jcurve, 7)
    f = KF(jcurve.fb)
    want = k_madd_incomplete(f, *(_lf(c) for c in P), _lf(qx), _lf(qy))
    tcurve = tp.curve_for(jcurve.spec)
    got = madd_plain(tcurve, tp.Points(*(to_torch(c, "cpu") for c in P)), to_torch(qx, "cpu"), to_torch(qy, "cpu"))
    for g_, w_ in zip(got, want):
        assert np.array_equal(to_numpy(g_), np.asarray(jnp.transpose(w_, (1, 0))))
    # affine: 2A + B, and Q itself on the identity rows
    expect = [a.double().add(b) for a, b in zip(A, B)]
    expect[0], expect[5] = B[0], B[5]
    assert tcurve.decode(got) == [affine_from(e) for e in expect]


def test_wrapper_takes_the_twin_only_on_cpu():
    A, B, P, (qx, qy) = _case(BN256_G1, 9, n=8)
    curve = tp.BN256_G1
    Pt = tp.Points(*(to_torch(c, "cpu") for c in P))
    before = madd_batch.launches
    out = madd_batch(curve, Pt, to_torch(qx, "cpu"), to_torch(qy, "cpu"))
    assert madd_batch.launches == before  # CPU tensors: no launch
    assert all(torch.equal(a, b) for a, b in zip(out, madd_plain(curve, Pt, to_torch(qx, "cpu"), to_torch(qy, "cpu"))))
    with pytest.raises(ValueError):
        madd_batch(curve, Pt, to_torch(qx, "cpu")[:3], to_torch(qy, "cpu"))
