"""Port curve arithmetic vs the JAX package's `Curve` (Jacobian outputs
word for word) and the gold model (affine; JAX points cross into the port
by value through `interop.affine_from`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sirius_tpu.curves import jpoint as jp
from sirius_tpu.fields import gold
from sirius_tpu_torch.curves import jpoint as tp
from sirius_tpu_torch.util.interop import affine_from, to_numpy, to_torch

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers

NAMES = ["bn256_g1", "grumpkin"]


def _points(spec, seed, n):
    rng = np.random.default_rng(seed)
    g = gold.generator(spec)
    return [g.mul(int(rng.integers(1, 2**62))) for _ in range(n)]


def _t(pts):
    return [affine_from(p) for p in pts]


def _same(tP, jP):
    return all(np.array_equal(to_numpy(t), np.asarray(j)) for t, j in zip(tP, jP))


@pytest.mark.parametrize("name", NAMES)
def test_encode_identity_decode(name):
    J, T = jp._CURVES[name], tp._CURVES[name]
    pts = _points(J.spec, 1, 5) + [gold.identity(J.spec)]
    assert _same(T.encode(_t(pts), "cpu"), J.encode(pts))
    assert _same(T.identity((3,), "cpu"), J.identity((3,)))
    assert T.decode(T.encode(_t(pts), "cpu")) == _t(pts)


@pytest.mark.parametrize("name", NAMES)
def test_add_dbl_madd_match_jax_bit_for_bit(name):
    J, T = jp._CURVES[name], tp._CURVES[name]
    A = _points(J.spec, 2, 8)
    B = _points(J.spec, 3, 8)
    B[1] = A[1]  # doubling case
    B[2] = A[2].neg()  # inverse pair
    A[3] = gold.identity(J.spec)
    B[4] = gold.identity(J.spec)
    jA, jB = J.dbl(J.encode(A)), J.encode(B)  # Jacobian P with z != 1
    tA, tB = (tp.Points(*(to_torch(np.asarray(c), "cpu") for c in P)) for P in (jA, jB))
    assert _same(T.add(tA, tB), J.add(jA, jB))
    assert _same(T.dbl(tA), J.dbl(jA))
    ok = [0, 5, 6, 7]  # madd contract: Q affine, not the identity, Q != +-P
    jP = jp.Points(*(c[np.asarray(ok)] for c in jA))
    jQ = jp.Points(*(c[np.asarray(ok)] for c in jB))
    tP = tp.Points(*(c[ok] for c in tA))
    assert _same(T.add_mixed_fast(tP, to_torch(np.asarray(jQ.x), "cpu"), to_torch(np.asarray(jQ.y), "cpu")),
                 J.add_mixed_fast(jP, jQ))
    want = _t([a.double().add(b) for a, b in zip(A, B)])
    assert T.decode(T.add(tA, tB)) == want


@pytest.mark.parametrize("name", NAMES)
def test_scalar_mul_and_sum_reduce(name):
    J, T = jp._CURVES[name], tp._CURVES[name]
    A = _points(J.spec, 4, 5)
    k = 2**130 + 987654321
    tA = T.encode(_t(A), "cpu")
    got = T.scalar_mul(tA, k)
    assert T.decode(got) == _t([a.mul(k) for a in A])
    if name == "grumpkin":  # one JAX compile of the fori_loop ladder is enough
        bits = np.array([(k >> i) & 1 for i in range(k.bit_length())], dtype=np.uint32)
        assert _same(got, J.scalar_mul(J.encode(A), jnp.asarray(bits)))
    assert T.decode(T.sum_reduce(tA))[0] == affine_from(gold.msm([1] * 5, A))
