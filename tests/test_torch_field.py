"""Port field arithmetic vs the JAX package's `Field` and Python ints
(exact: integer results, canonical encodings compared word for word)."""

import math

import numpy as np
import pytest
import torch

from sirius_tpu.fields import jfield as jf
from sirius_tpu_torch.fields import jfield as tf
from sirius_tpu_torch.util.interop import to_numpy, to_torch

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers

NAMES = ["bn256_fq", "bn256_fr", "pasta_fp", "pasta_fq"]


def _pair(name):
    return jf._FIELDS[name], tf._FIELDS[name]


def _inputs(J, seed, n=48):
    rng = np.random.default_rng(seed)
    a = np.asarray(J.random((n,), rng))
    b = np.asarray(J.random((n,), rng))
    # edge values: 0, 1, p-1
    edge = np.asarray(J.encode([0, 1, J.p - 1]))
    return np.concatenate([a, edge]), np.concatenate([b, edge[::-1]])


@pytest.mark.parametrize("name", NAMES)
def test_encode_decode_and_random_match_jax(name):
    J, T = _pair(name)
    xs = [0, 1, J.p - 1, 2**200 + 12345, J.p // 3]
    assert np.array_equal(to_numpy(T.encode(xs, "cpu")), np.asarray(J.encode(xs)))
    assert T.decode(T.encode(xs, "cpu")) == [x % J.p for x in xs]
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    assert np.array_equal(to_numpy(T.random((7,), rng_a, "cpu")), np.asarray(J.random((7,), rng_b)))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match_jax(name, op):
    J, T = _pair(name)
    a, b = _inputs(J, 10 * NAMES.index(name) + len(op))
    got = getattr(T, op)(to_torch(a, "cpu"), to_torch(b, "cpu"))
    want = getattr(J, op)(a, b)
    assert np.array_equal(to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("name", ["bn256_fq", "bn256_fr"])
def test_unary_ops_match_jax(name):
    J, T = _pair(name)
    a, _ = _inputs(J, 11)
    ta = to_torch(a, "cpu")
    for t_out, j_out in (
        (T.neg(ta), J.neg(a)),
        (T.square(ta), J.square(a)),
        (T.from_mont(ta), J.from_mont(a)),
        (T.to_mont(ta), J.to_mont(a)),
        (T.pow_int(ta[:8], 12345), J.pow_int(a[:8], 12345)),
        (T.inv(ta[:4]), J.inv(a[:4])),
        (T.batch_inv(ta), J.batch_inv(a)),
        (T.sum_reduce(ta), J.sum_reduce(a)),
    ):
        assert np.array_equal(to_numpy(t_out), np.asarray(j_out))
    assert bool(T.eq(ta, ta).all()) and not bool(T.eq(ta[:3], ta[1:4]).any())
    assert T.is_zero(to_torch(np.asarray(J.zeros((2,))), "cpu")).all()


def test_ops_against_python_ints_with_broadcast():
    T = tf.FR
    p = T.p
    rng = np.random.default_rng(3)
    xs = [int(v) % p for v in rng.integers(0, 2**62, 20)] + [0, p - 1]
    ys = [5, p - 2, 0]
    got = T.decode(T.mul(T.encode(xs, "cpu")[:, None], T.encode(ys, "cpu")[None, :]))
    assert got == [x * y % p for x in xs for y in ys]
    assert T.decode(T.sub(T.encode(xs, "cpu"), T.encode(xs[::-1], "cpu"))) == [(x - y) % p for x, y in zip(xs, xs[::-1])]


def _strided_rows(t, k):
    """t's rows at every k-th row of a wider table (a view, not contiguous)."""
    wide = torch.zeros((t.shape[0] * k,) + tuple(t.shape[1:]), dtype=t.dtype)
    wide[::k] = t
    return wide[::k]


# (a's batch shape, b's batch shape, whether ring_op expands an operand first: neither n rows nor one)
RING_FORMS = {
    "rows_rows": ((40,), (40,), False),
    "rows_scalar": ((40,), (), False),
    "scalar_rows": ((), (40,), False),
    "nodes_scalar": ((20, 3), (), False),
    "scalar_scalar": ((), (), False),
    "table_wrapped": ((5, 4), (4,), True),
    "table_repeated": ((5, 4), (5, 1), True),
    "block_repeated_wrapped": ((2, 3, 4), (1, 3, 1), True),
    "outer": ((6, 1), (1, 5), True),
    "gapped": ((3, 4, 5), (3, 1, 5), True),
    "empty": ((0,), (), False),
}


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
@pytest.mark.parametrize("form", RING_FORMS)
def test_ring_op_broadcasts_equal_the_limb_arithmetic(form, op, monkeypatch):
    """`field_kernels.ring_op`, the ring ops' route on CUDA tensors, run here
    on CPU tensors (the kernels' plain twins), equals `Field.limbs` word for
    word at every broadcast form, strided views of either operand included:
    one kernel call with b of n rows or one row, the full operand first, and
    the operand expanded first for any other broadcast."""
    from sirius_tpu_torch.ops import field_kernels as fk

    T = tf.FR
    a_shape, b_shape, expands = RING_FORMS[form]
    rng = np.random.default_rng(len(form))
    a, b = T.random(a_shape, rng, "cpu"), T.random(b_shape, rng, "cpu")
    calls = []
    plain = fk.addsub_rows_plain if op != "mul" else fk.mul_rows_plain
    monkeypatch.setattr(fk, plain.__name__, lambda f, x, y, *args: calls.append((x.shape[0], y.shape[0])) or
                        plain(f, x, y, *args))
    want = getattr(T.limbs, op)(a, b)
    assert torch.equal(fk.ring_op(T, op, a, b), want)
    n = math.prod(torch.broadcast_shapes(a_shape, b_shape))
    assert calls == ([] if n == 0 else [(n, n if expands or b_shape == a_shape or n == 1 else 1)])
    if a.dim() == 2 and a.shape[0]:
        assert torch.equal(fk.ring_op(T, op, _strided_rows(a, 3), b), want)
    if b.dim() == 2 and b.shape[0]:
        assert torch.equal(fk.ring_op(T, op, a, _strided_rows(b, 2)), want)
    if op == "sub":
        assert torch.equal(fk.ring_op(T, "sub", T._c("zero", "cpu"), a), T.limbs.neg(a))
