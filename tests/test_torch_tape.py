"""The port's witness tape (`sirius_tpu_torch/frontend/tape.py`) and its
native interpreter (`sirius_tpu_torch/native/witness_tape.cpp`): each
opcode against Python ints, the native replay against the plain
`_replay_py` and against the JAX package's native replay on one seeded
fuzz program, the port's recorder against the JAX package's on the same
program, and a failed build or replay raising (no Python fallback)."""

import random

import numpy as np
import pytest
import torch

from sirius_tpu.frontend import tape as jtape
from sirius_tpu.native import tape_replay_native as j_tape_replay_native
from sirius_tpu_torch import native
from sirius_tpu_torch.frontend import circuit as tcircuit
from sirius_tpu_torch.frontend import tape as ttape

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers

P = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001  # bn256 Fr
Q = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47  # bn256 Fq


def _replay_both(tape, inputs, trs):
    """Native and plain replays of the slots of `trs`, as ints."""
    slots = np.asarray([t.s for t in trs], dtype=np.uint32)
    native_out = tape.replay(inputs, slots)
    plain_out = tape._replay_py(inputs, slots)
    assert np.array_equal(native_out, plain_out)
    return [int.from_bytes(bytes(r), "little") for r in native_out]


OPS = {
    "add": lambda x, y, tp: x + y,
    "radd": lambda x, y, tp: 12345 + x,
    "sub": lambda x, y, tp: (x - y) % P,
    "rsub": lambda x, y, tp: (7 - x) % P,
    "mul": lambda x, y, tp: x * y % P,
    "neg": lambda x, y, tp: (-x) % P,
    "mod": lambda x, y, tp: x % 1000003,
    "floordiv": lambda x, y, tp: x // 97,
    "divmod": lambda x, y, tp: divmod(x, 1 << 20)[0] + divmod(y, 1 << 20)[1],
    "shr": lambda x, y, tp: x >> 77,
    "shl": lambda x, y, tp: (x << 13) % P,
    "and": lambda x, y, tp: x & 0xFFFF_FFFF_FFFF,
    "xor": lambda x, y, tp: x ^ y,
    "rxor": lambda x, y, tp: 0xABCDEF ^ x,
    "pow_small": lambda x, y, tp: x ** 3 % P,
    "powm": lambda x, y, tp: pow(x, 65537, P),
    "pow_inv": lambda x, y, tp: pow(x, -1, P),
    "bit": lambda x, y, tp: tp.bit(x, 200) + tp.bit(y, 0),
    "inv0": lambda x, y, tp: tp.inv0(x, Q),
    "is_zero": lambda x, y, tp: tp.is_zero(x % P),
    "sub_then_mod": lambda x, y, tp: (x - y - P) % P,
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_opcode_matches_python_ints(name):
    rng = random.Random(name)
    fn = OPS[name]
    for _ in range(4):
        x, y = rng.getrandbits(254) % P or 1, rng.getrandbits(256)
        t = ttape.TapeBuilder()
        tx, ty = t.inputs(2)
        out = fn(tx, ty, ttape)
        assert isinstance(out, ttape.Tr)
        assert _replay_both(t, [x, y], [out]) == [fn(x, y, ttape)]


@pytest.mark.parametrize("x", [0, P, 2 * P, 1, P - 1])
def test_inv0_and_is_zero_edges(x):
    t = ttape.TapeBuilder()
    tx = t.input()
    outs = [ttape.inv0(tx, P), ttape.is_zero(tx), ttape.is_zero(tx % P)]
    want = [ttape.inv0(x, P), ttape.is_zero(x), ttape.is_zero(x % P)]
    assert _replay_both(t, [x], outs) == want
    assert want[0] == (0 if x % P == 0 else pow(x % P, -1, P))


def test_reduction_skipped_when_already_bounded():
    t = ttape.TapeBuilder()
    x = t.input()  # range [0, 2^256)
    assert x % (1 << 256) is x and not t.code
    b = ttape.bit(x, 5)
    n = len(t.code)
    assert b % 2 is b and len(t.code) == n
    assert ttape.clamp(x, 0, P - 1) % P is not x  # a new handle on the same slot, no op
    assert ttape.clamp(x, 0, P - 1).s == x.s and len(t.code) == n
    assert x % P is not x and len(t.code) == n + 2  # the modulus constant and the MODC
    assert (x >> 0) is x and (x << 0) is x


def test_control_flow_and_indexing_raise():
    t = ttape.TapeBuilder()
    x = t.input()
    with pytest.raises(TypeError):
        bool(x)
    with pytest.raises(TypeError):
        if x:
            pass
    with pytest.raises(TypeError):
        [1, 2][x]
    with pytest.raises(TypeError):
        range(x)
    with pytest.raises(TypeError):
        x % -3
    with pytest.raises(ValueError):
        (x - 1) & 7  # possibly negative
    assert bool(x == 3) and bool(x < 0)  # comparisons trace as truthy placeholders
    assert ttape.is_traced(x) and not ttape.is_traced(3)


def test_overflow_and_fixed_guards():
    t = ttape.TapeBuilder()
    x = t.input()
    with pytest.raises(OverflowError):
        x * x * x * x  # 1024-bit bound: past the interpreter's 1008 bits
    with pytest.raises(OverflowError):
        t.const(1 << 1010)
    with pytest.raises(ValueError):
        t.input()  # inputs come before the first op
    cs = tcircuit.ConstraintSystemBuilder()
    col = cs.fixed_column()
    asn = tcircuit.Assignment(cs, 2, P, [])
    with pytest.raises(TypeError):
        asn.assign_fixed(col, 0, ttape.TapeBuilder().input())


def _fuzz(tp, rng: random.Random, n_ops: int = 300):
    """A seeded random program on `tp`'s TapeBuilder: (tape, inputs, output
    handles).  Operands are reduced mod P before an op that could pass the
    interpreter's bound or needs a non-negative operand."""
    t = tp.TapeBuilder()
    ins = t.inputs(8)
    vals = [rng.getrandbits(256) for _ in range(8)]
    pool = list(ins)

    def small(v):
        return v if -(1 << 300) < v.lb and v.ub < (1 << 300) else v % P

    def nonneg(v):
        return v if v.lb >= 0 else v % P

    while len(t.code) < n_ops:
        a, b = rng.choice(pool), rng.choice(pool)
        op = rng.randrange(16)
        if op == 0:
            r = small(a) + small(b)
        elif op == 1:
            r = small(a) - small(b)
        elif op == 2:
            r = small(a) * small(b)
        elif op == 3:
            r = a % rng.choice([P, Q, 1 << 64, 1000003])
        elif op == 4:
            r = a // rng.choice([3, 1 << 61, P])
        elif op == 5:
            r = a >> rng.randrange(1, 300)
        elif op == 6:
            r = small(a) << rng.randrange(1, 200)
        elif op == 7:
            r = nonneg(a) & rng.getrandbits(rng.randrange(1, 300))
        elif op == 8:
            r = nonneg(a) ^ nonneg(b)
        elif op == 9:
            r = tp.bit(nonneg(a), rng.randrange(0, 260))
        elif op == 10:
            r = tp.inv0(a, rng.choice([P, Q]))
        elif op == 11:
            r = tp.is_zero(a % 5)
        elif op == 12:
            r = pow(a, rng.randrange(0, 1 << 20), P)
        elif op == 13:
            r = small(a) ** 2
        elif op == 14:
            r = -small(a)
        else:
            r = rng.getrandbits(100) - small(a)
        pool.append(r)
    return t, vals, pool


def test_native_replay_equals_plain_on_fuzz_program():
    t, vals, pool = _fuzz(ttape, random.Random(7))
    assert len(t.code) >= 300
    # the slots whose traced range is canonical (what a witness column may hold) are the outputs
    outs = np.asarray([v.s for v in pool if 0 <= v.lb and v.ub < (1 << 256)], dtype=np.uint32)
    assert len(outs) > 150
    native_out = t.replay(vals, outs)
    assert np.array_equal(native_out, t._replay_py(vals, outs))
    # the JAX package's interpreter on the same finalized tape, byte for byte
    j_out = j_tape_replay_native(t._finalize(), vals, outs)
    assert j_out is not None and np.array_equal(native_out, j_out)


def test_recorder_matches_jax_package():
    t, _, _ = _fuzz(ttape, random.Random(11))
    j, _, _ = _fuzz(jtape, random.Random(11))
    for mine, theirs in zip(t._finalize()[:4], j._finalize()[:4]):
        assert mine.dtype == theirs.dtype and np.array_equal(mine, theirs)
    assert t.consts == j.consts and t.n_inputs == j.n_inputs


def test_replay_error_raises():
    t = ttape.TapeBuilder()
    x = t.input()
    neg = x - 5  # negative for x < 5: not a canonical output
    with pytest.raises(RuntimeError, match="native tape replay failed"):
        t.replay([3], np.asarray([neg.s], dtype=np.uint32))
    with pytest.raises(ValueError):
        t._replay_py([3], np.asarray([neg.s], dtype=np.uint32))
    with pytest.raises(ValueError):
        t.replay([3, 4], np.asarray([neg.s], dtype=np.uint32))


def test_failed_build_raises(monkeypatch, tmp_path):
    t = ttape.TapeBuilder()
    out = t.input() + 1
    monkeypatch.setattr(native, "CXX", "no-such-c++-compiler")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    native._load_tape.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="witness tape build"):
            t.replay([1], np.asarray([out.s], dtype=np.uint32))
        assert not list(tmp_path.glob("*.so"))
    finally:
        native._load_tape.cache_clear()
