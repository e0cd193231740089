"""The lookup path in the port (`sirius_tpu_torch/plonk/{lookup,sps}.py`)
against `sirius_tpu`: the multiplicity count's plain version against the
JAX package's `_device_m_count` and its host hashmap; the 2- and 3-round
SPS of `tests/test_lookup.py`'s circuits at K = 5, every W round, commitment
and challenge equal to the JAX package's (live), and each trace's digest
equal to the one frozen from it (`util/golden.py`, which the card's smoke
run holds its K = 5 traces to); the lookup violation; the refusal of two
lookup arguments.  The folds over lookup traces are in
`test_torch_lookup_folds.py`.
"""

import numpy as np
import pytest
import torch

import test_lookup as jt
from sirius_tpu.curves.jpoint import BN256_G1 as J_BN256_G1
from sirius_tpu.fields.constants import bn256_fr as j_bn256_fr
from sirius_tpu.fields.jfield import field_for as j_field_for
from sirius_tpu.frontend.runner import CircuitRunner as JRunner
from sirius_tpu.ops.commitment import CommitmentKey as JCommitmentKey
from sirius_tpu.plonk.lookup import _device_m_count
from sirius_tpu.plonk.sps import run_sps_protocol as j_run_sps
from sirius_tpu_torch.curves.jpoint import BN256_G1
from sirius_tpu_torch.fields.constants import bn256_fq, bn256_fr
from sirius_tpu_torch.fields.jfield import FR
from sirius_tpu_torch.frontend.runner import CircuitRunner
from sirius_tpu_torch.ops import lookup_kernels
from sirius_tpu_torch.ops.commitment import CommitmentKey
from sirius_tpu_torch.ops.poseidon import PoseidonHash, poseidon_spec
from sirius_tpu_torch.plonk import satisfy
from sirius_tpu_torch.ops.lookup_kernels import m_count_plain
from sirius_tpu_torch.plonk.sps import SpsError, run_sps_protocol
from sirius_tpu_torch.util import golden
from sirius_tpu_torch.util.golden import plonk_trace_digest
from sirius_tpu_torch.util.interop import affine_from, limbs_to_words
from sirius_tpu_torch.util.testing import RangeCircuit, VectorRangeCircuit

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers

K = 5
RANGE_VALUES = [3, 7, 15, 0, 1, 1, 5]
VECTOR_VALUES = [2, 3, 5, 7, 11]
CIRCUITS = {"range_2_rounds": (RangeCircuit, jt.RangeCircuit, RANGE_VALUES, 2, golden.LOOKUP_RANGE_K5_TRACE),
            "vector_3_rounds": (VectorRangeCircuit, jt.VectorRangeCircuit, VECTOR_VALUES, 3,
                                golden.LOOKUP_VECTOR_K5_TRACE)}


def _ro():
    return PoseidonHash(poseidon_spec(bn256_fq, 3, 2, 4, 3))


@pytest.fixture(scope="module")
def ck():
    return CommitmentKey.setup(BN256_G1, 9, b"lookup-test", use_cache=False, device="cpu")


def _trace(circuit, ck, ro):
    runner = CircuitRunner(K, bn256_fr, circuit, circuit.instances())
    S = runner.collect_plonk_structure()
    return S, run_sps_protocol(S, ck, circuit.instances(), runner.collect_witness(), ro)


@pytest.fixture(scope="module")
def jax_traces():
    """The JAX package's K = 5 traces of both circuits (tests/test_lookup.py)."""
    jck = JCommitmentKey.setup(J_BN256_G1, 9, b"lookup-test", use_cache=False, window_bits=4)
    out = {}
    for name, (_, jcls, values, _, _) in CIRCUITS.items():
        c = jcls(values)
        runner = JRunner(K, j_bn256_fr, c, c.instances())
        out[name] = j_run_sps(runner.collect_plonk_structure(), jck, c.instances(), runner.collect_witness(),
                              jt.create_ro())
    return out


def _hashmap_counts(l, t):
    """The JAX package's host hashmap (`sirius_tpu/plonk/lookup.py:199-211`)."""
    counts = {}
    for v in l:
        counts[v] = counts.get(v, 0) + 1
    seen, out = set(), []
    for v in t:
        out.append(0 if v in seen else counts.get(v, 0))
        seen.add(v)
    return out


def _m_count_case(case):
    rng = np.random.default_rng(3 if case == "test_lookup_data" else 17)
    if case == "test_lookup_data":  # tests/test_lookup.py:156-188
        n = 64
        t = [int(v) for v in rng.integers(0, 12, size=n)]
        t[5] = t[9] = t[11]
        l = [int(v) for v in rng.integers(0, 16, size=n)]
        l[0] = t[11]
    elif case == "n1":
        t, l = [7], [7]
    else:  # n not a power of two: duplicate groups in t, misses and repeats in l, full-width values
        n = 1000
        wide = [int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(20)]
        t = [wide[int(i)] for i in rng.integers(0, 20, size=n)]
        l = [wide[int(i)] if i < 20 else int(i) for i in rng.integers(0, 26, size=n)]
    return l, t


@pytest.mark.parametrize("case", ["test_lookup_data", "ragged_1000", "n1"])
def test_m_count_plain_matches_jax_and_the_host_hashmap(case):
    l, t = _m_count_case(case)
    want = _hashmap_counts(l, t)
    jf = j_field_for(j_bn256_fr)
    assert [int(v) for v in _device_m_count(jf.encode(l), jf.encode(t))] == want
    lw, tw = FR.encode(l, "cpu"), FR.encode(t, "cpu")
    got = m_count_plain(lw, tw)
    assert got.dtype == torch.int32 and got.tolist() == want
    before = lookup_kernels.m_count.launches
    assert lookup_kernels.m_count(lw, tw).tolist() == want  # a CPU tensor: the plain version, no launch
    assert lookup_kernels.m_count.launches == before


def test_m_count_capacity_and_refusals():
    assert [lookup_kernels.table_capacity(n) for n in (0, 1, 2, 3, 1 << 17)] == [2, 2, 4, 8, 1 << 18]
    with pytest.raises(ValueError, match="words"):
        lookup_kernels.m_count(torch.zeros(4, 7, dtype=torch.int64), torch.zeros(4, 8, dtype=torch.int64))
    assert m_count_plain(torch.zeros(3, 8, dtype=torch.int64), torch.zeros(0, 8, dtype=torch.int64)).shape == (0,)


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_sps_matches_jax_word_for_word(ck, jax_traces, name):
    cls, _, values, rounds, frozen = CIRCUITS[name]
    S, tr = _trace(cls(values), ck, _ro())
    jtr = jax_traces[name]
    assert S.num_challenges == rounds and len(tr.w.W) == rounds
    assert tr.u.challenges == jtr.u.challenges
    assert tr.u.W_commitments == [affine_from(c) for c in jtr.u.W_commitments]
    assert [w.shape[0] for w in tr.w.W] == S.round_sizes
    for w, jw in zip(tr.w.W, jtr.w.W):
        assert np.array_equal(w.numpy(), limbs_to_words(np.asarray(jw)))
    assert plonk_trace_digest([w.numpy() for w in tr.w.W], tr.u) == frozen
    satisfy.is_sat(S, ck, _ro(), tr.u, tr.w)


def test_lookup_violation_detected(ck):
    """99 is not in the table: the gates hold (h and g are the inverses),
    the log-derivative sums differ."""
    S, tr = _trace(RangeCircuit([3, 99]), ck, _ro())
    assert not satisfy.is_sat_log_derivative(S, tr.w)
    with pytest.raises(satisfy.LogDerivativeNotSat):
        satisfy.is_sat(S, ck, _ro(), tr.u, tr.w)


class _TwoLookups:
    """Two scalar lookup arguments: a layout the SPS refuses."""

    def configure(self, cs):
        a, b, t = cs.advice_column(), cs.advice_column(), cs.fixed_column()
        cs.lookup([cs.query(a)], [cs.query(t)])
        cs.lookup([cs.query(b)], [cs.query(t)])
        cs.instance_column()
        return a, b, t

    def synthesize(self, config, asn):
        a, b, t = config
        for row in range(1 << 3):
            asn.assign_fixed(t, row, row)
            asn.assign_advice(a, row, row)
            asn.assign_advice(b, row, 7 - row)


def test_two_lookup_arguments_raise_sps_error():
    c = _TwoLookups()
    runner = CircuitRunner(3, bn256_fr, c, [[]])
    S = runner.collect_plonk_structure()
    assert S.num_lookups() == 2 and S.num_challenges == 2
    with pytest.raises(SpsError, match="2 lookup arguments"):
        run_sps_protocol(S, CommitmentKey.setup(BN256_G1, 6, b"two", use_cache=False, device="cpu"), [[]],
                         runner.collect_witness(), _ro())
