"""ProtoGalaxy in the port (`sirius_tpu_torch/nifs/protogalaxy.py`) against
`sirius_tpu/nifs/protogalaxy.py`: the frozen fibo one-fold digest
(`tests/test_golden.py`), and on fibo traces with L = 1 and L = 3 (the
JAX package's traces carried into the port by value) the same F and K
coefficients, the same folded accumulator (digest and witness words) and
the same verifier instance; is_sat is clean and catches a flipped witness
cell and a wrong e."""

import numpy as np
import pytest
import torch

from fixtures import FiboCircuit
from sirius_tpu.curves.jpoint import BN256_G1 as J_BN256_G1
from sirius_tpu.fields import gold as jgold
from sirius_tpu.fields.constants import bn256_fr as j_bn256_fr
from sirius_tpu.fields.constants import bn256_g1 as j_bn256_g1
from sirius_tpu.frontend.runner import CircuitRunner as JRunner
from sirius_tpu.nifs import protogalaxy as jpg
from sirius_tpu.ops.commitment import CommitmentKey as JCommitmentKey
from sirius_tpu.ops.poseidon import PoseidonHash as JPoseidonHash
from sirius_tpu.ops.poseidon import poseidon_spec as j_poseidon_spec
from sirius_tpu.plonk.sps import run_sps_protocol as j_run_sps
from sirius_tpu.util.golden import pg_acc_digest as j_pg_acc_digest
from sirius_tpu_torch.curves.jpoint import BN256_G1
from sirius_tpu_torch.fields import gold
from sirius_tpu_torch.fields.constants import bn256_fr, bn256_g1
from sirius_tpu_torch.frontend.runner import CircuitRunner
from sirius_tpu_torch.nifs.protogalaxy import Accumulator, AccumulatorInstance, ProtoGalaxy
from sirius_tpu_torch.ops.commitment import CommitmentKey
from sirius_tpu_torch.ops.poseidon import PoseidonHash, poseidon_spec
from sirius_tpu_torch.plonk.sps import run_sps_protocol
from sirius_tpu_torch.plonk.structure import PlonkTrace, PlonkWitness
from sirius_tpu_torch.util.golden import pg_acc_digest
from sirius_tpu_torch.util.interop import plonk_trace_from, witness_to_numpy

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers

K = 4
PG_FIBO_1FOLD_DIGEST = "ac15a68e6cc6cf7f3afe286e52291414977a854bcd2b1144baa88e3a2ef24df9"
FIBO_PARAMS = [(1, 1, 10), (2, 3, 10), (5, 8, 10)]


def _ro():
    return PoseidonHash(poseidon_spec(bn256_fr, 3, 2, 4, 3))


def _jro():
    return JPoseidonHash(j_poseidon_spec(j_bn256_fr, 3, 2, 4, 3))


def _port_structure():
    c = FiboCircuit(*FIBO_PARAMS[0])
    return CircuitRunner(K, bn256_fr, c, c.instances(bn256_fr.modulus)).collect_plonk_structure()


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's structure, key and fibo traces on one transcript."""
    ck = JCommitmentKey.setup(J_BN256_G1, 7, b"pg-test", use_cache=True, window_bits=4)
    p = j_bn256_fr.modulus
    circuits = [FiboCircuit(*ps) for ps in FIBO_PARAMS]
    S = JRunner(K, j_bn256_fr, circuits[0], circuits[0].instances(p)).collect_plonk_structure()
    ro = _jro()
    traces = [j_run_sps(S, ck, c.instances(p), JRunner(K, j_bn256_fr, c, c.instances(p)).collect_witness(), ro)
              for c in circuits]
    return ck, S, traces


def test_fibo_one_fold_golden_digest():
    """The whole pipeline in the port: key, synthesis, SPS, new, prove."""
    ck = CommitmentKey.setup(BN256_G1, 7, b"sangria-test", use_cache=False, device="cpu")
    p = bn256_fr.modulus
    c1, c2 = FiboCircuit(1, 1, 10), FiboCircuit(2, 3, 10)
    r1 = CircuitRunner(K, bn256_fr, c1, c1.instances(p))
    S = r1.collect_plonk_structure()
    tr1 = run_sps_protocol(S, ck, c1.instances(p), r1.collect_witness(), _ro())
    tr2 = run_sps_protocol(S, ck, c2.instances(p), CircuitRunner(K, bn256_fr, c2, c2.instances(p)).collect_witness(),
                           _ro())
    pp, _ = ProtoGalaxy.setup_params(gold.identity(bn256_g1), S)
    acc = ProtoGalaxy.new_accumulator(pp, _ro(), tr1, bn256_g1)
    new_acc, _ = ProtoGalaxy.prove(ck, pp, _ro(), acc, [tr2])
    assert pg_acc_digest(AccumulatorInstance.from_acc(new_acc)) == PG_FIBO_1FOLD_DIGEST


@pytest.mark.parametrize("L", [1, 3], ids=["L1", "L3"])
def test_prove_and_verify_match_jax(jax_side, L):
    jck, jS, jtraces = jax_side
    incoming_j = jtraces[:L]
    jpp, jvp = jpg.ProtoGalaxy.setup_params(jgold.identity(j_bn256_g1), jS)
    jacc = jpg.ProtoGalaxy.new_accumulator(jpp, _jro(), jtraces[0], j_bn256_g1)
    jnew, jproof = jpg.ProtoGalaxy.prove(jck, jpp, _jro(), jacc, incoming_j)
    jver = jpg.ProtoGalaxy.verify(jvp, j_bn256_fr, _jro(), _jro(), jpg.AccumulatorInstance.from_acc(jacc),
                                  [t.u for t in incoming_j], jproof)

    S = _port_structure()
    ck = CommitmentKey.setup(BN256_G1, 7, b"pg-test", use_cache=False, device="cpu")
    traces = [plonk_trace_from(t, "cpu") for t in incoming_j]
    pp, vp = ProtoGalaxy.setup_params(gold.identity(bn256_g1), S)
    acc = ProtoGalaxy.new_accumulator(pp, _ro(), traces[0], bn256_g1)
    assert (acc.betas, acc.e) == (jacc.betas, jacc.e)
    new_acc, proof = ProtoGalaxy.prove(ck, pp, _ro(), acc, traces)
    assert proof.poly_F.coeffs == jproof.poly_F.coeffs
    assert proof.poly_K.coeffs == jproof.poly_K.coeffs
    want = j_pg_acc_digest(jpg.AccumulatorInstance.from_acc(jnew))
    assert pg_acc_digest(AccumulatorInstance.from_acc(new_acc)) == want
    for t, j in zip(witness_to_numpy(new_acc.trace.w.W), jnew.trace.w.W):
        assert np.array_equal(t, np.asarray(j))
    ver = ProtoGalaxy.verify(vp, bn256_fr, _ro(), _ro(), AccumulatorInstance.from_acc(acc), [t.u for t in traces],
                             proof)
    assert ver == AccumulatorInstance.from_acc(new_acc)
    assert pg_acc_digest(ver) == j_pg_acc_digest(jver)
    assert ProtoGalaxy.is_sat(ck, S, new_acc) == []


def test_is_sat_catches_a_flipped_cell_and_a_wrong_e(jax_side):
    _, _, jtraces = jax_side
    S = _port_structure()
    ck = CommitmentKey.setup(BN256_G1, 7, b"pg-test", use_cache=False, device="cpu")
    traces = [plonk_trace_from(t, "cpu") for t in jtraces[:2]]
    pp, _ = ProtoGalaxy.setup_params(gold.identity(bn256_g1), S)
    acc = ProtoGalaxy.new_accumulator(pp, _ro(), traces[0], bn256_g1)
    acc, _ = ProtoGalaxy.prove(ck, pp, _ro(), acc, traces[1:])
    assert ProtoGalaxy.is_sat(ck, S, acc) == []

    W0 = acc.trace.w.W[0].clone()
    W0[3, 0] ^= 1  # column a, row 3: inside the fibo gate's rows
    flipped = Accumulator(PlonkTrace(acc.trace.u, PlonkWitness([W0, *acc.trace.w.W[1:]])), acc.betas, acc.e)
    errors = [str(e) for e in ProtoGalaxy.is_sat(ck, S, flipped)]
    assert any("e mismatch" in e for e in errors), errors
    assert any("witness commitment mismatch" in e for e in errors), errors

    wrong_e = Accumulator(acc.trace, acc.betas, (acc.e + 1) % bn256_fr.modulus)
    errors = [str(e) for e in ProtoGalaxy.is_sat(ck, S, wrong_e)]
    assert len(errors) == 1 and "e mismatch" in errors[0], errors
