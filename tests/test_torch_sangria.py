"""Sangria in the port: the frozen fibo 2-fold golden digest
(`tests/test_golden.py`), verify replaying the prover, and is_sat on a
clean and a corrupted accumulator.  The slice as a whole is in
`test_torch_support_chain.py`."""

import pytest
import torch

from fixtures import FiboCircuit
from sirius_tpu.util.golden import sangria_acc_digest
from sirius_tpu_torch.curves.jpoint import BN256_G1
from sirius_tpu_torch.fields import gold
from sirius_tpu_torch.fields.constants import bn256_fq, bn256_fr, bn256_g1
from sirius_tpu_torch.frontend.runner import CircuitRunner
from sirius_tpu_torch.nifs.sangria import RelaxedPlonkInstance, RelaxedPlonkTrace, RelaxedPlonkWitness, VanillaFS
from sirius_tpu_torch.ops.commitment import CommitmentKey
from sirius_tpu_torch.ops.poseidon import PoseidonHash, poseidon_spec
from sirius_tpu_torch.plonk.sps import run_sps_protocol

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers

SANGRIA_FIBO_2FOLD_DIGEST = "1a5a2de2b2308bd72dd55cf500e631d5915d1be12874c39139aebd1614526541"


def _ro():
    return PoseidonHash(poseidon_spec(bn256_fq, 3, 2, 4, 3))


@pytest.fixture(scope="module")
def fibo():
    """Two fibo traces folded into the zero accumulator on a real key."""
    ck = CommitmentKey.setup(BN256_G1, 7, b"sangria-test", use_cache=False, device="cpu")
    p = bn256_fr.modulus
    c1, c2 = FiboCircuit(1, 1, 10), FiboCircuit(2, 3, 10)
    inst1, inst2 = c1.instances(p), c2.instances(p)
    r1 = CircuitRunner(4, bn256_fr, c1, inst1)
    S = r1.collect_plonk_structure()
    W1, W2 = r1.collect_witness(), CircuitRunner(4, bn256_fr, c2, inst2).collect_witness()
    ro = _ro()
    tr1 = run_sps_protocol(S, ck, inst1, W1, ro)
    tr2 = run_sps_protocol(S, ck, inst2, W2, ro)
    pp, vp = VanillaFS.setup_params(gold.identity(bn256_g1), S)
    f = S.field
    acc0 = RelaxedPlonkTrace(
        RelaxedPlonkInstance.new(bn256_g1, S.num_challenges, len(S.round_sizes), len(S.num_io) - 1),
        RelaxedPlonkWitness([f.zeros((sz,), "cpu") for sz in S.round_sizes], f.zeros((S.n,), "cpu")),
    )
    ro_acc = _ro()
    acc, x1 = VanillaFS.prove(ck, pp, ro_acc, acc0, tr1)
    acc, x2 = VanillaFS.prove(ck, pp, ro_acc, acc, tr2)
    return dict(ck=ck, S=S, vp=vp, acc0=acc0, acc=acc, traces=(tr1, tr2), cross=(x1, x2))


def test_fibo_two_fold_golden_digest(fibo):
    assert sangria_acc_digest(fibo["acc"].U) == SANGRIA_FIBO_2FOLD_DIGEST


def test_fibo_verify_replays_prover(fibo):
    ro_nark, ro_acc = _ro(), _ro()
    U = fibo["acc0"].U
    for tr, cross in zip(fibo["traces"], fibo["cross"]):
        U = VanillaFS.verify(fibo["vp"], bn256_g1, ro_nark, ro_acc, U, tr.u, cross)
    assert U == fibo["acc"].U


def test_is_sat_clean_and_catches_corruption(fibo):
    ck, S, acc = fibo["ck"], fibo["S"], fibo["acc"]
    instances = [tr.u.instances for tr in fibo["traces"]]
    assert VanillaFS.is_sat(ck, S, acc, instances) == []
    W0 = acc.W.W[0].clone()
    W0[3, 0] ^= 1
    bad = RelaxedPlonkTrace(acc.U, RelaxedPlonkWitness([W0], acc.W.E))
    errors = [str(e) for e in VanillaFS.is_sat(ck, S, bad, instances)]
    assert any("accumulation gate mismatch" in e for e in errors)
    assert any("witness commitment mismatch" in e for e in errors)
