"""Sangria IVC in the port against `sirius_tpu` on the Poseidon step circuit
(the reference's `sangria_poseidon` bench step) on the primary and the
trivial one on the secondary, k = 16, mock keys: the step circuit's
`process_step`, the public parameters (a step circuit with a MainGate of its
own: 6 primary cross terms and 1 SPS challenge), one `fold_step` and
verify.  In a file of its own, beside `test_torch_sangria_ivc.py`, so that
the two spread across test workers."""

import numpy as np
import pytest
import torch

from sirius_tpu.curves.jpoint import BN256_G1 as J_BN256_G1
from sirius_tpu.curves.jpoint import GRUMPKIN as J_GRUMPKIN
from sirius_tpu.fields.constants import bn256_fr as j_bn256_fr
from sirius_tpu.gadgets.poseidon_step_circuit import PoseidonStepCircuit as JPoseidonStepCircuit
from sirius_tpu.ivc.sangria_ivc import IVC as JIVC
from sirius_tpu.ivc.sangria_ivc import PublicParams as JPublicParams
from sirius_tpu.ivc.step_circuit import TrivialStepCircuit as JTrivialStepCircuit
from sirius_tpu.util.digest import structure_digest_stream as j_structure_digest_stream
from sirius_tpu.util.testing import MockCommitmentKey as JMockKey
from sirius_tpu_torch.curves.jpoint import BN256_G1, GRUMPKIN
from sirius_tpu_torch.fields.constants import bn256_fr
from sirius_tpu_torch.gadgets.poseidon_step_circuit import PoseidonStepCircuit
from sirius_tpu_torch.ivc.sangria_ivc import IVC, PublicParams
from sirius_tpu_torch.ivc.step_circuit import TrivialStepCircuit
from sirius_tpu_torch.util.digest import structure_digest_stream
from sirius_tpu_torch.util.golden import sangria_acc_digest
from sirius_tpu_torch.util.interop import affine_from
from sirius_tpu_torch.util.testing import MockCommitmentKey

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers

K = 16
Z0_PRIMARY, Z0_SECONDARY = [0x42], [0]


@pytest.mark.parametrize("repeat_count", [1, 3])
def test_process_step_matches_jax(repeat_count):
    rng = np.random.default_rng(repeat_count)
    for _ in range(4):
        z = [int.from_bytes(rng.bytes(32), "little") % bn256_fr.modulus]
        want = JPoseidonStepCircuit(j_bn256_fr, repeat_count).process_step(z, K, j_bn256_fr)
        assert PoseidonStepCircuit(bn256_fr, repeat_count).process_step(z, K, bn256_fr) == want


def _state(ivc):
    u = ivc.secondary_trace.u
    return dict(
        step=ivc.step,
        z=(list(ivc.primary_z_i), list(ivc.secondary_z_i)),
        secondary_instances=[list(i) for i in u.instances],
        secondary_W=[affine_from(c) for c in u.W_commitments],
        accs=(sangria_acc_digest(ivc.primary_relaxed.U), sangria_acc_digest(ivc.secondary_relaxed.U)),
        primary_challenges=list(ivc.primary_relaxed.U.challenges),
        pub=[[[list(i) for i in inst] for inst in insts]
             for insts in (ivc.primary_pub_instances, ivc.secondary_pub_instances)],
    )


@pytest.fixture(scope="module")
def runs():
    jpp = JPublicParams(JPoseidonStepCircuit(j_bn256_fr, repeat_count=1), JTrivialStepCircuit(arity=1), k1=K, k2=K,
                        ck1=JMockKey(J_BN256_G1), ck2=JMockKey(J_GRUMPKIN))
    jivc = JIVC(jpp, Z0_PRIMARY, Z0_SECONDARY)
    jivc.fold_step()
    pp = PublicParams(PoseidonStepCircuit(bn256_fr, repeat_count=1), TrivialStepCircuit(arity=1), K, K,
                      MockCommitmentKey(BN256_G1, "cpu"), MockCommitmentKey(GRUMPKIN, "cpu"))
    ivc = IVC(pp, Z0_PRIMARY, Z0_SECONDARY)
    ivc.fold_step()
    return dict(jpp=jpp, pp=pp, j_step=_state(jivc), ivc=ivc)


def test_public_params_match_jax(runs):
    jpp, pp = runs["jpp"], runs["pp"]
    assert (pp.primary_probe.num_cross_terms, pp.primary_probe.num_challenges) == (6, 1)
    assert (pp.secondary_probe.num_cross_terms, pp.secondary_probe.num_challenges) == (5, 0)
    for side in ("primary", "secondary"):
        assert getattr(pp, f"{side}_probe").num_cross_terms == getattr(jpp, f"{side}_probe").num_cross_terms
        assert structure_digest_stream(getattr(pp, side).S) == j_structure_digest_stream(getattr(jpp, side).S)
    assert pp.digest_coords(1) == jpp.digest_coords(1) and pp.digest_coords(2) == jpp.digest_coords(2)


def test_fold_step_matches_jax(runs):
    got = _state(runs["ivc"])
    assert got == runs["j_step"]
    assert got["step"] == 2 and len(got["primary_challenges"]) == 1


def test_verify_clean(runs):
    assert runs["ivc"].verify() == []
