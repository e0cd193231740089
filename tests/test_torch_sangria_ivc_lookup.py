"""Sangria IVC over a lookup step circuit in the port against `sirius_tpu`:
`RangeCheckStepCircuit(bn256_fr)` (byte lookups, a 2-round SPS) as the
primary and `TrivialStepCircuit(1)` as the secondary, k = 17 on both curves,
mock keys, z0 = [7] / [0] (`tests/test_sangria_ivc.py::
test_sangria_ivc_lookup_step`'s configuration).  Live: the port's public
parameters and `new` equal the JAX package's.  The port's `fold_step` from
the JAX state after `new` (carried by `util/interop.sangria_ivc_from`) equals
the JAX package's `fold_step`, held as the digest of its whole state
(`golden.sangria_ivc_digest`) frozen in `util/golden.py` with the other
`SANGRIA_IVC_RANGE_K17_*` digests (the JAX fold_step takes ~5 minutes on the
CPU, so it does not run live here; the card's smoke run holds its mock-key
run to the same digests); `verify()` is clean and reports a flipped witness
cell."""

import pytest
import torch

from sirius_tpu.curves.jpoint import BN256_G1 as J_BN256_G1
from sirius_tpu.curves.jpoint import GRUMPKIN as J_GRUMPKIN
from sirius_tpu.fields.constants import bn256_fr as j_bn256_fr
from sirius_tpu.gadgets.range_step_circuit import RangeCheckStepCircuit as JRangeCheckStepCircuit
from sirius_tpu.ivc.sangria_ivc import IVC as JIVC
from sirius_tpu.ivc.sangria_ivc import PublicParams as JPublicParams
from sirius_tpu.ivc.step_circuit import TrivialStepCircuit as JTrivialStepCircuit
from sirius_tpu.util.digest import structure_digest_stream as j_structure_digest_stream
from sirius_tpu.util.testing import MockCommitmentKey as JMockKey
from sirius_tpu_torch.curves.jpoint import BN256_G1, GRUMPKIN
from sirius_tpu_torch.fields.constants import bn256_fr
from sirius_tpu_torch.gadgets.range_step_circuit import RangeCheckStepCircuit
from sirius_tpu_torch.ivc.sangria_ivc import IVC, PublicParams
from sirius_tpu_torch.ivc.step_circuit import TrivialStepCircuit
from sirius_tpu_torch.util import golden
from sirius_tpu_torch.util.digest import structure_digest_stream
from sirius_tpu_torch.util.golden import sangria_acc_digest, sangria_ivc_digest
from sirius_tpu_torch.util.interop import affine_from, sangria_ivc_from
from sirius_tpu_torch.util.testing import MockCommitmentKey

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers

K = 17
Z0_PRIMARY, Z0_SECONDARY = [7], [0]


def _state(ivc):
    """What the two packages must agree on after new and after a step, field
    by field (a mismatch names the field)."""
    u = ivc.secondary_trace.u
    return dict(
        step=ivc.step,
        primary_z=(list(ivc.primary_z_0), list(ivc.primary_z_i)),
        secondary_z=(list(ivc.secondary_z_0), list(ivc.secondary_z_i)),
        secondary_instances=[list(i) for i in u.instances],
        secondary_W=[affine_from(c) for c in u.W_commitments],
        secondary_challenges=list(u.challenges),
        primary_acc=sangria_acc_digest(ivc.primary_relaxed.U),
        secondary_acc=sangria_acc_digest(ivc.secondary_relaxed.U),
        primary_pub=[[list(i) for i in inst] for inst in ivc.primary_pub_instances],
        secondary_pub=[[list(i) for i in inst] for inst in ivc.secondary_pub_instances],
    )


SIDES = ("primary", "secondary")


@pytest.fixture(scope="module")
def runs():
    jpp = JPublicParams(JRangeCheckStepCircuit(j_bn256_fr), JTrivialStepCircuit(arity=1), k1=K, k2=K,
                        ck1=JMockKey(J_BN256_G1), ck2=JMockKey(J_GRUMPKIN))
    jivc = JIVC(jpp, Z0_PRIMARY, Z0_SECONDARY)
    pp = PublicParams(RangeCheckStepCircuit(bn256_fr), TrivialStepCircuit(arity=1), K, K,
                      MockCommitmentKey(BN256_G1, "cpu"), MockCommitmentKey(GRUMPKIN, "cpu"))
    t_ivc = IVC(pp, Z0_PRIMARY, Z0_SECONDARY)
    t_new = dict(_state(t_ivc), digest=sangria_ivc_digest(t_ivc))
    carried = sangria_ivc_from(pp, jivc, "cpu")
    carried.fold_step()
    return dict(jpp=jpp, pp=pp, j_new=dict(_state(jivc), digest=sangria_ivc_digest(jivc)), t_new=t_new,
                t_step=_state(carried), carried=carried)


@pytest.mark.parametrize("side", SIDES)
def test_public_params_match_jax(runs, side):
    jpp, pp = runs["jpp"], runs["pp"]
    jp, tp = getattr(jpp, f"{side}_probe"), getattr(pp, f"{side}_probe")
    assert (tp.num_cross_terms, tp.num_challenges, tp.num_witness, tp.sc_instance_lens) == (
        jp.num_cross_terms, jp.num_challenges, jp.num_witness, jp.sc_instance_lens)
    assert structure_digest_stream(getattr(pp, side).S) == j_structure_digest_stream(getattr(jpp, side).S)
    which = SIDES.index(side) + 1
    assert pp.digest_coords(which) == jpp.digest_coords(which)


def test_primary_is_a_2_round_lookup_trace(runs):
    assert (runs["pp"].primary_probe.num_challenges, runs["pp"].primary_probe.num_witness) == (2, 2)


def test_new_matches_jax(runs):
    assert runs["t_new"] == runs["j_new"]


def test_carried_state_fold_step_matches_the_frozen_jax_state(runs):
    assert sangria_ivc_digest(runs["carried"]) == golden.SANGRIA_IVC_RANGE_K17_STEP_STATE


def test_frozen_digests_equal_this_run(runs):
    pp, new, step = runs["pp"], runs["t_new"], runs["t_step"]
    assert step["step"] == 2
    assert pp.digest_coords(1) == golden.SANGRIA_IVC_RANGE_K17_PP_DIGEST_1
    assert pp.digest_coords(2) == golden.SANGRIA_IVC_RANGE_K17_PP_DIGEST_2
    assert new["digest"] == golden.SANGRIA_IVC_RANGE_K17_NEW_STATE
    assert (new["primary_acc"], new["secondary_acc"]) == golden.SANGRIA_IVC_RANGE_K17_NEW
    assert (step["primary_acc"], step["secondary_acc"]) == golden.SANGRIA_IVC_RANGE_K17_STEP
    assert step["primary_z"][1] == [golden.SANGRIA_IVC_RANGE_K17_Z]


def test_verify_clean_and_catches_a_flipped_witness_cell(runs):
    ivc = runs["carried"]
    assert ivc.verify() == []
    W1 = ivc.primary_relaxed.W.W[1]  # the lookup round
    saved = W1[7].clone()
    W1[7, 0] ^= 1
    try:
        errors = ivc.verify()
    finally:
        W1[7] = saved
    assert any(e.startswith("primary:") for e in errors), errors
