"""Sangria IVC of the port over a vector-lookup step circuit, held against
digests frozen from the JAX package (`sirius_tpu_torch/util/golden.py`,
`SANGRIA_IVC_XOR_K17_*`, made by `tests/freeze_ivc_digests.py sangria_xor`;
the JAX run takes minutes, so it does not run live here):
`XorStepCircuit(bn256_fr)` (a 3-round SPS: 3 W commitments and 3
challenges on the primary) and `TrivialStepCircuit(1)`, k = 17 on both
curves, mock keys, z0 = [5] / [0]: the pp digest points and both
accumulators' digests after `new` and after one `fold_step`, z, then
`verify()` clean.  The Cyclefold counterpart is
`test_torch_cyclefold_lookup_frozen.py`.
"""

import pytest
import torch

from sirius_tpu_torch.curves.jpoint import BN256_G1, GRUMPKIN
from sirius_tpu_torch.fields.constants import bn256_fr
from sirius_tpu_torch.gadgets.xor_step_circuit import XorStepCircuit
from sirius_tpu_torch.ivc.sangria_ivc import IVC, PublicParams
from sirius_tpu_torch.ivc.step_circuit import TrivialStepCircuit
from sirius_tpu_torch.util import golden
from sirius_tpu_torch.util.golden import sangria_acc_digest
from sirius_tpu_torch.util.testing import MockCommitmentKey

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers


@pytest.fixture(scope="module")
def run():
    pp = PublicParams(XorStepCircuit(bn256_fr), TrivialStepCircuit(arity=1), 17, 17,
                      MockCommitmentKey(BN256_G1, "cpu"), MockCommitmentKey(GRUMPKIN, "cpu"))
    ivc = IVC(pp, [5], [0])
    digests = lambda: (sangria_acc_digest(ivc.primary_relaxed.U), sangria_acc_digest(ivc.secondary_relaxed.U))  # noqa: E731
    new = digests()
    ivc.fold_step()
    return dict(pp=pp, ivc=ivc, new=new, step=digests())


def test_primary_is_a_3_round_lookup_trace(run):
    assert (run["pp"].primary_probe.num_challenges, run["pp"].primary_probe.num_witness) == (3, 3)


def test_pp_digests_match_the_frozen_ones(run):
    assert run["pp"].digest_coords(1) == golden.SANGRIA_IVC_XOR_K17_PP_DIGEST_1
    assert run["pp"].digest_coords(2) == golden.SANGRIA_IVC_XOR_K17_PP_DIGEST_2


def test_new_matches_the_frozen_digests(run):
    assert run["new"] == golden.SANGRIA_IVC_XOR_K17_NEW


def test_fold_step_matches_the_frozen_digests_and_z(run):
    assert run["step"] == golden.SANGRIA_IVC_XOR_K17_STEP
    assert run["ivc"].primary_z_i == [golden.SANGRIA_IVC_XOR_K17_Z]


def test_verify_is_clean(run):
    assert run["ivc"].verify() == []
