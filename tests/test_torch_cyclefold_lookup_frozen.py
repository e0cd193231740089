"""Cyclefold IVC of the port over a lookup step circuit, held against
digests frozen from the JAX package (`sirius_tpu_torch/util/golden.py`,
`CYCLEFOLD_XOR_LOOKUP_K18_*`, made by `tests/freeze_ivc_digests.py
xor_lookup`; the JAX run takes minutes, so it does not run live here):
`XorLookupStepCircuit(key=3)` (3 W commitments, so 3 chained support folds a
`next`) at k = 18, mock keys, z0 = [2]: the pp digest, the ProtoGalaxy and
support accumulators' digests and the pending trace's (every W round's
words, the commitments, instances and challenges) after `new` and after one
`next`, z after each, then `verify()` clean and a flipped cell of the
pending trace (an advice cell, an h cell) reported.
"""

import pytest
import torch

from sirius_tpu_torch.curves.jpoint import BN256_G1, GRUMPKIN
from sirius_tpu_torch.gadgets.xor_lookup_step_circuit import XorLookupStepCircuit
from sirius_tpu_torch.ivc.cyclefold_ivc import CyclefoldIVC, CyclefoldPublicParams
from sirius_tpu_torch.util import golden
from sirius_tpu_torch.util.golden import cyclefold_digests
from sirius_tpu_torch.util.testing import MockCommitmentKey

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers


def _cyclefold_digests(ivc):
    return cyclefold_digests(ivc, [w.numpy() for w in ivc.primary_trace.w.W])


@pytest.fixture(scope="module")
def run():
    pp = CyclefoldPublicParams(XorLookupStepCircuit(key=3), 18, MockCommitmentKey(BN256_G1, "cpu"),
                               MockCommitmentKey(GRUMPKIN, "cpu"))
    ivc = CyclefoldIVC(pp, [2])
    new = dict(z=list(ivc.z_i), digests=_cyclefold_digests(ivc))
    ivc.next()
    return dict(pp=pp, ivc=ivc, new=new, next=dict(z=list(ivc.z_i), digests=_cyclefold_digests(ivc)))


def test_public_params_match_the_frozen_digest(run):
    assert run["pp"].digest_hex() == golden.CYCLEFOLD_XOR_LOOKUP_K18_PP


def test_primary_is_a_3_round_lookup_trace(run):
    assert (run["pp"].num_witness_primary, run["pp"].num_challenges_primary) == (3, 3)
    assert run["pp"].S_primary.round_sizes == [10 << 18, 3 << 18, 2 << 18]


def test_new_matches_the_frozen_digests_and_z(run):
    assert run["new"]["digests"] == golden.CYCLEFOLD_XOR_LOOKUP_K18_NEW
    assert run["new"]["z"] == [2 ^ 3]


def test_next_matches_the_frozen_digests_and_z(run):
    assert run["next"]["digests"] == golden.CYCLEFOLD_XOR_LOOKUP_K18_NEXT
    assert run["next"]["z"] == [2 ^ 3 ^ 3]


def test_next_delegates_one_support_fold_per_w_commitment(run):
    assert run["ivc"].step == 2
    assert len(run["ivc"].support_pub_instances) == 3


def test_verify_is_clean(run):
    assert run["ivc"].verify() == []


@pytest.mark.parametrize("round_index", [0, 2], ids=["advice", "lookup_h_g"])
def test_verify_catches_a_flipped_cell_of_the_pending_trace(run, round_index):
    W = run["ivc"].primary_trace.w.W[round_index]
    saved = W[7].clone()
    W[7, 0] ^= 1
    try:
        errors = run["ivc"].verify()
    finally:
        W[7] = saved
    assert errors, "a flipped cell of the pending trace went unreported"
