"""The slice as a whole: `CyclefoldIVC` new -> next at k = 17 on the trivial
step circuit (`bench.py:166-210`'s main path, on the mock keys of both
packages) in the port and in `sirius_tpu`.  Both must agree on the pp
digest, z_i, the primary trace's instances and W commitments and both
accumulators' digests, from `new` and from the JAX state carried into the
port after `new` (`util/interop.cyclefold_ivc_from`).  The port's `verify()`
is clean and reports a corrupted accumulator.  In a file of its own: the
JAX run and the port's two steps take minutes on the CPU."""

import pytest
import torch

from sirius_tpu.curves.jpoint import BN256_G1 as J_BN256_G1
from sirius_tpu.curves.jpoint import GRUMPKIN as J_GRUMPKIN
from sirius_tpu.ivc.cyclefold_ivc import CyclefoldIVC as JCyclefoldIVC
from sirius_tpu.ivc.cyclefold_ivc import CyclefoldPublicParams as JCyclefoldPublicParams
from sirius_tpu.ivc.step_circuit import TrivialStepCircuit as JTrivialStepCircuit
from sirius_tpu.nifs.protogalaxy import AccumulatorInstance as JAccumulatorInstance
from sirius_tpu.util.testing import MockCommitmentKey as JMockKey
from sirius_tpu_torch.curves.jpoint import BN256_G1, GRUMPKIN
from sirius_tpu_torch.ivc.cyclefold_ivc import CyclefoldIVC, CyclefoldPublicParams
from sirius_tpu_torch.ivc.step_circuit import TrivialStepCircuit
from sirius_tpu_torch.nifs.protogalaxy import AccumulatorInstance
from sirius_tpu_torch.util.golden import pg_acc_digest, sangria_acc_digest
from sirius_tpu_torch.util.interop import affine_from, cyclefold_ivc_from
from sirius_tpu_torch.util.testing import MockCommitmentKey

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers

K = 17
Z0 = [0x42]


def _state(ivc):
    """What the two packages must agree on after a step."""
    u = ivc.primary_trace.u
    return dict(
        step=ivc.step,
        z_i=list(ivc.z_i),
        instances=[list(i) for i in u.instances],
        W=[affine_from(c) for c in u.W_commitments],
        challenges=list(u.challenges),
        pg=pg_acc_digest(AccumulatorInstance.from_acc(ivc.self_acc)
                         if isinstance(ivc, CyclefoldIVC) else JAccumulatorInstance.from_acc(ivc.self_acc)),
        support=sangria_acc_digest(ivc.support_acc.U),
        support_instances=[[list(i) for i in inst] for inst in ivc.support_pub_instances],
    )


@pytest.fixture(scope="module")
def runs():
    jpp = JCyclefoldPublicParams(JTrivialStepCircuit(arity=1), k=K, ck_primary=JMockKey(J_BN256_G1),
                                 ck_support=JMockKey(J_GRUMPKIN))
    jivc = JCyclefoldIVC(jpp, Z0)
    j_new = _state(jivc)
    pp = CyclefoldPublicParams(TrivialStepCircuit(arity=1), K, MockCommitmentKey(BN256_G1, "cpu"),
                               MockCommitmentKey(GRUMPKIN, "cpu"))
    carried = cyclefold_ivc_from(pp, jivc, "cpu")  # before the JAX step moves on
    jivc.next()
    ivc = CyclefoldIVC(pp, Z0)
    t_new = _state(ivc)
    ivc.next()
    return dict(jpp=jpp, pp=pp, j_new=j_new, j_next=_state(jivc), t_new=t_new, ivc=ivc, carried=carried)


from sirius_tpu_torch.util.testing import MockCommitmentKey  # noqa: E402


def test_new_then_next_matches_jax(runs):
    assert runs["pp"].digest_hex() == runs["jpp"].digest_hex()
    assert runs["t_new"] == runs["j_new"]
    got = _state(runs["ivc"])
    assert got == runs["j_next"]
    assert got["step"] == 2 and got["z_i"] == Z0


def test_carried_state_next_matches_jax(runs):
    carried = runs["carried"]
    assert _state(carried) == runs["j_new"]
    carried.next()
    assert _state(carried) == runs["j_next"]


def test_verify_clean_and_catches_a_corrupted_accumulator(runs):
    ivc = runs["ivc"]
    assert ivc.verify() == []
    W0 = ivc.self_acc.trace.w.W[0]
    saved = W0[7].clone()
    W0[7, 0] ^= 1
    try:
        errors = ivc.verify()
    finally:
        W0[7] = saved
    assert any(e.startswith("pg:") for e in errors), errors
