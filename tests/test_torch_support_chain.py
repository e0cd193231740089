"""The slice as a whole: a 2-fold Cyclefold support-fold chain at k = 14
(`sirius_tpu/ivc/cyclefold_ivc.py:693-714`) run in the port and in
`sirius_tpu` on the same inputs (each package builds them from its own gold
model), both on the mock commitment key; they must give the same
accumulator digest and the same witness tensors."""

import numpy as np
import torch

from sirius_tpu.curves.jpoint import GRUMPKIN as J_GRUMPKIN
from sirius_tpu.fields import gold as jgold
from sirius_tpu.fields.constants import bn256_fq, bn256_fr, bn256_g1, grumpkin
from sirius_tpu.frontend.runner import CircuitRunner as JRunner
from sirius_tpu.ivc import support_circuit as jsc
from sirius_tpu.ivc.sangria_ivc import default_ro_spec as j_default_ro_spec
from sirius_tpu.nifs import sangria as jsg
from sirius_tpu.ops.poseidon import PoseidonHash as JPoseidonHash
from sirius_tpu.plonk.sps import run_sps_protocol as j_run_sps
from sirius_tpu.util.golden import sangria_acc_digest
from sirius_tpu.util.testing import MockCommitmentKey as JMockKey
from sirius_tpu_torch.curves.jpoint import GRUMPKIN
from sirius_tpu_torch.fields import constants as tconst
from sirius_tpu_torch.fields import gold as tgold
from sirius_tpu_torch.ivc import support_circuit as tsc
from sirius_tpu_torch.ivc.support_fold import SupportFoldChain, support_structure
from sirius_tpu_torch.nifs.sangria import RelaxedPlonkInstance, RelaxedPlonkTrace, RelaxedPlonkWitness
from sirius_tpu_torch.util.interop import affine_from, witness_to_numpy, witness_to_torch
from sirius_tpu_torch.util.testing import MockCommitmentKey

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers

SUPPORT_CHAIN_2FOLD_DIGEST = "7efbd668a8a34ccb0d5ae7edb889d33e0f2d7040e7731baf941da387e5e7bdaf"


def _support_inputs(gold, sc, g1):
    G = gold.generator(g1)
    return [sc.InstanceInput(G.mul(12345 + i), G.mul(67890 + i), 2**250 + 17 + i, 2**251 + 99 + i) for i in range(2)]


def _port_instance(U) -> RelaxedPlonkInstance:
    """A JAX RelaxedPlonkInstance carried into the port by value."""
    return RelaxedPlonkInstance([affine_from(c) for c in U.W_commitments], list(U.consistency_markers),
                                list(U.challenges), affine_from(U.E_commitment), U.u, U.sc_instances_hash_acc)


def _jax_support_chain():
    sup_inp = jsc.InstanceInput(jgold.identity(bn256_g1), jgold.identity(bn256_g1), 0, 0)
    S = JRunner(14, bn256_fq, jsc.SupportCircuit(sup_inp, num_bits=bn256_fr.num_bits),
                [sup_inp.into_instance(bn256_fq.modulus)]).collect_plonk_structure()
    ck = JMockKey(J_GRUMPKIN)
    pp, _ = jsg.VanillaFS.setup_params(jgold.identity(grumpkin), S)
    f = S.field
    acc = jsg.RelaxedPlonkTrace(
        U=jsg.RelaxedPlonkInstance.new(grumpkin, 0, 1, 0, markers_len=8),
        W=jsg.RelaxedPlonkWitness([f.zeros((sz,)) for sz in S.round_sizes], f.zeros((S.n,))),
    )
    for inp in _support_inputs(jgold, jsc, bn256_g1):
        instances = [inp.into_instance(bn256_fq.modulus)]
        W = JRunner(14, bn256_fq, jsc.SupportCircuit(inp, num_bits=bn256_fr.num_bits), instances).collect_witness()
        trace = j_run_sps(S, ck, instances, W, JPoseidonHash(j_default_ro_spec(bn256_fr)))
        acc, _ = jsg.VanillaFS.prove(ck, pp, JPoseidonHash(j_default_ro_spec(bn256_fr)), acc, trace)
    return acc


def test_support_chain_two_folds_matches_jax():
    chain = SupportFoldChain(MockCommitmentKey(GRUMPKIN, "cpu"), *support_structure())
    for inp in _support_inputs(tgold, tsc, tconst.bn256_g1):
        chain.fold(inp)
    jacc = _jax_support_chain()
    assert sangria_acc_digest(chain.acc.U) == sangria_acc_digest(jacc.U) == SUPPORT_CHAIN_2FOLD_DIGEST
    # the witness state carried across: identical W rounds and error vector
    for t, j in zip(witness_to_numpy([*chain.acc.W.W, chain.acc.W.E]), [*jacc.W.W, jacc.W.E]):
        assert np.array_equal(t, np.asarray(j))
    assert chain.verify() == chain.acc.U
    assert chain.is_sat() == []
    # the JAX accumulator handed to the port satisfies the port's checks
    carried = RelaxedPlonkTrace(_port_instance(jacc.U), RelaxedPlonkWitness(witness_to_torch(jacc.W.W, "cpu"),
                                                                            witness_to_torch([jacc.W.E], "cpu")[0]))
    assert chain.is_sat(carried) == []
