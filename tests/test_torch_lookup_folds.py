"""Folds over lookup traces in the port (`sirius_tpu_torch/nifs/{sangria,
protogalaxy}.py`): Sangria's folds over 2-round traces
(`tests/test_lookup.py::test_fold_with_lookup`) and ProtoGalaxy's L = 1 fold
over the fibo-xor 3-round trace
(`tests/test_protogalaxy.py::test_protogalaxy_fibo_lookup_L1`), held against
digests frozen from the JAX package.

The frozen digests (`sirius_tpu_torch/util/golden.py`, `LOOKUP_*`) were
made once with the JAX package on the CPU, running those two tests' flows
as they run them (the same circuits, keys and transcripts) and taking
`sangria_acc_digest` after each fold, `pg_acc_digest` of the new and the
folded accumulator (the verifier's instance gave the same) and
`plonk_trace_digest` of the fibo-xor trace; the L1 case alone costs ~100 s
of JAX time, so neither flow runs live here.
"""

import torch

from sirius_tpu_torch.curves.jpoint import BN256_G1
from sirius_tpu_torch.fields import gold
from sirius_tpu_torch.fields.constants import bn256_fq, bn256_fr, bn256_g1
from sirius_tpu_torch.frontend.runner import CircuitRunner
from sirius_tpu_torch.nifs.protogalaxy import AccumulatorInstance, ProtoGalaxy, evaluate_e_from_trace
from sirius_tpu_torch.nifs.sangria import RelaxedPlonkInstance, RelaxedPlonkTrace, RelaxedPlonkWitness, VanillaFS
from sirius_tpu_torch.ops.commitment import CommitmentKey
from sirius_tpu_torch.ops.poseidon import PoseidonHash, poseidon_spec
from sirius_tpu_torch.plonk.sps import run_sps_protocol
from sirius_tpu_torch.util import golden
from sirius_tpu_torch.util.golden import pg_acc_digest, plonk_trace_digest, sangria_acc_digest
from sirius_tpu_torch.util.testing import FiboXorLookupCircuit, RangeCircuit

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers


def _ro():
    return PoseidonHash(poseidon_spec(bn256_fq, 3, 2, 4, 3))


def _trace(circuit, ck, ro):
    runner = CircuitRunner(5, bn256_fr, circuit, circuit.instances())
    S = runner.collect_plonk_structure()
    return S, run_sps_protocol(S, ck, circuit.instances(), runner.collect_witness(), ro)


def test_sangria_folds_over_lookup_traces_match_the_frozen_jax_digests():
    """tests/test_lookup.py::test_fold_with_lookup in the port."""
    ck = CommitmentKey.setup(BN256_G1, 9, b"lookup-test", use_cache=False, device="cpu")
    ro = _ro()
    S, tr1 = _trace(RangeCircuit([3, 7, 15]), ck, ro)
    _, tr2 = _trace(RangeCircuit([1, 2, 4, 8]), ck, ro)
    pp, vp = VanillaFS.setup_params(gold.identity(bn256_g1), S)
    f = S.field
    zero_W = RelaxedPlonkWitness([f.zeros((sz,), "cpu") for sz in S.round_sizes], f.zeros((S.n,), "cpu"))
    acc = RelaxedPlonkTrace(RelaxedPlonkInstance.new(bn256_g1, S.num_challenges, len(S.round_sizes), 0), zero_W)
    ro_p, ro_v, ro_n = _ro(), _ro(), _ro()
    for step, tr in enumerate([tr1, tr2]):
        new_acc, cts = VanillaFS.prove(ck, pp, ro_p, acc, tr)
        assert VanillaFS.verify(vp, bn256_g1, ro_n, ro_v, acc.U, tr.u, cts) == new_acc.U
        acc = new_acc
        assert sangria_acc_digest(acc.U) == golden.LOOKUP_SANGRIA_FOLDS[step]
    assert VanillaFS.is_sat(ck, S, acc, [tr1.u.instances, tr2.u.instances]) == []


def test_protogalaxy_fibo_xor_lookup_L1_matches_the_frozen_jax_digests():
    """tests/test_protogalaxy.py::test_protogalaxy_fibo_lookup_L1 in the port."""
    pck = CommitmentKey.setup(BN256_G1, 7, b"pg-test", use_cache=False, device="cpu")
    pg_ro = lambda: PoseidonHash(poseidon_spec(bn256_fr, 3, 2, 4, 3))  # noqa: E731
    c = FiboXorLookupCircuit(1, 2, 8)
    inst = c.instances()
    runner = CircuitRunner(4, bn256_fr, c, inst)
    S = runner.collect_plonk_structure()
    assert S.num_challenges == 3
    tr = run_sps_protocol(S, pck, inst, runner.collect_witness(), pg_ro())
    assert plonk_trace_digest([w.numpy() for w in tr.w.W], tr.u) == golden.LOOKUP_PG_FIBO_XOR_TRACE
    pp, vp = ProtoGalaxy.setup_params(gold.identity(bn256_g1), S)
    acc = ProtoGalaxy.new_accumulator(pp, pg_ro(), tr, bn256_g1)
    assert pg_acc_digest(AccumulatorInstance.from_acc(acc)) == golden.LOOKUP_PG_FIBO_XOR_NEW
    assert evaluate_e_from_trace(S, acc.trace, acc.betas) == acc.e
    new_acc, proof = ProtoGalaxy.prove(pck, pp, pg_ro(), acc, [tr])
    assert pg_acc_digest(AccumulatorInstance.from_acc(new_acc)) == golden.LOOKUP_PG_FIBO_XOR_L1
    assert ProtoGalaxy.is_sat(pck, S, new_acc) == []
    ver = ProtoGalaxy.verify(vp, bn256_fr, pg_ro(), pg_ro(), AccumulatorInstance.from_acc(acc), [tr.u], proof)
    assert ver == AccumulatorInstance.from_acc(new_acc)
