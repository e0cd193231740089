"""Sangria IVC in the port against `sirius_tpu`: the consistency markers on
both curves, the relaxation helpers, and the trivial step circuit on both
sides at k = 16 on the mock keys of both packages (public parameters, new,
one `fold_step`, a `fold_step` from the JAX state carried into the port by
`util/interop.sangria_ivc_from`, verify).  The frozen digests of
`util/golden.py` must equal this run.  In a file of its own: the JAX
package's new -> fold_step takes about a minute on the CPU, the port's two
fold_steps about as long each."""

import numpy as np
import pytest
import torch

from sirius_tpu.curves.jpoint import BN256_G1 as J_BN256_G1
from sirius_tpu.curves.jpoint import GRUMPKIN as J_GRUMPKIN
from sirius_tpu.fields import gold as jgold
from sirius_tpu.fields.jfield import field_for as j_field_for
from sirius_tpu.ivc import consistency_markers as jcm
from sirius_tpu.ivc.sangria_ivc import IVC as JIVC
from sirius_tpu.ivc.sangria_ivc import PublicParams as JPublicParams
from sirius_tpu.ivc.sangria_ivc import default_ro_spec as j_default_ro_spec
from sirius_tpu.ivc.step_circuit import TrivialStepCircuit as JTrivialStepCircuit
from sirius_tpu.nifs import sangria as jsg
from sirius_tpu.plonk.structure import PlonkInstance as JPlonkInstance
from sirius_tpu.plonk.structure import PlonkWitness as JPlonkWitness
from sirius_tpu.util.digest import structure_digest_stream as j_structure_digest_stream
from sirius_tpu.util.testing import MockCommitmentKey as JMockKey
from sirius_tpu_torch.curves.jpoint import BN256_G1, GRUMPKIN
from sirius_tpu_torch.fields import constants as tconst
from sirius_tpu_torch.fields import gold as tgold
from sirius_tpu_torch.fields.jfield import field_for
from sirius_tpu_torch.ivc import consistency_markers as tcm
from sirius_tpu_torch.ivc.sangria_ivc import IVC, PublicParams
from sirius_tpu_torch.ivc.step_circuit import TrivialStepCircuit
from sirius_tpu_torch.nifs.sangria import RelaxedPlonkInstance, RelaxedPlonkWitness, SangriaError
from sirius_tpu_torch.plonk.structure import PlonkWitness
from sirius_tpu_torch.util import golden
from sirius_tpu_torch.util.digest import structure_digest_stream
from sirius_tpu_torch.util.golden import sangria_acc_digest
from sirius_tpu_torch.util.interop import (
    affine_from,
    plonk_instance_from,
    relaxed_instance_from,
    sangria_ivc_from,
    witness_to_numpy,
    witness_to_torch,
)
from sirius_tpu_torch.util.ro import default_ro_spec
from sirius_tpu_torch.util.testing import MockCommitmentKey

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers

K = 16
Z0_PRIMARY, Z0_SECONDARY = [0x11], [0x22]
R = tconst.bn256_fr.modulus  # < Q: values in [R, Q) reduce when cast from Fq to Fr
Q = tconst.bn256_fq.modulus


def _curves(name):
    """(JAX spec, port spec) of a curve by name."""
    from sirius_tpu.fields import constants as jconst

    return getattr(jconst, name), getattr(tconst, name)


def _random_relaxed(name: str, seed: int, with_acc: bool):
    """The same random relaxed instance in both packages: 2 W commitments, 2
    markers, 2 challenges, u and (optionally) an sc-hash accumulator, half of
    the scalars drawn in [R, Q) (at or above the smaller modulus)."""
    jspec, tspec = _curves(name)
    rng = np.random.default_rng(seed)

    def scalar(i):
        lo = R if i % 2 else 0
        return lo + int.from_bytes(rng.bytes(32), "little") % (Q - lo)

    ks = [scalar(i) % tspec.scalar.modulus or 1 for i in range(3)]
    vals = [scalar(i) for i in range(6)]
    acc = scalar(1) if with_acc else None

    def build(gold, spec, cls):
        pts = [gold.generator(spec).mul(k) for k in ks]
        return cls(pts[:2], vals[:2], vals[2:4], pts[2], vals[4], acc)

    return build(jgold, jspec, jsg.RelaxedPlonkInstance), build(tgold, tspec, RelaxedPlonkInstance)


@pytest.mark.parametrize("with_acc", [False, True])
@pytest.mark.parametrize("name", ["bn256_g1", "grumpkin"])
def test_consistency_marker_matches_jax(name, with_acc):
    jU, tU = _random_relaxed(name, 1 + with_acc + 2 * (name == "grumpkin"), with_acc)
    jspec, tspec = _curves(name)
    for step in (0, 1, 7):
        j_pp = jgold.generator(jspec).mul(1000 + step)
        t_pp = tgold.generator(tspec).mul(1000 + step)
        z0, zi = [R + 5, 3], [Q - 1, 2**200]
        want = jcm.generate_consistency_marker(j_default_ro_spec(jspec.base), jspec, j_pp, step, z0, zi, jU)
        got = tcm.generate_consistency_marker(default_ro_spec(tspec.base), tspec, t_pp, step, z0, zi, tU)
        assert got == want
        assert got < tspec.scalar.modulus
    for v in (0, R - 1, R + 12345, Q - 1, 2**256 - 1):
        assert tcm.scalar_to_limbs(v) == jcm.scalar_to_limbs(v)


def test_from_instance_and_clone_match_jax():
    jspec, tspec = _curves("grumpkin")
    pts = [8, 9]
    markers, sc_cols, challenges = [R + 3, 17], [[5, Q - 2], [R + 1]], [123]
    ju = JPlonkInstance([jgold.generator(jspec).mul(k) for k in pts], [markers, *sc_cols], challenges)
    tu = plonk_instance_from(ju)
    for instances in (ju.instances, ju.instances[:1]):  # with and without step-circuit columns
        ju.instances = instances
        tu.instances = [list(i) for i in instances]
        want = relaxed_instance_from(jsg.RelaxedPlonkInstance.from_instance(jspec, ju))
        got = RelaxedPlonkInstance.from_instance(tspec, tu)
        assert got == want
        c = got.clone()
        assert c == got and c.W_commitments is not got.W_commitments
        c.consistency_markers[0] = 0
        assert got.consistency_markers[0] == R + 3
    tu.instances = [[1, 2, 3]]
    with pytest.raises(SangriaError):
        RelaxedPlonkInstance.from_instance(tspec, tu)


def test_from_regular_matches_jax():
    rng = np.random.default_rng(5)
    k = 4
    rows = rng.integers(0, 1 << 16, size=(3 << k, 16), dtype=np.uint32)
    rows[:, 15] &= 0x0FFF
    jw = jsg.RelaxedPlonkWitness.from_regular(JPlonkWitness([rows]), k, j_field_for(_curves("grumpkin")[0].scalar))
    tw = RelaxedPlonkWitness.from_regular(PlonkWitness(witness_to_torch([rows], "cpu")), k,
                                          field_for(tconst.bn256_fq))
    for got, want in zip(witness_to_numpy([*tw.W, tw.E]), [*jw.W, jw.E]):
        assert np.array_equal(got, np.asarray(want))
    assert tw.E.shape == (1 << k, 8) and tw.E.device == tw.W[0].device


def test_generate_plonk_trace_checks_the_markers_column():
    from fixtures import FiboCircuit
    from sirius_tpu_torch.frontend.runner import CircuitRunner
    from sirius_tpu_torch.nifs.sangria import VanillaFS
    from sirius_tpu_torch.ops.poseidon import PoseidonHash
    from sirius_tpu_torch.plonk.sps import run_sps_protocol

    c = FiboCircuit(1, 1, 10)
    inst = c.instances(R)  # one column of two values, as the markers are
    runner = CircuitRunner(4, tconst.bn256_fr, c, inst)
    S, W = runner.collect_plonk_structure(), runner.collect_witness()
    ck = MockCommitmentKey(BN256_G1, "cpu")
    pp, _ = VanillaFS.setup_params(tgold.identity(tconst.bn256_g1), S)
    ro = lambda: PoseidonHash(default_ro_spec(tconst.bn256_fq))  # noqa: E731
    tr = VanillaFS.generate_plonk_trace(ck, inst, W, pp, ro())
    assert tr.u == run_sps_protocol(S, ck, inst, W, ro()).u and len(tr.u.challenges) == 1
    with pytest.raises(SangriaError):
        VanillaFS.generate_plonk_trace(ck, inst, W, pp, ro(), markers_len=3)


def _state(ivc):
    """What the two packages must agree on after new and after a step."""
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


@pytest.fixture(scope="module")
def runs():
    jpp = JPublicParams(JTrivialStepCircuit(arity=1), JTrivialStepCircuit(arity=1), k1=K, k2=K,
                        ck1=JMockKey(J_BN256_G1), ck2=JMockKey(J_GRUMPKIN))
    jivc = JIVC(jpp, Z0_PRIMARY, Z0_SECONDARY)
    j_new = _state(jivc)
    pp = PublicParams(TrivialStepCircuit(arity=1), TrivialStepCircuit(arity=1), K, K,
                      MockCommitmentKey(BN256_G1, "cpu"), MockCommitmentKey(GRUMPKIN, "cpu"))
    carried = sangria_ivc_from(pp, jivc, "cpu")  # before the JAX step moves on
    jivc.fold_step()
    ivc = IVC(pp, Z0_PRIMARY, Z0_SECONDARY)
    t_new = _state(ivc)
    ivc.fold_step()
    return dict(jpp=jpp, pp=pp, j_new=j_new, j_step=_state(jivc), t_new=t_new, ivc=ivc, carried=carried)


def test_public_params_match_jax(runs):
    jpp, pp = runs["jpp"], runs["pp"]
    for side in ("primary", "secondary"):
        jp, tp = getattr(jpp, f"{side}_probe"), getattr(pp, f"{side}_probe")
        assert (tp.num_cross_terms, tp.num_challenges, tp.num_witness, tp.sc_instance_lens) == (
            jp.num_cross_terms, jp.num_challenges, jp.num_witness, jp.sc_instance_lens)
        assert structure_digest_stream(getattr(pp, side).S) == j_structure_digest_stream(getattr(jpp, side).S)
    assert pp.primary_probe.num_cross_terms == 5 and pp.primary_probe.num_challenges == 0
    assert affine_from(jpp.digest_1) == pp.digest_1 and affine_from(jpp.digest_2) == pp.digest_2
    assert pp.digest_coords(1) == jpp.digest_coords(1) and pp.digest_coords(2) == jpp.digest_coords(2)
    j_pre, t_pre = jpp.secondary_initial_plonk_trace, pp.secondary_initial_plonk_trace
    assert plonk_instance_from(j_pre.u) == t_pre.u


def test_new_then_fold_step_match_jax(runs):
    assert runs["t_new"] == runs["j_new"]
    got = _state(runs["ivc"])
    assert got == runs["j_step"]
    assert got["step"] == 2 and got["primary_z"] == (Z0_PRIMARY, Z0_PRIMARY)


def test_carried_state_fold_step_matches_jax(runs):
    carried = runs["carried"]
    assert _state(carried) == runs["j_new"]
    carried.fold_step()
    assert _state(carried) == runs["j_step"]


def test_verify_clean_and_catches_a_flipped_witness_cell(runs):
    ivc = runs["ivc"]
    assert ivc.verify() == []
    W0 = ivc.primary_relaxed.W.W[0]
    saved = W0[7].clone()
    W0[7, 0] ^= 1
    try:
        errors = ivc.verify()
    finally:
        W0[7] = saved
    assert any(e.startswith("primary:") for e in errors), errors


def test_frozen_digests_equal_this_run(runs):
    pp = runs["pp"]
    assert pp.digest_coords(1) == golden.SANGRIA_IVC_K16_PP_DIGEST_1
    assert pp.digest_coords(2) == golden.SANGRIA_IVC_K16_PP_DIGEST_2
    assert (runs["t_new"]["primary_acc"], runs["t_new"]["secondary_acc"]) == golden.SANGRIA_IVC_K16_NEW
    step = _state(runs["ivc"])
    assert (step["primary_acc"], step["secondary_acc"]) == golden.SANGRIA_IVC_K16_STEP
