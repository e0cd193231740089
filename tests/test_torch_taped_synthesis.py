"""The witness tape in both IVC drivers, on the CPU with mock keys.

For the trivial Cyclefold SFC (k = 17), the support circuit, both Sangria
SFCs (K = 16) and the depth-32 Merkle step's Cyclefold SFC (batch 1,
stateful): the port's tape equals the JAX package's op for op, the port's
flatteners equal the JAX package's on the dry inputs, and on seeded random
inputs the port's native replay equals the port's direct synthesis and the
JAX package's replay word for word.  After pp, no driver step synthesizes
directly (`CircuitRunner.collect_witness` raises under a monkeypatch), and
`Field.to_mont_words` and the SPS's packed-word upload equal the host
encoding.  No live JAX `next`: the JAX package's traced pp costs ~5 s at
k = 17 here, its steps minutes."""

import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sirius_tpu.curves.jpoint import BN256_G1 as J_BN256_G1
from sirius_tpu.curves.jpoint import GRUMPKIN as J_GRUMPKIN
from sirius_tpu.fields import gold as jgold
from sirius_tpu.gadgets.merkle_step_circuit import MerkleStepCircuit as JMerkleStepCircuit
from sirius_tpu.ivc import cyclefold_ivc as jcf
from sirius_tpu.ivc import sangria_ivc as jsg
from sirius_tpu.ivc.step_circuit import TrivialStepCircuit as JTrivialStepCircuit
from sirius_tpu.ivc.support_circuit import InstanceInput as JInstanceInput
from sirius_tpu.util.testing import MockCommitmentKey as JMockKey
from sirius_tpu_torch.curves.jpoint import BN256_G1, GRUMPKIN
from sirius_tpu_torch.fields import gold
from sirius_tpu_torch.fields.constants import bn256_fq, bn256_fr, bn256_g1
from sirius_tpu_torch.fields.jfield import FQ, FR, ints_to_words
from sirius_tpu_torch.frontend.runner import CircuitRunner
from sirius_tpu_torch.frontend.taped import ReplayedWitness
from sirius_tpu_torch.gadgets.merkle_step_circuit import MerkleStepCircuit
from sirius_tpu_torch.ivc import cyclefold_ivc as tcf
from sirius_tpu_torch.ivc import sangria_ivc as tsg
from sirius_tpu_torch.ivc.step_circuit import TrivialStepCircuit
from sirius_tpu_torch.ivc.support_circuit import InstanceInput
from sirius_tpu_torch.ivc.support_fold import SupportFoldChain, _sup_flatten
from sirius_tpu_torch.plonk.sps import concat_with_padding
from sirius_tpu_torch.util.testing import MockCommitmentKey

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers

K_CF = 17
K_SG = 16


def _leaves(seed: int):
    """A leaf source for the `_*_pack` walks: seeded 253-bit values, below
    both bn256 moduli."""
    rng = random.Random(seed)
    return lambda v: rng.getrandbits(253)


def _words(cols) -> list[np.ndarray]:
    """Direct synthesis's int columns as (n, 8) u32 word arrays."""
    return [ints_to_words(col).astype(np.uint32) for col in cols]


def _same_tape(mine, theirs):
    for a, b in zip(mine.tape._finalize(), theirs.tape._finalize()):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.array_equal(mine._out_slots, theirs._out_slots)


def _same_replay(W, named, jW, jnamed):
    assert isinstance(W, ReplayedWitness) and len(W) == len(jW)
    for a, b in zip(W.cols, jW.cols):
        assert a.dtype == np.uint32 and np.array_equal(a, b)
    assert named == jnamed


def _equal_to_direct(W, direct):
    assert len(W) == len(direct)
    for a, b in zip(W.cols, _words(direct)):
        assert np.array_equal(a, b)


def _cf_pps(sc, jsc):
    jpp = jcf.CyclefoldPublicParams(jsc, k=K_CF, ck_primary=JMockKey(J_BN256_G1), ck_support=JMockKey(J_GRUMPKIN))
    pp = tcf.CyclefoldPublicParams(sc, K_CF, MockCommitmentKey(BN256_G1, "cpu"), MockCommitmentKey(GRUMPKIN, "cpu"))
    return pp, jpp


@pytest.fixture(scope="module")
def cf():
    return _cf_pps(TrivialStepCircuit(1), JTrivialStepCircuit(arity=1))


def test_cyclefold_sfc_replay_matches_direct_and_jax(cf):
    pp, jpp = cf
    assert pp.digest_hex() == jpp.digest_hex()
    assert pp.sfc_taped.sizes() == {"ops": 530638, "inputs": 352, "consts": 261, "out_slots": 266812}
    _same_tape(pp.sfc_taped, jpp.sfc_taped)
    assert tcf._cf_flatten(pp._dry_inputs(), pp.sc) == jcf._cf_flatten(jpp._dry_inputs(), jpp.sc)
    inp = tcf._cf_pack(pp._dry_inputs(), _leaves(1))
    jinp = jcf._cf_pack(jpp._dry_inputs(), _leaves(1))
    flat = tcf._cf_flatten(inp, pp.sc)
    assert flat == jcf._cf_flatten(jinp, jpp.sc) and len(flat) == 352
    W, named = pp.sfc_taped.replay(flat)
    _same_replay(W, named, *jpp.sfc_taped.replay(flat))
    direct = tcf.CyclefoldIVC._sfc_witness_direct(SimpleNamespace(pp=pp), inp, named["x0"], named["x1"])
    _equal_to_direct(W, direct)


def test_support_replay_matches_direct_and_jax(cf):
    pp, jpp = cf
    assert pp.support_taped.sizes() == {"ops": 38914, "inputs": 6, "consts": 8, "out_slots": 50636}
    _same_tape(pp.support_taped, jpp.support_taped)
    dry = InstanceInput(gold.identity(bn256_g1), gold.identity(bn256_g1), 0, 0)
    jdry = JInstanceInput(jgold.identity(bn256_g1), jgold.identity(bn256_g1), 0, 0)
    assert _sup_flatten(dry) == jcf._sup_flatten(jdry) == [0] * 6
    chain = SupportFoldChain(MockCommitmentKey(GRUMPKIN, "cpu"), pp.S_support, pp.support_taped)
    G, jG = gold.generator(bn256_g1), jgold.generator(bn256_g1)
    for s0, s1, l0, l1 in [(12345, 67890, 2**250 + 17, 2**251 + 99), (0, 5, 3, bn256_fr.modulus - 1)]:
        inp = InstanceInput(G.mul(s0), G.mul(s1), l0, l1)
        jinp = JInstanceInput(jG.mul(s0), jG.mul(s1), l0, l1)
        assert _sup_flatten(inp) == jcf._sup_flatten(jinp)
        instances, W = chain.witness(inp)
        d_instances, direct = chain.witness_direct(inp)
        assert instances == d_instances
        _equal_to_direct(W, direct)
        jW, _ = jpp.support_taped.replay(jcf._sup_flatten(jinp))
        _same_replay(W, {}, jW, {})


@pytest.fixture(scope="module")
def sg():
    jpp = jsg.PublicParams(JTrivialStepCircuit(arity=1), JTrivialStepCircuit(arity=1), K_SG, K_SG,
                           JMockKey(J_BN256_G1), JMockKey(J_GRUMPKIN))
    pp = tsg.PublicParams(TrivialStepCircuit(1), TrivialStepCircuit(1), K_SG, K_SG, MockCommitmentKey(BN256_G1, "cpu"),
                          MockCommitmentKey(GRUMPKIN, "cpu"))
    return pp, jpp


def _sg_dry(mod, g, side, sc, paired_probe):
    return mod.StepInputs(step=0, pp_digest=(0, 0), z_0=[0] * sc.arity, z_i=[0] * sc.arity,
                          U=mod._initial_relaxed(side.paired, paired_probe),
                          u=mod._default_incoming(side.paired, paired_probe),
                          cross_term_commits=[g.identity(side.paired)] * paired_probe.num_cross_terms)


@pytest.mark.parametrize("which", ["primary", "secondary"])
def test_sangria_sfc_replay_matches_direct_and_jax(sg, which):
    pp, jpp = sg
    side, jside = getattr(pp, which), getattr(jpp, which)
    other = "secondary" if which == "primary" else "primary"
    sc, jsc = getattr(pp, f"{which}_sc"), getattr(jpp, f"{which}_sc")
    jtaped = getattr(jpp, f"{which}_taped")
    _same_tape(side.taped, jtaped)
    dry = _sg_dry(tsg, gold, side, sc, getattr(pp, f"{other}_probe"))
    jdry = _sg_dry(jsg, jgold, jside, jsc, getattr(jpp, f"{other}_probe"))
    assert tsg._sg_flatten(dry, sc) == jsg._sg_flatten(jdry, jsc)
    inp = tsg._sg_pack(dry, _leaves(2))
    flat = tsg._sg_flatten(inp, sc)
    assert flat == jsg._sg_flatten(jsg._sg_pack(jdry, _leaves(2)), jsc)
    W, named = side.taped.replay(flat)
    _same_replay(W, named, *jtaped.replay(flat))
    f = side.curve.scalar
    sfc = tsg.StepFoldingCircuit(sc, inp, side.paired, f)
    direct = tsg.IVC._witness_direct(side, sfc, f, sfc.instances([named["x0"], named["x1"]]), named["x1"])
    _equal_to_direct(W, direct)


def test_merkle_stateful_replay_matches_direct_and_jax():
    pp, jpp = _cf_pps(MerkleStepCircuit(bn256_fr, depth=32, batch=1),
                      JMerkleStepCircuit(bn256_fr, depth=32, batch=1))
    sc, jsc = pp.sc, jpp.sc
    assert pp.digest_hex() == jpp.digest_hex()
    _same_tape(pp.sfc_taped, jpp.sfc_taped)
    assert sc.dynamic_witness() == jsc.dynamic_witness() == [0] * (2 + 2 * 32)  # restored after the trace
    stale = tcf._cf_flatten(pp._dry_inputs(), sc)
    assert stale == jcf._cf_flatten(jpp._dry_inputs(), jsc)
    z = sc.process_step([sc.tree.root], K_CF, bn256_fr)
    assert z == jsc.process_step([jsc.tree.root], K_CF, bn256_fr)
    assert sc.dynamic_witness() == jsc.dynamic_witness()
    inp = tcf._cf_pack(pp._dry_inputs(), _leaves(3))
    flat = tcf._cf_flatten(inp, sc)
    assert flat == jcf._cf_flatten(jcf._cf_pack(jpp._dry_inputs(), _leaves(3)), jsc)
    W, named = pp.sfc_taped.replay(flat)
    _same_replay(W, named, *jpp.sfc_taped.replay(flat))
    direct = tcf.CyclefoldIVC._sfc_witness_direct(SimpleNamespace(pp=pp), inp, named["x0"], named["x1"])
    _equal_to_direct(W, direct)
    # the step circuit's witness is a tape input: the zero (stale) witness replays another root
    _, stale_named = pp.sfc_taped.replay(flat[: -len(sc.dynamic_witness())] + [0] * len(sc.dynamic_witness()))
    assert stale_named["z0"] != named["z0"]


@pytest.fixture
def no_direct_synthesis(monkeypatch):
    def refuse(self):
        raise AssertionError("a driver step synthesized a witness directly")

    monkeypatch.setattr(CircuitRunner, "collect_witness", refuse)


def test_cyclefold_steps_only_replay(cf, no_direct_synthesis):
    pp, _ = cf
    ivc = tcf.CyclefoldIVC(pp, [0x42])
    ivc.next()
    assert ivc.step == 2 and ivc.z_i == [0x42]
    assert ivc.verify() == []


def test_sangria_steps_only_replay(sg, no_direct_synthesis):
    pp, _ = sg
    ivc = tsg.IVC(pp, [0x11], [0x22])
    ivc.fold_step()
    assert ivc.step == 2 and ivc.verify() == []


@pytest.mark.parametrize("f", [FR, FQ], ids=["fr", "fq"])
def test_to_mont_words_equals_encode(f):
    rng = random.Random(f.spec.name)
    xs = [0, 1, f.p - 1, *(rng.randrange(f.p) for _ in range(200))]
    words = torch.from_numpy(ints_to_words(xs).astype(np.uint32).view(np.int32))
    want = f.encode(xs, "cpu")
    assert torch.equal(f.to_mont_words(words), want)
    assert torch.equal(f.to_mont_words(words.to(torch.int64) & 0xFFFFFFFF), want)
    # the SPS's upload of a replayed witness equals the host encoding of its ints
    n = 64
    cols = [xs[:n], xs[n : 2 * n], xs[2 * n : 3 * n]]
    rw = ReplayedWitness([ints_to_words(c).astype(np.uint32) for c in cols])
    assert torch.equal(concat_with_padding(f, rw, n, "cpu"), concat_with_padding(f, cols, n, "cpu"))
    assert [list(c) for c in rw] == cols
