"""The row-sharded sweeps (`sirius_tpu_torch/parallel/rows.py`) against the
JAX package on the CPU.  Under a mesh of D CPU entries (`make_mesh(devices=
['cpu'] * D)`, D = 2, 4, 8) every SPS round, E and cross term is D row
blocks; the JAX package runs unsharded on the same inputs, made from a numpy
seed, and the port must equal it word for word (points in affine form).
Also: the frozen fibo digests of `tests/test_golden.py` under a 4-shard
mesh, a commit and a batched check of row blocks against the host MSM, the
whole-round fallback of a 3-shard mesh, and the JAX package's own sharded
fold under its mesh of 8 virtual devices (`tests/conftest.py`)."""

import dataclasses
import logging
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import FiboCircuit
from sirius_tpu.curves.jpoint import BN256_G1 as J_BN256_G1
from sirius_tpu.fields import gold as jgold
from sirius_tpu.fields.constants import bn256_fr as j_bn256_fr
from sirius_tpu.fields.constants import bn256_g1 as j_bn256_g1
from sirius_tpu.frontend.runner import CircuitRunner as JRunner
from sirius_tpu.nifs import protogalaxy as jpg
from sirius_tpu.nifs import sangria as jsg
from sirius_tpu.ops.poseidon import PoseidonHash as JPoseidonHash
from sirius_tpu.ops.poseidon import poseidon_spec as j_poseidon_spec
from sirius_tpu.parallel.context import mesh_context as jax_mesh_context
from sirius_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sirius_tpu.plonk.structure import PlonkInstance as JPlonkInstance
from sirius_tpu.plonk.structure import PlonkTrace as JPlonkTrace
from sirius_tpu.plonk.structure import PlonkWitness as JPlonkWitness
from sirius_tpu.util.testing import MockCommitmentKey as JMockCommitmentKey
from sirius_tpu_torch.curves.jpoint import BN256_G1
from sirius_tpu_torch.fields import gold
from sirius_tpu_torch.fields.constants import bn256_fq, bn256_fr, bn256_g1
from sirius_tpu_torch.fields.jfield import FR, ints_to_words
from sirius_tpu_torch.frontend.runner import CircuitRunner
from sirius_tpu_torch.frontend.taped import ReplayedWitness
from sirius_tpu_torch.nifs.protogalaxy import AccumulatorInstance, ProtoGalaxy
from sirius_tpu_torch.nifs.sangria import RelaxedPlonkInstance, RelaxedPlonkTrace, RelaxedPlonkWitness, VanillaFS
from sirius_tpu_torch.ops import msm as msm_mod
from sirius_tpu_torch.ops.commitment import CommitmentKey
from sirius_tpu_torch.ops.poseidon import PoseidonHash, poseidon_spec
from sirius_tpu_torch.parallel import WHOLE_ROUND_FALLBACK, RowBlocks, make_mesh, mesh_context, rows
from sirius_tpu_torch.plonk.sps import run_sps_protocol
from sirius_tpu_torch.plonk.structure import PlonkInstance, PlonkTrace, PlonkWitness
from sirius_tpu_torch.util.golden import pg_acc_digest, sangria_acc_digest
from sirius_tpu_torch.util.interop import limbs_to_words, witness_to_numpy
from sirius_tpu_torch.util.testing import FiboXorLookupCircuit, MockCommitmentKey

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers

K = 4
P = bn256_fr.modulus
SANGRIA_FIBO_2FOLD_DIGEST = "1a5a2de2b2308bd72dd55cf500e631d5915d1be12874c39139aebd1614526541"  # tests/test_golden.py
PG_FIBO_1FOLD_DIGEST = "ac15a68e6cc6cf7f3afe286e52291414977a854bcd2b1144baa88e3a2ef24df9"


def _mesh(D):
    return make_mesh(devices=["cpu"] * D)


def _ro(spec=bn256_fq):
    return PoseidonHash(poseidon_spec(spec, 3, 2, 4, 3))


def _is_blocks(x, mesh) -> bool:
    return isinstance(x, RowBlocks) and x.mesh == mesh and x.devices == list(mesh.devices)


@dataclass
class TwoRotationCircuit:
    """Fibonacci pairs (a_i, b_i) -> (b_i, a_i + b_i) row after row: one gate
    reads the previous row (rotation -1), one the next (rotation +1), each
    under its own selector on some of the rows."""

    num: int

    def configure(self, cs):
        a, b = cs.advice_column(), cs.advice_column()
        s_prev, s_next = cs.selector(), cs.selector()
        inst = cs.instance_column()
        qa, qb, sp = cs.query(a), cs.query(b), cs.query(s_prev)
        cs.create_gate("prev", [sp * (qa - cs.query(b, -1)), sp * (qb - cs.query(a, -1) - cs.query(b, -1))])
        cs.create_gate("next", [cs.query(s_next) * (cs.query(a, 1) - qb)])
        return (a, b, s_prev, s_next, inst)

    def synthesize(self, config, asn):
        a, b, s_prev, s_next, inst = config
        x, y = 1, 1
        for row in range(self.num):
            asn.assign_advice(a, row, x)
            asn.assign_advice(b, row, y)
            if row % 3:
                asn.enable_selector(s_prev, row)
            if row + 1 < self.num and row % 5 != 4:
                asn.enable_selector(s_next, row)
            x, y = y, (x + y) % asn.p
        asn.copy(a, self.num - 1, inst, 0)

    def instances(self, p):
        x, y = 1, 1
        for _ in range(self.num - 1):
            x, y = y, (x + y) % p
        return [[x, 0]]


def _random_words(rng, size):
    return FR.encode([int.from_bytes(rng.bytes(32), "little") % P for _ in range(size)], "cpu")


@pytest.fixture(scope="module")
def rotations():
    """Both packages' structures of TwoRotationCircuit at K = 4 and two
    random (unsatisfied: every gate leaf nonzero) traces from a numpy seed,
    each in both packages' forms."""
    c = TwoRotationCircuit(12)
    S = CircuitRunner(K, bn256_fr, c, c.instances(P)).collect_plonk_structure()
    jS = JRunner(K, j_bn256_fr, c, c.instances(P)).collect_plonk_structure()
    assert S.halo() == (1, 1) and S.num_challenges == jS.num_challenges == 1
    rng = np.random.default_rng(16)
    traces, jtraces = [], []
    for _ in range(2):
        W = [_random_words(rng, sz) for sz in S.round_sizes]
        u = PlonkInstance([gold.identity(bn256_g1)], [[int(rng.integers(1, 1 << 60)), 0]],
                          [int.from_bytes(rng.bytes(32), "little") % P])
        traces.append(PlonkTrace(u, PlonkWitness(W)))
        jtraces.append(JPlonkTrace(JPlonkInstance([jgold.identity(j_bn256_g1)], u.instances, u.challenges),
                                   JPlonkWitness([jnp.asarray(w) for w in witness_to_numpy(W)])))
    return S, jS, traces, jtraces


@pytest.fixture(scope="module")
def jax_protogalaxy(rotations):
    """The JAX package unsharded: the new accumulator's e (evaluate_e_from_trace)
    and one prove of the second trace into it (compute_F, compute_K, the
    witness fold)."""
    _, jS, _, jtraces = rotations
    jpp, _ = jpg.ProtoGalaxy.setup_params(jgold.identity(j_bn256_g1), jS)
    jro = lambda: JPoseidonHash(j_poseidon_spec(j_bn256_fr, 3, 2, 4, 3))  # noqa: E731
    jacc = jpg.ProtoGalaxy.new_accumulator(jpp, jro(), jtraces[0], j_bn256_g1)
    jnew, jproof = jpg.ProtoGalaxy.prove(JMockCommitmentKey(J_BN256_G1), jpp, jro(), jacc, jtraces[1:])
    return jacc, jnew, jproof


@pytest.mark.parametrize("D", [2, 4, 8])
def test_sharded_gate_sweeps_and_pow_reduce_equal_the_jax_package(rotations, jax_protogalaxy, D):
    """ProtoGalaxy on row blocks with halo rows at rotations -1 and +1: e of
    the new accumulator, F's and K's coefficients and the folded witness
    equal the JAX package's unsharded run."""
    S, _, traces, _ = rotations
    jacc, jnew, jproof = jax_protogalaxy
    mesh = _mesh(D)
    with mesh_context(mesh):
        blocked = [PlonkTrace(t.u, PlonkWitness([RowBlocks.shard(mesh, w, S.n) for w in t.w.W])) for t in traces]
        pp, _ = ProtoGalaxy.setup_params(gold.identity(bn256_g1), S)
        acc = ProtoGalaxy.new_accumulator(pp, _ro(bn256_fr), blocked[0], bn256_g1)
        assert (acc.betas, acc.e) == (jacc.betas, jacc.e)
        new, proof = ProtoGalaxy.prove(MockCommitmentKey(BN256_G1, "cpu"), pp, _ro(bn256_fr), acc, blocked[1:])
    assert proof.poly_F.coeffs == jproof.poly_F.coeffs and any(proof.poly_F.coeffs)
    assert proof.poly_K.coeffs == jproof.poly_K.coeffs
    assert new.e == jnew.e
    for w, jw in zip(new.trace.w.W, jnew.trace.w.W):
        assert _is_blocks(w, mesh) and np.array_equal(w.gather().numpy(), _jax_words(jw))


def _jax_words(jw) -> np.ndarray:
    """A JAX witness array ((size, 16) 16-bit limbs) as (size, 8) words."""
    return limbs_to_words(np.asarray(jw))


@pytest.fixture(scope="module")
def sangria_inputs(rotations):
    """A random relaxed accumulator (W, E, u) and a random incoming trace,
    in both packages' forms."""
    S, _, traces, jtraces = rotations
    rng = np.random.default_rng(17)
    E = _random_words(rng, S.n)
    u = int.from_bytes(rng.bytes(32), "little") % P
    r = int(rng.integers(1, 1 << 62))
    U1 = RelaxedPlonkInstance([gold.identity(bn256_g1)], [0, 0], traces[0].u.challenges, gold.identity(bn256_g1),
                              u, None)
    jU1 = jsg.RelaxedPlonkInstance([jgold.identity(j_bn256_g1)], [0, 0], traces[0].u.challenges,
                                   jgold.identity(j_bn256_g1), u, None)
    jW1 = jsg.RelaxedPlonkWitness(list(jtraces[0].w.W), jnp.asarray(witness_to_numpy([E])[0]))
    jcross, _ = jsg.VanillaFS.commit_cross_terms(JMockCommitmentKey(J_BN256_G1), rotations[1], jU1, jW1,
                                                 jtraces[1].u, jtraces[1].w)
    return dict(U1=U1, W=traces[0].w.W, E=E, r=r, jW1=jW1, jcross=jcross, jtrace=jtraces[1])


def test_sangria_cross_terms_and_fold_equal_the_jax_package(rotations, sangria_inputs):
    """Cross terms at X = 0..D per block and their Vandermonde combinations,
    then the fold of W and E, on a 4-shard mesh: row blocks equal to the
    JAX package's unsharded arrays."""
    S, _, traces, _ = rotations
    x = sangria_inputs
    mesh = _mesh(4)
    ck = MockCommitmentKey(BN256_G1, "cpu")
    W1 = RelaxedPlonkWitness([RowBlocks.shard(mesh, w, S.n) for w in x["W"]], RowBlocks.shard(mesh, x["E"], S.n))
    W2 = PlonkWitness([RowBlocks.shard(mesh, w, S.n) for w in traces[1].w.W])
    with mesh_context(mesh):
        cross, commits = VanillaFS.commit_cross_terms(ck, S, x["U1"], W1, traces[1].u, W2)
        folded = W1.fold(S.field, W2, cross, x["r"])
    assert len(cross) == len(x["jcross"]) >= 1
    for t, jt in zip(cross, x["jcross"]):
        assert _is_blocks(t, mesh) and np.array_equal(t.gather().numpy(), _jax_words(jt))
    assert commits == [ck.commit_device(t.gather()) for t in cross]
    jfolded = x["jW1"].fold(rotations[1].field, x["jtrace"].w, x["jcross"], x["r"])
    for w, jw in zip([*folded.W, folded.E], [*jfolded.W, jfolded.E]):
        assert _is_blocks(w, mesh) and np.array_equal(w.gather().numpy(), _jax_words(jw))


def test_fold_equals_the_jax_packages_sharded_fold_on_its_8_devices(rotations, sangria_inputs):
    """`RelaxedPlonkWitness.fold` of the JAX package under its mesh of the 8
    virtual CPU devices (explicit row shardings) against the port's fold on
    8 row blocks."""
    S, _, traces, _ = rotations
    x = sangria_inputs
    with jax_mesh_context(jax_make_mesh(8)):
        jfolded = x["jW1"].fold(rotations[1].field, x["jtrace"].w, x["jcross"], x["r"])
    mesh = _mesh(8)
    W1 = RelaxedPlonkWitness([RowBlocks.shard(mesh, w, S.n) for w in x["W"]], RowBlocks.shard(mesh, x["E"], S.n))
    cross = [RowBlocks.shard(mesh, torch.from_numpy(_jax_words(jt)), S.n) for jt in x["jcross"]]
    folded = W1.fold(S.field, PlonkWitness([RowBlocks.shard(mesh, w, S.n) for w in traces[1].w.W]), cross, x["r"])
    for w, jw in zip([*folded.W, folded.E], [*jfolded.W, jfolded.E]):
        assert _is_blocks(w, mesh) and np.array_equal(w.gather().numpy(), _jax_words(jw))


@pytest.mark.parametrize("witness", ["replayed", "direct"])
def test_sps_rounds_are_row_blocks_equal_to_the_unsharded_words(witness):
    """The dry run's 3-round SPS (a vector lookup, rotation +1) on a mock
    key: under a 4-shard mesh each round (advice; l, t, m; h, g) is 4 row
    blocks on the mesh's devices whose gather equals the unsharded round,
    with the same challenges; a replayed witness converts block by block."""
    k = 6
    c = FiboXorLookupCircuit(1, 2, 9, xor_bits=3)
    runner = CircuitRunner(k, bn256_fr, c, c.instances())
    S, cols = runner.collect_plonk_structure(), runner.collect_witness()
    n = 1 << k
    if witness == "replayed":
        cols = ReplayedWitness([ints_to_words(list(col) + [0] * (n - len(col))).astype(np.uint32) for col in cols])
    ck = MockCommitmentKey(BN256_G1, "cpu")
    want = run_sps_protocol(S, ck, c.instances(), cols, _ro())
    mesh = _mesh(4)
    with mesh_context(mesh):
        got = run_sps_protocol(S, ck, c.instances(), cols, _ro())
    assert S.num_challenges == 3 and got.u == want.u
    for w, ww in zip(got.w.W, want.w.W):
        assert _is_blocks(w, mesh) and w.cols * n == ww.shape[0]
        assert torch.equal(w.gather(), ww)


def test_commit_and_batched_check_of_row_blocks_equal_the_host_msm(monkeypatch):
    """A round of 3 columns, a round of 1 and E as row blocks of a 4-shard
    mesh on a real key: a commit of the 3-column round pairs each block with
    the key points of its rows in every column, equal to the host MSM; the
    batched check over all three (the RLC in the 3-column layout) passes
    with one commit, that of the RLC, so no pair fell back to its own."""
    ck = CommitmentKey.setup(BN256_G1, 6, b"rows-test", use_cache=False, device="cpu")
    rng = np.random.default_rng(18)
    n, mesh = 16, _mesh(4)
    vals3, vals1, valsE = ([int(v) for v in rng.integers(0, 1 << 62, size=m)] for m in (3 * n, n, n))
    C3, C1, CE = (gold.msm(v, ck.host_points()[: len(v)]) for v in (vals3, vals1, valsE))
    W3, W1, E = (RowBlocks.shard(mesh, FR.encode(v, "cpu"), n) for v in (vals3, vals1, valsE))
    assert ck.commit_device(W3) == C3
    commits = []
    real = CommitmentKey.commit_device
    monkeypatch.setattr(CommitmentKey, "commit_device", lambda self, w: commits.append(w) or real(self, w))
    assert ck.batched_commit_check([(W3, C3), (W1, C1), (E, CE)]) == []
    assert len(commits) == 1 and _is_blocks(commits[0], mesh) and commits[0].cols == 3
    assert set(ck.shard_cache) == {(mesh, (n, 3))}  # the RLC committed in the 3-column layout


@pytest.mark.parametrize("plain", [False, True])
def test_blocked_rlc_over_rounds_of_different_widths_equals_the_unsharded_rlc(plain):
    """The batched check's RLC, block by block in the layout of the widest
    round, over a 3-column round, a 1-column round and E (as row blocks, or
    E as a plain tensor that is cut like them), gathers to sum rho_i W_i of
    the unsharded rounds: row i sums the rounds at least i + 1 rows long."""
    rng = np.random.default_rng(19)
    n, mesh = 16, _mesh(4)
    vals = [[int.from_bytes(rng.bytes(32), "little") % P for _ in range(m)] for m in (n, 3 * n, n)]
    rhos = [int.from_bytes(rng.bytes(16), "little") for _ in vals]
    Ws = [RowBlocks.shard(mesh, FR.encode(v, "cpu"), n) for v in vals]
    if plain:
        Ws[2] = FR.encode(vals[2], "cpu")
    got = CommitmentKey._rlc_blocks(FR, rhos, Ws, Ws[1])
    assert _is_blocks(got, mesh) and got.cols == 3
    want = [sum(rho * v[i] for rho, v in zip(rhos, vals) if i < len(v)) % P for i in range(3 * n)]
    assert FR.decode(got.gather()) == want


@pytest.fixture(scope="module")
def fibo():
    """tests/test_golden.py's inputs: the k = 7 "sangria-test" key, the
    structure of FiboCircuit at K = 4 and the witnesses of (1, 1, 10) and
    (2, 3, 10), each with its circuit."""
    ck = CommitmentKey.setup(BN256_G1, 7, b"sangria-test", use_cache=False, device="cpu")
    c1, c2 = FiboCircuit(1, 1, 10), FiboCircuit(2, 3, 10)
    r1 = CircuitRunner(K, bn256_fr, c1, c1.instances(P))
    inputs = [(c1, r1.collect_witness()), (c2, CircuitRunner(K, bn256_fr, c2, c2.instances(P)).collect_witness())]
    return ck, r1.collect_plonk_structure(), inputs


def _fresh(ck) -> CommitmentKey:
    """The key's points with an empty shard cache: what a test's mesh caches
    is its own."""
    return dataclasses.replace(ck, shard_cache={})


@pytest.mark.parametrize("scheme", ["sangria", "protogalaxy"])
def test_frozen_fibo_digests_hold_under_a_4_shard_mesh(fibo, scheme):
    """tests/test_golden.py's SANGRIA_FIBO_2FOLD_DIGEST and
    PG_FIBO_1FOLD_DIGEST with every trace, W round and E as row blocks of
    a 4-shard mesh, commitments through the key's row shards."""
    ck, S, ((c1, W1), (c2, W2)) = fibo
    ck = _fresh(ck)
    mesh = _mesh(4)
    with mesh_context(mesh):
        if scheme == "sangria":
            ro = _ro()
            trs = [run_sps_protocol(S, ck, c.instances(P), W, ro) for c, W in ((c1, W1), (c2, W2))]
            pp, _ = VanillaFS.setup_params(gold.identity(bn256_g1), S)
            acc = RelaxedPlonkTrace(RelaxedPlonkInstance.new(bn256_g1, S.num_challenges, len(S.round_sizes),
                                                             len(S.num_io) - 1),
                                    RelaxedPlonkWitness.zeros(S.field, S.round_sizes, S.n, "cpu"))
            ro_acc = _ro()
            for tr in trs:
                acc, _ = VanillaFS.prove(ck, pp, ro_acc, acc, tr)
            assert sangria_acc_digest(acc.U) == SANGRIA_FIBO_2FOLD_DIGEST
            assert VanillaFS.is_sat(ck, S, acc, [tr.u.instances for tr in trs]) == []
            rounds = [*acc.W.W, acc.W.E]
        else:
            trs = [run_sps_protocol(S, ck, c.instances(P), W, _ro(bn256_fr)) for c, W in ((c1, W1), (c2, W2))]
            pp, _ = ProtoGalaxy.setup_params(gold.identity(bn256_g1), S)
            acc = ProtoGalaxy.new_accumulator(pp, _ro(bn256_fr), trs[0], bn256_g1)
            new, _ = ProtoGalaxy.prove(ck, pp, _ro(bn256_fr), acc, trs[1:])
            assert pg_acc_digest(AccumulatorInstance.from_acc(new)) == PG_FIBO_1FOLD_DIGEST
            rounds = list(new.trace.w.W)
    assert all(_is_blocks(w, mesh) for tr in trs for w in tr.w.W)
    assert all(_is_blocks(w, mesh) for w in rounds)
    assert all(m == mesh for m, _ in ck.shard_cache)


def test_a_3_shard_mesh_takes_the_whole_round_fallback(fibo, caplog, monkeypatch):
    """16 rows do not divide over 3 shards: the rounds stay whole tensors
    (logged once by name), the commitments still go through msm_sharded and
    the frozen ProtoGalaxy digest holds."""
    monkeypatch.setattr(rows, "_logged", set())  # each (mesh, n) logs once a process
    calls = []
    real = msm_mod.msm_sharded
    monkeypatch.setattr(msm_mod, "msm_sharded", lambda *a: calls.append(a[3]) or real(*a))
    ck, S, inputs = fibo
    ck = _fresh(ck)
    mesh = _mesh(3)
    with caplog.at_level(logging.WARNING), mesh_context(mesh):
        trs = [run_sps_protocol(S, ck, c.instances(P), W, _ro(bn256_fr)) for c, W in inputs]
        pp, _ = ProtoGalaxy.setup_params(gold.identity(bn256_g1), S)
        acc = ProtoGalaxy.new_accumulator(pp, _ro(bn256_fr), trs[0], bn256_g1)
        new, _ = ProtoGalaxy.prove(ck, pp, _ro(bn256_fr), acc, trs[1:])
    assert pg_acc_digest(AccumulatorInstance.from_acc(new)) == PG_FIBO_1FOLD_DIGEST
    assert all(isinstance(w, torch.Tensor) for tr in [*trs, new.trace] for w in tr.w.W)
    assert calls == [mesh] * 2
    logged = [r.getMessage() for r in caplog.records if WHOLE_ROUND_FALLBACK in r.getMessage()]
    assert len(logged) == 1 and "16 table rows do not divide over 3 shards" in logged[0]
