"""Checkpoint and resume in the port (`sirius_tpu_torch/util/checkpoint.py`,
`CyclefoldIVC.checkpoint` / `.resume`), in the JAX package's file format.

- The Sangria accumulator: the port's counterpart of
  `tests/test_checkpoint.py::test_sangria_accumulator_checkpoint_roundtrip`
  (SquareCircuit traces at K = 4 on a real k = 7 key, on the CPU), and the
  files crossing between the packages in both directions.
- The Cyclefold IVC: the trivial step at k = 17 on mock keys, new ->
  checkpoint -> resume -> next against the JAX package's new -> next, frozen
  in `util/golden.py` (`CYCLEFOLD_TRIVIAL_K17_*`, `tests/freeze_ivc_digests.py
  cyclefold_trivial_k17`), verify() clean, a foreign pp digest refused, and
  the JAX package's loader reading the port's checkpoint.
- A checkpoint written from row blocks under a mesh and loaded without one,
  and the other way round.
"""

import json

import numpy as np
import pytest
import torch

from fixtures import SquareCircuit
from sirius_tpu.curves.jpoint import BN256_G1 as J_BN256_G1
from sirius_tpu.fields import gold as jgold
from sirius_tpu.fields.constants import bn256_fq as j_bn256_fq
from sirius_tpu.fields.constants import bn256_fr as j_bn256_fr
from sirius_tpu.fields.constants import bn256_g1 as j_bn256_g1
from sirius_tpu.frontend.runner import CircuitRunner as JCircuitRunner
from sirius_tpu.nifs import sangria as jsangria
from sirius_tpu.ops.commitment import CommitmentKey as JCommitmentKey
from sirius_tpu.ops.poseidon import PoseidonHash as JPoseidonHash
from sirius_tpu.ops.poseidon import poseidon_spec as j_poseidon_spec
from sirius_tpu.plonk.sps import run_sps_protocol as j_run_sps_protocol
from sirius_tpu.util import checkpoint as jcheckpoint
from sirius_tpu_torch.curves.jpoint import BN256_G1, GRUMPKIN
from sirius_tpu_torch.fields import gold
from sirius_tpu_torch.fields.constants import bn256_fq, bn256_fr, bn256_g1
from sirius_tpu_torch.frontend.runner import CircuitRunner
from sirius_tpu_torch.ivc.cyclefold_ivc import CyclefoldIVC, CyclefoldPublicParams
from sirius_tpu_torch.ivc.step_circuit import TrivialStepCircuit
from sirius_tpu_torch.nifs.sangria import RelaxedPlonkInstance, RelaxedPlonkTrace, RelaxedPlonkWitness, VanillaFS
from sirius_tpu_torch.ops.commitment import CommitmentKey
from sirius_tpu_torch.ops.poseidon import PoseidonHash, poseidon_spec
from sirius_tpu_torch.parallel import RowBlocks, make_mesh, mesh_context
from sirius_tpu_torch.plonk.sps import run_sps_protocol
from sirius_tpu_torch.util import golden
from sirius_tpu_torch.util.checkpoint import (load_cyclefold_state, load_sangria_accumulator,
                                              save_sangria_accumulator)
from sirius_tpu_torch.util.interop import cyclefold_ivc_from, limbs_to_words, relaxed_instance_from
from sirius_tpu_torch.util.testing import MockCommitmentKey

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers

K = 4
CF_K, CF_Z0 = 17, [0x11]


def _words(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else limbs_to_words(np.asarray(t))


def _acc_words(acc) -> list[np.ndarray]:
    return [_words(w) for w in [*acc.W.W, acc.W.E]]


@pytest.fixture(scope="module")
def square():
    """Both packages fold SquareCircuit(3)'s trace into the zero relaxed
    accumulator on the same k = 7 key; the port keeps SquareCircuit(5)'s
    trace to fold after a resume."""
    p = bn256_fr.modulus
    c1, c2 = SquareCircuit(3), SquareCircuit(5)
    inst1, inst2 = c1.instances(p), c2.instances(p)

    ck = CommitmentKey.setup(BN256_G1, 7, b"sangria-test", use_cache=False, device="cpu")
    r1 = CircuitRunner(K, bn256_fr, c1, inst1)
    S = r1.collect_plonk_structure()
    ro = PoseidonHash(poseidon_spec(bn256_fq, 3, 2, 4, 3))
    tr1 = run_sps_protocol(S, ck, inst1, r1.collect_witness(), ro)
    tr2 = run_sps_protocol(S, ck, inst2, CircuitRunner(K, bn256_fr, c2, inst2).collect_witness(), ro)
    pp, _ = VanillaFS.setup_params(gold.identity(bn256_g1), S)
    f = S.field
    acc0 = RelaxedPlonkTrace(
        RelaxedPlonkInstance.new(bn256_g1, S.num_challenges, len(S.round_sizes), len(S.num_io) - 1),
        RelaxedPlonkWitness([f.zeros((sz,), "cpu") for sz in S.round_sizes], f.zeros((S.n,), "cpu")),
    )
    ro_acc = PoseidonHash(poseidon_spec(bn256_fq, 3, 2, 4, 3))
    acc, _ = VanillaFS.prove(ck, pp, ro_acc, acc0, tr1)

    jck = JCommitmentKey.setup(J_BN256_G1, 7, b"sangria-test", use_cache=False, window_bits=4)
    jr1 = JCircuitRunner(K, j_bn256_fr, c1, inst1)
    jS = jr1.collect_plonk_structure()
    jro = JPoseidonHash(j_poseidon_spec(j_bn256_fq, 3, 2, 4, 3))
    jtr1 = j_run_sps_protocol(jS, jck, inst1, jr1.collect_witness(), jro)
    jpp, _ = jsangria.VanillaFS.setup_params(jgold.identity(j_bn256_g1), jS)
    jf = jS.field
    jacc0 = jsangria.RelaxedPlonkTrace(
        jsangria.RelaxedPlonkInstance.new(j_bn256_g1, jS.num_challenges, len(jS.round_sizes), len(jS.num_io) - 1),
        jsangria.RelaxedPlonkWitness([jf.zeros((sz,)) for sz in jS.round_sizes], jf.zeros((jS.n,))),
    )
    jacc, _ = jsangria.VanillaFS.prove(jck, jpp, JPoseidonHash(j_poseidon_spec(j_bn256_fq, 3, 2, 4, 3)), jacc0, jtr1)
    return dict(ck=ck, S=S, pp=pp, ro_acc=ro_acc, acc=acc, traces=(tr1, tr2), jacc=jacc)


def test_sangria_accumulator_checkpoint_roundtrip(square, tmp_path):
    """Save, refuse a foreign digest, load the same instance, fold the second
    trace on the loaded accumulator and check it is satisfied."""
    acc = square["acc"]
    path = str(tmp_path / "ckpt")
    save_sangria_accumulator(path, bn256_g1, acc, "digest-1", step=1)
    with pytest.raises(ValueError):
        load_sangria_accumulator(path, "digest-2", device="cpu")
    loaded, step = load_sangria_accumulator(path, "digest-1", device="cpu")
    assert step == 1
    assert loaded.U == acc.U
    assert all(np.array_equal(a, b) for a, b in zip(_acc_words(loaded), _acc_words(acc)))

    tr1, tr2 = square["traces"]
    acc2, _ = VanillaFS.prove(square["ck"], square["pp"], square["ro_acc"], loaded, tr2)
    assert VanillaFS.is_sat(square["ck"], square["S"], acc2, [tr1.u.instances, tr2.u.instances]) == []


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_sangria_checkpoint_crosses_between_the_packages(square, tmp_path, direction):
    """A file written by one package loads in the other with the same
    instance and the same W and E words (both packages folded the same
    trace, so the two accumulators agree too)."""
    acc, jacc = square["acc"], square["jacc"]
    assert relaxed_instance_from(jacc.U) == acc.U
    path = str(tmp_path / "ckpt")
    if direction == "jax_to_port":
        jcheckpoint.save_sangria_accumulator(path, j_bn256_g1, jacc, "digest-1", step=1)
        loaded, step = load_sangria_accumulator(path, "digest-1", device="cpu")
        assert loaded.U == relaxed_instance_from(jacc.U)
    else:
        save_sangria_accumulator(path, bn256_g1, acc, "digest-1", step=1)
        loaded, step = jcheckpoint.load_sangria_accumulator(path, "digest-1")
        assert relaxed_instance_from(loaded.U) == acc.U
    assert step == 1
    assert all(np.array_equal(a, b) for a, b in zip(_acc_words(loaded), _acc_words(jacc)))


def _digests(ivc):
    return golden.cyclefold_digests(ivc, [_words(w) for w in ivc.primary_trace.w.W])


@pytest.fixture(scope="module")
def cyclefold(tmp_path_factory):
    """The trivial Cyclefold IVC: new, checkpoint, resume from disk, one next
    on the resumed object."""
    pp = CyclefoldPublicParams(TrivialStepCircuit(arity=1), CF_K, MockCommitmentKey(BN256_G1, "cpu"),
                               MockCommitmentKey(GRUMPKIN, "cpu"))
    ivc = CyclefoldIVC(pp, CF_Z0)
    path = str(tmp_path_factory.mktemp("cyclefold") / "ckpt")
    ivc.checkpoint(path)
    new = _digests(ivc)
    resumed = CyclefoldIVC.resume(pp, path)
    del ivc
    resumed.next()
    return dict(pp=pp, path=path, new=new, resumed=resumed)


def test_resumed_cyclefold_next_matches_the_jax_uninterrupted_run(cyclefold):
    assert cyclefold["pp"].digest_hex() == golden.CYCLEFOLD_TRIVIAL_K17_PP
    assert cyclefold["new"] == golden.CYCLEFOLD_TRIVIAL_K17_NEW
    resumed = cyclefold["resumed"]
    assert (resumed.step, resumed.z_i) == (2, CF_Z0)
    assert _digests(resumed) == golden.CYCLEFOLD_TRIVIAL_K17_NEXT
    assert resumed.verify() == []


def test_cyclefold_checkpoint_with_a_foreign_pp_digest_is_refused(cyclefold, tmp_path):
    with open(cyclefold["path"] + ".json") as f:
        meta = json.load(f)
    meta["pp_digest"] = "0" * len(meta["pp_digest"])
    path = str(tmp_path / "edited")
    with open(path + ".json", "w") as f:
        json.dump(meta, f)
    with open(cyclefold["path"] + ".npz", "rb") as src, open(path + ".npz", "wb") as dst:
        dst.write(src.read())
    with pytest.raises(ValueError, match="pp digest"):
        CyclefoldIVC.resume(cyclefold["pp"], path)


def test_jax_loader_reads_the_ports_cyclefold_checkpoint(cyclefold):
    """`sirius_tpu.util.checkpoint.load_cyclefold_state` (which only assigns
    pp) reads the port's file; carried back into the port it has the
    checkpointed state's digests."""
    pp = cyclefold["pp"]
    jivc = jcheckpoint.load_cyclefold_state(cyclefold["path"], None, pp.digest_hex())
    assert (jivc.step, jivc.z_i) == (1, CF_Z0)
    carried = cyclefold_ivc_from(pp, jivc, "cpu")
    assert _digests(carried) == golden.CYCLEFOLD_TRIVIAL_K17_NEW == cyclefold["new"]


@pytest.mark.parametrize("written", ["under_a_mesh", "without_a_mesh"])
def test_sangria_checkpoint_crosses_between_a_mesh_and_none(square, tmp_path, written):
    """A checkpoint written from row blocks (`parallel/rows.py`, a 4-shard CPU
    mesh) holds the same bytes as one written from whole tensors; it loads
    without a mesh as tensors, and under the mesh as row blocks, with equal
    words and digests either way."""
    acc = square["acc"]
    mesh = make_mesh(devices=["cpu"] * 4)
    plain, blocked = str(tmp_path / "plain"), str(tmp_path / "blocked")
    save_sangria_accumulator(plain, bn256_g1, acc, "digest-1", step=1)
    with mesh_context(mesh):
        loaded, _ = load_sangria_accumulator(plain, "digest-1", device="cpu")
        assert all(isinstance(w, RowBlocks) and w.devices == list(mesh.devices) for w in [*loaded.W.W, loaded.W.E])
        if written == "under_a_mesh":
            save_sangria_accumulator(blocked, bn256_g1, loaded, "digest-1", step=1)
    if written == "under_a_mesh":
        with np.load(plain + ".npz") as a, np.load(blocked + ".npz") as b:
            assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
        loaded, _ = load_sangria_accumulator(blocked, "digest-1", device="cpu")
        assert all(isinstance(w, torch.Tensor) for w in [*loaded.W.W, loaded.W.E])
    words = [w.gather() if isinstance(w, RowBlocks) else w for w in [*loaded.W.W, loaded.W.E]]
    assert all(np.array_equal(_words(a), b) for a, b in zip(words, _acc_words(acc)))
    assert golden.sangria_acc_digest(loaded.U) == golden.sangria_acc_digest(acc.U)


@pytest.mark.parametrize("which", ["sangria", "cyclefold"])
def test_loaders_default_to_cuda(square, cyclefold, tmp_path, which):
    """Without a device a loader puts the tensors on the card; where there is
    no CUDA it raises instead of loading onto the CPU."""
    if which == "sangria":
        path = str(tmp_path / "ckpt")
        save_sangria_accumulator(path, bn256_g1, square["acc"], "digest-1", step=1)
        call = lambda: load_sangria_accumulator(path, "digest-1")[0].W.E  # noqa: E731
    else:
        pp = cyclefold["pp"]
        call = lambda: load_cyclefold_state(cyclefold["path"], pp, pp.digest_hex()).primary_trace.w.W[0]  # noqa: E731
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
