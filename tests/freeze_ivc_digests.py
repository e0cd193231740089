"""Freeze the JAX package's lookup-IVC digests for `sirius_tpu_torch/util/golden.py`.

Runs one configuration of the JAX package on the CPU and prints, as one JSON
object, the digests the port is held to (the digest functions are the port's
own `util/golden.py`, which needs only numpy and hashlib):

- a Cyclefold IVC (`xor_lookup`: `XorLookupStepCircuit(key=3)`, k = 18,
  z0 = [2]; `sha256`: `SpreadSha256StepCircuit(bn256_fr, half_bits=16,
  rounds=64)`, k = 18, z0 = [0x0123456789ABCDEF]; `cyclefold_trivial_k17`:
  `TrivialStepCircuit(1)`, k = 17, z0 = [0x11] (examples/cyclefold_trivial.py);
  `merkle_d32_b1`: `MerkleStepCircuit(bn256_fr, depth=32, batch=1)`, k = 17,
  z0 = [the empty tree's root] (examples/merkle_tree.py); mock keys): the pp
  digest, z_i and `golden.cyclefold_digests` after `new` and after one
  `next`;
- a Sangria IVC (`sangria_xor`: `XorStepCircuit(bn256_fr)`, z0 = [5] / [0];
  `sangria_range`: `RangeCheckStepCircuit(bn256_fr)`, z0 = [7] / [0], k = 17;
  `sangria_instances`: examples/instances.py's `PublicPow5Circuit`, z0 =
  [3] / [0], k = 16; `my_circuit`: examples/my_circuit.py's arity-5
  `MyStepCircuit`, z0 = [0, 1, 2, 3, 4] / [0], k = 16;
  `TrivialStepCircuit(1)` as the secondary, the same k on both curves, mock
  keys): the pp digest points, the (primary, secondary) accumulator
  digests and the whole state's `golden.sangria_ivc_digest` after
  `IVC(...)` and after one `fold_step()`;
- `dryrun_mc_folds`: the Sangria folds of `__graft_entry__.dryrun_multichip`
  without a mesh (its `_XorLookupFixture(1, 2, 9)` and `(3, 5, 9)` at
  k = 6, 3-round SPS on one shared transcript, key
  `CommitmentKey.setup(BN256_G1, 9, b"dryrun-mc")`, both traces folded into
  the zero relaxed accumulator): `golden.sangria_acc_digest` after each
  fold.

Not a test (pytest does not collect it).  Run from the repository root:

    JAX_PLATFORMS=cpu python tests/freeze_ivc_digests.py sha256
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from sirius_tpu.curves.jpoint import BN256_G1, GRUMPKIN  # noqa: E402
from sirius_tpu.fields.constants import bn256_fr  # noqa: E402
from sirius_tpu.ivc.step_circuit import TrivialStepCircuit  # noqa: E402
from sirius_tpu.util.testing import MockCommitmentKey  # noqa: E402
from sirius_tpu_torch.util import golden  # noqa: E402
from sirius_tpu_torch.util.interop import limbs_to_words  # noqa: E402


def _cyclefold_state(ivc):
    words = [limbs_to_words(np.asarray(w)) for w in ivc.primary_trace.w.W]
    return dict(step=ivc.step, z_i=[hex(v) for v in ivc.z_i], digests=golden.cyclefold_digests(ivc, words))


def _example(name):
    """A module of the JAX package's `examples/` (its step-circuit classes)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cyclefold(step, z0, k=18):
    from sirius_tpu.ivc.cyclefold_ivc import CyclefoldIVC, CyclefoldPublicParams

    out, t0 = {}, time.time()
    pp = CyclefoldPublicParams(step, k=k, ck_primary=MockCommitmentKey(BN256_G1),
                               ck_support=MockCommitmentKey(GRUMPKIN))
    out["pp"] = dict(digest=pp.digest_hex(), num_witness_primary=pp.num_witness_primary,
                     seconds=round(time.time() - t0, 1))
    t0 = time.time()
    ivc = CyclefoldIVC(pp, z0)
    out["new"] = dict(_cyclefold_state(ivc), seconds=round(time.time() - t0, 1))
    t0 = time.time()
    ivc.next()
    out["next"] = dict(_cyclefold_state(ivc), seconds=round(time.time() - t0, 1))
    return out


def sangria(step, z0, k=17):
    from sirius_tpu.ivc.sangria_ivc import IVC, PublicParams

    out, t0 = {}, time.time()
    pp = PublicParams(step, TrivialStepCircuit(arity=1), k1=k, k2=k, ck1=MockCommitmentKey(BN256_G1),
                      ck2=MockCommitmentKey(GRUMPKIN))
    out["pp"] = dict(digest_1=[str(v) for v in pp.digest_coords(1)],
                     digest_2=[str(v) for v in pp.digest_coords(2)], seconds=round(time.time() - t0, 1))

    def state(ivc):
        return [golden.sangria_acc_digest(ivc.primary_relaxed.U), golden.sangria_acc_digest(ivc.secondary_relaxed.U)]

    t0 = time.time()
    ivc = IVC(pp, z0, [0])
    out["new"] = dict(digests=state(ivc), state=golden.sangria_ivc_digest(ivc), seconds=round(time.time() - t0, 1))
    t0 = time.time()
    ivc.fold_step()
    out["step"] = dict(digests=state(ivc), state=golden.sangria_ivc_digest(ivc), z_i=[hex(v) for v in ivc.primary_z_i],
                       sc_instances_hash_acc=hex(ivc.primary_relaxed.U.sc_instances_hash_acc or 0),
                       seconds=round(time.time() - t0, 1))
    return out


def dryrun_mc_folds():
    from __graft_entry__ import _XorLookupFixture
    from sirius_tpu.fields import gold
    from sirius_tpu.fields.constants import bn256_fq, bn256_g1
    from sirius_tpu.frontend.runner import CircuitRunner
    from sirius_tpu.nifs.sangria import RelaxedPlonkInstance, RelaxedPlonkTrace, RelaxedPlonkWitness, VanillaFS
    from sirius_tpu.ops.commitment import CommitmentKey
    from sirius_tpu.ops.poseidon import PoseidonHash, poseidon_spec
    from sirius_tpu.plonk.sps import run_sps_protocol

    t0 = time.time()
    k = 6
    ro = lambda: PoseidonHash(poseidon_spec(bn256_fq, 3, 2, 4, 3))  # noqa: E731
    c1, c2 = _XorLookupFixture(1, 2, 9), _XorLookupFixture(3, 5, 9)
    inst1, inst2 = c1.instances(), c2.instances()
    r1 = CircuitRunner(k, bn256_fr, c1, inst1)
    ck = CommitmentKey.setup(BN256_G1, 9, b"dryrun-mc", use_cache=False, window_bits=4)
    S = r1.collect_plonk_structure()
    ro_gen = ro()
    tr1 = run_sps_protocol(S, ck, inst1, r1.collect_witness(), ro_gen)
    tr2 = run_sps_protocol(S, ck, inst2, CircuitRunner(k, bn256_fr, c2, inst2).collect_witness(), ro_gen)
    pp, vp = VanillaFS.setup_params(gold.identity(bn256_g1), S)
    f = S.field
    acc = RelaxedPlonkTrace(U=RelaxedPlonkInstance.new(bn256_g1, S.num_challenges, len(S.round_sizes),
                                                       len(S.num_io) - 1),
                            W=RelaxedPlonkWitness([f.zeros((sz,)) for sz in S.round_sizes], f.zeros((S.n,))))
    ro_nark_v, ro_acc_p, ro_acc_v = ro(), ro(), ro()
    folds = []
    for tr in (tr1, tr2):
        new_acc, ct_commits = VanillaFS.prove(ck, pp, ro_acc_p, acc, tr)
        assert VanillaFS.verify(vp, bn256_g1, ro_nark_v, ro_acc_v, acc.U, tr.u, ct_commits) == new_acc.U
        acc = new_acc
        folds.append(golden.sangria_acc_digest(acc.U))
    return dict(folds=folds, seconds=round(time.time() - t0, 1))


def main(which):
    if which == "dryrun_mc_folds":
        return dryrun_mc_folds()
    if which == "xor_lookup":
        from sirius_tpu.gadgets.xor_lookup_step_circuit import XorLookupStepCircuit

        return cyclefold(XorLookupStepCircuit(key=3), [2])
    if which == "sha256":
        from sirius_tpu.gadgets.spread_sha256 import SpreadSha256StepCircuit

        return cyclefold(SpreadSha256StepCircuit(bn256_fr, half_bits=16, rounds=64), [0x0123456789ABCDEF])
    if which == "cyclefold_trivial_k17":
        return cyclefold(TrivialStepCircuit(arity=1), [0x11], k=17)
    if which == "merkle_d32_b1":
        from sirius_tpu.gadgets.merkle_step_circuit import MerkleStepCircuit

        sc = MerkleStepCircuit(bn256_fr, depth=32, batch=1)
        return cyclefold(sc, [sc.tree.root], k=17)
    if which == "sangria_instances":
        return sangria(_example("instances").PublicPow5Circuit(bn256_fr), [3], k=16)
    if which == "my_circuit":
        return sangria(_example("my_circuit").MyStepCircuit(), list(range(5)), k=16)
    if which == "sangria_xor":
        from sirius_tpu.gadgets.xor_step_circuit import XorStepCircuit

        return sangria(XorStepCircuit(bn256_fr), [5])
    if which == "sangria_range":
        from sirius_tpu.gadgets.range_step_circuit import RangeCheckStepCircuit

        return sangria(RangeCheckStepCircuit(bn256_fr), [7])
    raise SystemExit(f"unknown configuration {which!r}")


if __name__ == "__main__":
    print(json.dumps(dict(config=sys.argv[1], **main(sys.argv[1]))), flush=True)
