"""The seven step circuits of the port (`sirius_tpu_torch/gadgets/*_step_circuit.py`
and `spread_sha256.py`) against the JAX package's, each synthesized alone.

Each step runs in a plain circuit (the adapter of `tests/test_spread_sha256.py`:
z_in witnessed on a MainGate of the adapter's own, the step's z_out pinned to
an instance cell) through both packages' `CircuitRunner` at the smallest k it
fits: the structure digest, the copy graph and the witness must be equal word
for word, and `process_step` on seeded inputs too.  The port's trace (2- or
3-round SPS where the step looks up) satisfies `is_sat`, and one corrupted
lookup cell is caught, as `tests/test_spread_sha256.py::
test_lookup_violation_detected` does.
"""

import importlib

import numpy as np
import pytest
import torch

from sirius_tpu.fields.constants import bn256_fr as j_bn256_fr
from sirius_tpu.frontend.runner import CircuitRunner as JRunner
from sirius_tpu.util.digest import structure_digest_stream as j_structure_digest_stream
from sirius_tpu_torch.curves.jpoint import BN256_G1
from sirius_tpu_torch.fields.constants import bn256_fq, bn256_fr
from sirius_tpu_torch.frontend.runner import CircuitRunner
from sirius_tpu_torch.ops.poseidon import PoseidonHash, poseidon_spec
from sirius_tpu_torch.plonk import satisfy
from sirius_tpu_torch.plonk.sps import run_sps_protocol
from sirius_tpu_torch.util.digest import structure_digest_stream
from sirius_tpu_torch.util.testing import MockCommitmentKey

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers

P = bn256_fr.modulus
_rng = np.random.default_rng(12)


def _rand(bits: int) -> int:
    return int.from_bytes(_rng.bytes((bits + 7) // 8), "little") % (1 << bits) % P


# name -> (module, constructor(module, fr), bits of a seeded state (None: the
# Merkle tree's root), k, the lookup column to corrupt or None)
CASES = {
    "power": ("power_step_circuit", lambda m, fr: m.PowerStepCircuit(fr, degree=7), 254, 5, None),
    "merkle": ("merkle_step_circuit", lambda m, fr: m.MerkleStepCircuit(fr, depth=3), None, 12, None),
    "sha256": ("sha256_step_circuit", lambda m, fr: m.Sha256StepCircuit(fr), 252, 17, None),
    "spread_sha256": ("spread_sha256", lambda m, fr: m.SpreadSha256StepCircuit(fr, half_bits=8, rounds=8),
                      252, 12, lambda cfg: cfg[1][1]),
    "range": ("range_step_circuit", lambda m, fr: m.RangeCheckStepCircuit(fr), 64, 9, lambda cfg: cfg[1]),
    "xor": ("xor_step_circuit", lambda m, fr: m.XorStepCircuit(fr), 254, 10, lambda cfg: cfg[1][2]),
    "xor_lookup": ("xor_lookup_step_circuit", lambda m, fr: m.XorLookupStepCircuit(key=3), 2, 5,
                   lambda cfg: cfg[2]),
}
LOOKUP_CASES = [name for name, case in CASES.items() if case[4] is not None]


class _StepAdapter:
    """Plain circuit around one step: witness z_in, run the step, pin z_out
    to an instance cell; `corrupt(asn, step_cfg)` runs after synthesis."""

    def __init__(self, main_gate, step, z_in, fr, corrupt=None):
        self.mg, self.step, self.z_in, self.corrupt = main_gate, step, z_in, corrupt
        self.z_out = step.process_step([z_in], None, fr)[0]

    def configure(self, cs):
        return self.mg.MainGate.configure(cs, T=5), self.step.configure(cs), cs.instance_column()

    def instances(self):
        return [[self.z_in % P, self.z_out % P]]

    def synthesize(self, config, asn):
        mg_cfg, cfg, inst = config
        ctx = self.mg.RegionCtx(asn)
        z_cell = self.mg.MainGate(mg_cfg, asn.p).assign_value(ctx, self.z_in)
        asn.copy(z_cell.column, z_cell.row, inst, 0)
        out = self.step.synthesize_step(cfg, ctx, [z_cell])
        asn.copy(out[0].column, out[0].row, inst, 1)
        if self.corrupt is not None:
            self.corrupt(asn, cfg)


def _step(pkg, name):
    mod, make, _, _, _ = CASES[name]
    fr = j_bn256_fr if pkg == "sirius_tpu" else bn256_fr
    return make(importlib.import_module(f"{pkg}.gadgets.{mod}"), fr), fr


Z_IN = {name: None if case[2] is None else _rand(case[2]) for name, case in CASES.items()}


def _z_in(name, step):
    return step.tree.root if Z_IN[name] is None else Z_IN[name]


def _runner(pkg, name, corrupt=None):
    step, fr = _step(pkg, name)
    mg = importlib.import_module(f"{pkg}.gadgets.main_gate")
    circ = _StepAdapter(mg, step, _z_in(name, step), fr, corrupt)
    runner_cls = JRunner if pkg == "sirius_tpu" else CircuitRunner
    return runner_cls(CASES[name][3], fr, circ, circ.instances()), circ


def _ro():
    return PoseidonHash(poseidon_spec(bn256_fq, 3, 2, 4, 3))


def _trace(runner, circ):
    S = runner.collect_plonk_structure()
    return S, run_sps_protocol(S, MockCommitmentKey(BN256_G1, "cpu"), circ.instances(), runner.collect_witness(),
                               _ro())


@pytest.fixture(scope="module")
def synthesized():
    """name -> (JAX, port) (structure, witness, z_out), made once each."""
    out = {}

    def get(name):
        if name not in out:
            sides = []
            for pkg in ("sirius_tpu", "sirius_tpu_torch"):
                runner, circ = _runner(pkg, name)
                sides.append((runner.collect_plonk_structure(), runner.collect_witness(), circ.z_out))
            out[name] = sides
        return out[name]

    return get


@pytest.mark.parametrize("name", list(CASES))
def test_structure_and_witness_match_jax(synthesized, name):
    (jS, jW, jz), (S, W, z) = synthesized(name)
    assert structure_digest_stream(S) == j_structure_digest_stream(jS)
    assert S.permutation_data.mapping == jS.permutation_data.mapping
    assert (S.num_challenges, S.round_sizes) == (jS.num_challenges, jS.round_sizes)
    assert W == jW
    assert z == jz


@pytest.mark.parametrize("name", list(CASES))
def test_process_step_matches_jax(name):
    """Three seeded states through both packages' host step function (the
    Merkle step moves its host tree: three updates from the empty root)."""
    (jstep, jfr), (step, fr) = _step("sirius_tpu", name), _step("sirius_tpu_torch", name)
    z, jz = _z_in(name, step), _z_in(name, jstep)
    for _ in range(3):
        if CASES[name][2] is not None:
            z = jz = _rand(CASES[name][2])
        z, jz = step.process_step([z], None, fr)[0], jstep.process_step([jz], None, jfr)[0]
        assert z == jz


@pytest.mark.parametrize("name", list(CASES))
def test_trace_is_sat(name):
    runner, circ = _runner("sirius_tpu_torch", name)
    S, tr = _trace(runner, circ)
    assert S.num_challenges == {"range": 2, "xor": 3, "xor_lookup": 3, "spread_sha256": 3}.get(name, 1)
    satisfy.is_sat(S, MockCommitmentKey(BN256_G1, "cpu"), _ro(), tr.u, tr.w)


@pytest.mark.parametrize("name", LOOKUP_CASES)
def test_corrupted_lookup_cell_is_caught(name):
    """One looked-up advice cell, on the first row its lookup reads, moved
    off the table."""

    def corrupt(asn, cfg):
        col = CASES[name][4](cfg)
        row = next(r for r in range(asn.n) if asn.advice[col.index][r])
        asn.advice[col.index][row] = (asn.advice[col.index][row] + (1 << 20)) % asn.p

    runner, circ = _runner("sirius_tpu_torch", name, corrupt)
    S, tr = _trace(runner, circ)
    with pytest.raises(satisfy.IsSatError):
        satisfy.is_sat(S, MockCommitmentKey(BN256_G1, "cpu"), _ro(), tr.u, tr.w)
