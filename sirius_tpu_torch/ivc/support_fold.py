"""The Cyclefold support-fold chain.

Counterpart of the support half of `sirius_tpu/ivc/cyclefold_ivc.py`
(`CyclefoldPublicParams` support structure, `CyclefoldIVC.next`'s loop of
support folds and `verify`'s support `is_sat`): every fold synthesizes the
EC co-processor circuit `SupportCircuit` (p_out = l0 p0 + l1 p1 over
bn256 points, native on grumpkin's scalar field), runs the 0-challenge SPS
on the grumpkin key and folds the trace into a Sangria accumulator.  The
circuit's witness is a native replay of the support tape, which
`support_structure` traces during its dry synthesis
(`frontend/taped.py`); `SupportFoldChain.witness_direct` is its plain
version.  The public-parameter digest is supplied by the caller
(`ivc/cyclefold_ivc.py` passes its pp digest; the identity when none is
given).  Under an active mesh that divides its 2^k rows the chain's
traces, W and E are row blocks (`parallel/rows.py`), as the JAX package's
process-wide mesh shards the support fold too.
"""

from __future__ import annotations

import numpy as np

from ..fields import gold
from ..fields.constants import bn256_fq, bn256_fr, bn256_g1, grumpkin
from ..frontend.runner import CircuitRunner
from ..frontend.tape import TapeBuilder
from ..frontend.taped import TapedSynthesis, _TrPoint, point_leaves
from ..nifs.sangria import RelaxedPlonkInstance, RelaxedPlonkTrace, RelaxedPlonkWitness, VanillaFS
from ..ops.poseidon import PoseidonHash
from ..plonk.sps import run_sps_protocol
from ..plonk.structure import PlonkStructure
from ..util.profiling import span
from ..util.ro import default_ro_spec
from .support_circuit import InstanceInput, SupportCircuit

SUPPORT_K = 14
SUPPORT_IO = 8


def support_structure(k: int = SUPPORT_K) -> tuple[PlonkStructure, TapedSynthesis]:
    """The support circuit's structure (shape-stable across inputs) and its
    witness tape, both from one dry synthesis over traced inputs."""
    tape = TapeBuilder()
    si = tape.inputs(6)
    inp = InstanceInput(_TrPoint(si[0], si[1]), _TrPoint(si[2], si[3]), si[4], si[5])
    runner = CircuitRunner(k, bn256_fq, SupportCircuit(inp, num_bits=bn256_fr.num_bits), [[0] * SUPPORT_IO])
    S = runner.collect_plonk_structure()
    if S.num_challenges != 0:
        raise ValueError("support circuit must take the 0-challenge SPS path")
    return S, TapedSynthesis(tape, runner._asn, named={})


def _sup_flatten(inp: InstanceInput) -> list[int]:
    """The support tape's inputs: p0, p1 (identity as (0, 0)), l0, l1."""
    return [*point_leaves(inp.p0), *point_leaves(inp.p1), inp.l0, inp.l1]


def random_input(rng: np.random.Generator) -> InstanceInput:
    """A support-circuit input drawn from `rng`: p0, p1 = s * G on bn256
    (s < 2^62) and 254-bit scalars l0, l1 < r."""
    G = gold.generator(bn256_g1)
    s0, s1 = (int(v) for v in rng.integers(1, 1 << 62, size=2))
    l0, l1 = (int.from_bytes(rng.bytes(32), "little") % bn256_fr.modulus for _ in range(2))
    return InstanceInput(G.mul(s0), G.mul(s1), l0, l1)


def support_ro() -> PoseidonHash:
    return PoseidonHash(default_ro_spec(bn256_fr))


class SupportFoldChain:
    """A Sangria accumulator over support-circuit traces on key `ck`
    (a grumpkin `CommitmentKey`, or a test double); `S` and `taped` are
    `support_structure(k)`'s."""

    def __init__(self, ck, S: PlonkStructure, taped: TapedSynthesis, pp_digest=None, k: int = SUPPORT_K):
        self.ck = ck
        self.S = S
        self.taped = taped
        self.k = k
        self.pp, self.vp = VanillaFS.setup_params(pp_digest or gold.identity(grumpkin), S)
        self.acc = RelaxedPlonkTrace(
            U=RelaxedPlonkInstance.new(grumpkin, 0, 1, 0, markers_len=SUPPORT_IO),
            W=RelaxedPlonkWitness.zeros(S.field, S.round_sizes, S.n, ck.device),
        )
        self.initial_U = self.acc.U
        self.incoming = []  # PlonkInstance per fold
        self.cross = []  # cross-term commitments per fold
        self.pub_instances = []

    def witness(self, inp: InstanceInput):
        """(instances, advice columns) of one support circuit, the columns by
        native replay of the support tape."""
        W, _ = self.taped.replay(_sup_flatten(inp))
        return [inp.into_instance(bn256_fq.modulus)], W

    def witness_direct(self, inp: InstanceInput):
        """The replay's plain version: `witness` by direct synthesis."""
        instances = [inp.into_instance(bn256_fq.modulus)]
        circuit = SupportCircuit(inp, num_bits=bn256_fr.num_bits)
        return instances, CircuitRunner(self.k, bn256_fq, circuit, instances).collect_witness()

    def fold(self, inp: InstanceInput) -> None:
        """Fold one support circuit, in spans `support_witness`,
        `support_sps` and `support_sangria_prove`."""
        with span("support_witness"):
            instances, advice = self.witness(inp)
        with span("support_sps"):
            trace = run_sps_protocol(self.S, self.ck, instances, advice, support_ro())
        with span("support_sangria_prove"):
            self.acc, cross = VanillaFS.prove(self.ck, self.pp, support_ro(), self.acc, trace)
        self.incoming.append(trace.u)
        self.cross.append(cross)
        self.pub_instances.append(trace.u.instances)

    def verify(self) -> RelaxedPlonkInstance:
        """Replay every fold on the instance side; returns the verifier's
        accumulator instance (equal to the prover's for an honest chain)."""
        U = self.initial_U
        for U2, cross in zip(self.incoming, self.cross):
            U = VanillaFS.verify(self.vp, grumpkin, support_ro(), support_ro(), U, U2, cross)
        return U

    def is_sat(self, acc: RelaxedPlonkTrace | None = None) -> list:
        """Errors of the accumulator (or of `acc`, e.g. a corrupted copy)."""
        return VanillaFS.is_sat(self.ck, self.S, acc or self.acc, self.pub_instances)
