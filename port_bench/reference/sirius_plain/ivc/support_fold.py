"""The Cyclefold support-fold chain, as the verifier holds it.

Counterpart of the support half of `sirius_tpu/ivc/cyclefold_ivc.py`: the
support circuit's structure (the EC co-processor circuit `SupportCircuit`,
p_out = l0 p0 + l1 p1 over bn256 points, native on grumpkin's scalar
field), collected by a dry synthesis over traced inputs, and the Sangria
accumulator's `is_sat` over the public instances of every folded trace.
The prover (the folds) is left out.
"""

from __future__ import annotations

from ..fields.constants import bn256_fq, bn256_fr
from ..frontend.runner import CircuitRunner
from ..frontend.tape import TapeBuilder
from ..frontend.taped import _TrPoint
from ..nifs.sangria import RelaxedPlonkTrace, VanillaFS
from ..plonk.structure import PlonkStructure
from .support_circuit import InstanceInput, SupportCircuit

SUPPORT_K = 14
SUPPORT_IO = 8


def support_structure(k: int = SUPPORT_K) -> PlonkStructure:
    """The support circuit's structure (shape-stable across inputs), from a
    dry synthesis over traced inputs."""
    tape = TapeBuilder()
    si = tape.inputs(6)
    inp = InstanceInput(_TrPoint(si[0], si[1]), _TrPoint(si[2], si[3]), si[4], si[5])
    runner = CircuitRunner(k, bn256_fq, SupportCircuit(inp, num_bits=bn256_fr.num_bits), [[0] * SUPPORT_IO])
    S = runner.collect_plonk_structure()
    if S.num_challenges != 0:
        raise ValueError("support circuit must take the 0-challenge SPS path")
    return S


class SupportFoldChain:
    """The support chain's Sangria accumulator `acc` on key `ck` (a grumpkin
    `CommitmentKey`, or a test double) with structure `S`, and the public
    instances of every support trace folded into it."""

    def __init__(self, ck, S: PlonkStructure, acc: RelaxedPlonkTrace, pub_instances: list):
        self.ck, self.S, self.acc, self.pub_instances = ck, S, acc, pub_instances

    def is_sat(self) -> list:
        """Errors of the accumulator."""
        return VanillaFS.is_sat(self.ck, self.S, self.acc, self.pub_instances)
