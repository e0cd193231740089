"""StepCircuit: the user-facing IVC step API.

The port's own copy of `sirius_tpu/ivc/step_circuit.py`: the protocol and
the trivial step circuit.  A step circuit computes z_{i+1} = F(z_i) inside
the augmented folding circuit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, Sequence

from ..fields.constants import FieldSpec
from ..frontend.circuit import ConstraintSystemBuilder
from ..gadgets.main_gate import AssignedCell, RegionCtx


class StepCircuit(Protocol):
    """User trait (reference `step_circuit.rs:52-147`).

    arity: length of the state vector z.

    Stateful circuits, ones whose `synthesize_step` witnesses per-step data
    beyond z_i (e.g. a Merkle authentication path), must additionally
    implement the dynamic-witness pair so the taped synthesis
    (frontend/taped.py) can capture those values as tape inputs:

        dynamic_witness() -> list[int]   # flatten the current step's extra
                                         # witness, fixed length per shape
        bind_witness(vals) -> None       # install (possibly traced) values

    Circuits without these methods are treated as pure functions of z_i.
    A stateful circuit that omits them fails loudly: the driver cross-checks
    the replayed X1 marker against the host-computed one every step.
    """

    arity: int

    def configure(self, cs: ConstraintSystemBuilder): ...

    def synthesize_step(self, config, ctx: RegionCtx, z_i: Sequence[AssignedCell]) -> list[AssignedCell]: ...

    def instances(self) -> list[list[int]]:
        """The step circuit's own public instance columns."""
        ...

    def process_step(self, z_i: Sequence[int], k_table_size: int, spec: FieldSpec) -> list[int]:
        """Off-circuit z_out."""
        ...


@dataclass
class TrivialStepCircuit:
    """Identity step F(z) = z (reference `step_circuit.rs::trivial`)."""

    arity: int

    def configure(self, cs: ConstraintSystemBuilder):
        return None

    def instances(self) -> list[list[int]]:
        return []

    def synthesize_step(self, config, ctx, z_i):
        return list(z_i)

    def process_step(self, z_i, k_table_size, spec):
        return [v % spec.modulus for v in z_i]
