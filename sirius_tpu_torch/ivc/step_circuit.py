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
    """User trait (reference `step_circuit.rs:52-147`); arity is the length
    of the state vector z."""

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
