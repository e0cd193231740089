"""Poseidon-hash step circuit: the port's own copy of
`sirius_tpu/gadgets/poseidon_step_circuit.py` (reference
`gadgets/poseidon_step_circuit.rs`: the `TestPoseidonCircuit` of the
`sangria_poseidon` bench).

z_{i+1} = Poseidon(z_i, 0, 1, ..., repeat_count-1).  It registers a MainGate
of its own, so its SFC's folding degree is 6 and its SPS takes one
challenge.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields.constants import FieldSpec
from ..ops.poseidon import PoseidonHash
from ..util.ro import default_ro_spec
from .main_gate import MainGate, RegionCtx
from .poseidon_chip import PoseidonChip


@dataclass
class PoseidonStepCircuit:
    """Arity-1 step circuit hashing the state with `repeat_count` constants."""

    field: FieldSpec
    repeat_count: int = 1
    arity: int = 1

    def configure(self, cs):
        return MainGate.configure(cs, T=5)

    def instances(self):
        return []

    def synthesize_step(self, config, ctx: RegionCtx, z_i):
        chip = PoseidonChip(MainGate(config, ctx.asn.p), default_ro_spec(self.field))
        chip.absorb_cell(z_i[0])
        for i in range(self.repeat_count):
            chip.absorb_base(i)
        return [chip.squeeze(ctx)]

    def process_step(self, z_i, k_table_size, spec):
        ro = PoseidonHash(default_ro_spec(self.field))
        ro.absorb_field(z_i[0] % self.field.modulus)
        for i in range(self.repeat_count):
            ro.absorb_field(i)
        return [ro.squeeze(self.field.num_bits) % spec.modulus]
