"""Vector-lookup step circuit, the port's own copy of
`sirius_tpu/gadgets/xor_step_circuit.py`: z' = z + (n1 XOR n2) where n1/n2
are the two low nibbles of z, proven against a 3-column (x, y, x^y) table.

A multi-column (vector) lookup upgrades the SFC to the reference's 3-round
SPS protocol (`plonk/mod.rs:581-662`): three witness commitments and three
challenges, the last untested SPS mode in the IVC stack (rounds 0/1/2 are
covered by the trivial/poseidon/range step circuits).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..fields.constants import FieldSpec
from .main_gate import MainGate, RegionCtx

NIBBLE = 4


@dataclass
class XorStepCircuit:
    """z_{i+1} = z_i + xor(nibble0(z_i), nibble1(z_i))."""

    field_spec: FieldSpec
    arity: int = 1

    def instances(self):
        return []

    def configure(self, cs):
        mg_cfg = MainGate.configure(cs, T=5)
        a, b, c = cs.advice_column(), cs.advice_column(), cs.advice_column()
        t1, t2, t3 = cs.fixed_column(), cs.fixed_column(), cs.fixed_column()
        cs.lookup(
            [cs.query(a), cs.query(b), cs.query(c)],
            [cs.query(t1), cs.query(t2), cs.query(t3)],
        )
        return (mg_cfg, (a, b, c), (t1, t2, t3))

    def process_step(self, z_i, k_table_size, spec):
        z = z_i[0] % spec.modulus
        x = (z & 0xF) ^ ((z >> NIBBLE) & 0xF)
        return [(z + x) % spec.modulus]

    def synthesize_step(self, config, ctx: RegionCtx, z_i):
        mg_cfg, (a, b, c), (t1, t2, t3) = config
        mg = MainGate(mg_cfg, ctx.asn.p)
        asn = ctx.asn
        # witness values recomputed from z_i so the circuit stays a pure
        # function of its state
        zv = z_i[0].value
        w = {"x": ((zv & 0xF) ^ ((zv >> NIBBLE) & 0xF))}

        # (x, y, x^y) table over 4-bit operands; row 0 repeats (0,0,0)
        for row in range(1 << asn.k):
            x = (row >> NIBBLE) & 0xF if row < 256 else 0
            y = row & 0xF if row < 256 else 0
            asn.assign_fixed(t1, row, x)
            asn.assign_fixed(t2, row, y)
            asn.assign_fixed(t3, row, x ^ y)

        # nibble decomposition of z (sound: bits recompose to z)
        bits = mg.le_num_to_bits(ctx, z_i[0], self.field_spec.num_bits)
        n1 = mg.le_bits_to_num(ctx, bits[:NIBBLE])
        n2 = mg.le_bits_to_num(ctx, bits[NIBBLE : 2 * NIBBLE])

        # lookup row 0 carries (n1, n2, x); copy-link to MainGate cells
        x_cell = mg.assign_value(ctx, w["x"])
        for col, cell in ((a, n1), (b, n2), (c, x_cell)):
            asn.assign_advice(col, 0, cell.value)
            asn.copy(col, 0, cell.column, cell.row)

        return [mg.add(ctx, z_i[0], x_cell)]
