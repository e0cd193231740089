"""Cyclefold support circuit: the tiny EC co-processor.

The port's own copy of `sirius_tpu/ivc/support_circuit.py`, with what the
port's paths use (the port imports nothing of the JAX package).

Replaces reference `src/ivc/cyclefold/support_circuit/` (SURVEY.md §2.5):
proves p_out = l0*p0 + l1*p1 on the paired curve with every value public:

    instance = [p0.x, p0.y, p1.x, p1.y, l0, l1, p_out.x, p_out.y]

The reference builds this over its own width-2 `tiny_gate`; we reuse the
MainGate + EccChip (documented layout deviation, PARITY.md item 2).  The
circuit field is the support curve's scalar field = the main curve's base
field, so the EC arithmetic is native.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields import gold
from ..frontend.circuit import Assignment, ConstraintSystemBuilder
from ..gadgets.ecc_chip import EccChip
from ..gadgets.main_gate import MainGate, RegionCtx


@dataclass
class InstanceInput:
    """Off-circuit input builder (reference `support_circuit/mod.rs:43-64`)."""

    p0: gold.AffinePoint
    p1: gold.AffinePoint
    l0: int
    l1: int

    def p_out(self) -> gold.AffinePoint:
        return self.p0.mul(self.l0).add(self.p1.mul(self.l1))


class SupportCircuit:
    """p_out = l0*p0 + l1*p1 (reference `support_circuit/mod.rs:24-65`)."""

    MIN_K = 14

    def __init__(self, inp: InstanceInput, num_bits: int):
        self.inp = inp
        self.num_bits = num_bits  # scalar bit width for l0/l1

    def configure(self, cs: ConstraintSystemBuilder):
        cfg = MainGate.configure(cs, T=5)
        inst = cs.instance_column()
        return cfg, inst

    def synthesize(self, config, asn: Assignment):
        cfg, inst = config
        mg = MainGate(cfg, asn.p)
        ecc = EccChip(mg)
        ctx = RegionCtx(asn)

        p0 = ecc.assign_affine(ctx, self.inp.p0)
        p1 = ecc.assign_affine(ctx, self.inp.p1)
        l0 = mg.assign_value(ctx, self.inp.l0)
        l1 = mg.assign_value(ctx, self.inp.l1)
        l0_bits = mg.le_num_to_bits(ctx, l0, self.num_bits)
        l1_bits = mg.le_num_to_bits(ctx, l1, self.num_bits)
        # fast (incomplete) scalar muls: identity/garbage edge cases cannot
        # occur for honest full-width scalars, and the all-zero base case
        # degenerates to the identity correctly (reference uses the same
        # `scalar_mul_non_zero` trade-off)
        r0 = ecc.scalar_mul_fast(ctx, p0, l0_bits)
        r1 = ecc.scalar_mul_fast(ctx, p1, l1_bits)
        out = ecc.add(ctx, r0, r1)

        for i, cell in enumerate([p0.x, p0.y, p1.x, p1.y, l0, l1, out.x, out.y]):
            asn.copy(cell.column, cell.row, inst, i)
        self.out_value = (out.x.value, out.y.value)
