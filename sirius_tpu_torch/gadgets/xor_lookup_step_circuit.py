"""XOR-via-lookup step circuit, the port's own copy of
`sirius_tpu/gadgets/xor_lookup_step_circuit.py`: the minimal
lookup-bearing IVC step.

The reference's lookup-heavy step circuits (e.g. `examples/sha256` table16,
`examples/sha256/main.rs:363-432`) are foldable only through the cyclefold
IVC; this is the smallest circuit exercising that path: a vector lookup
(3-round SPS) inside the step, so the primary trace carries 3 W-commitments
and each fold delegates 3 support-circuit scalar-muls.

    z' = z XOR key,  with (z, key, z') constrained by a fixed 2-bit XOR table.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..frontend.circuit import ConstraintSystemBuilder
from ..gadgets.main_gate import RegionCtx

XOR_BITS = 2


@dataclass
class XorLookupStepCircuit:
    """arity-1 state in [0, 2^XOR_BITS); z' = z ^ key via vector lookup."""

    key: int = 3
    arity: int = 1

    def configure(self, cs: ConstraintSystemBuilder):
        a = cs.advice_column()
        b = cs.advice_column()
        c = cs.advice_column()
        s = cs.selector()
        t_a = cs.fixed_column()
        t_b = cs.fixed_column()
        t_c = cs.fixed_column()
        sq = cs.query(s)
        cs.lookup(
            [sq * cs.query(a), sq * cs.query(b), sq * cs.query(c)],
            [cs.query(t_a), cs.query(t_b), cs.query(t_c)],
        )
        # bind the second lookup operand to the fixed key
        cs.create_gate("xor-key", [sq * (cs.query(b) - (self.key & ((1 << XOR_BITS) - 1)))])
        return (a, b, c, s, t_a, t_b, t_c)

    def instances(self) -> list[list[int]]:
        return []

    def synthesize_step(self, config, ctx: RegionCtx, z_i):
        a, b, c, s, t_a, t_b, t_c = config
        asn = ctx.asn
        n = 1 << XOR_BITS
        for x in range(n):
            for y in range(n):
                row = x * n + y
                asn.assign_fixed(t_a, row, x)
                asn.assign_fixed(t_b, row, y)
                asn.assign_fixed(t_c, row, x ^ y)
        v = z_i[0].value
        assert v < n, "XorLookupStepCircuit state out of range"
        key = self.key & (n - 1)
        asn.enable_selector(s, ctx.offset)
        a_cell = ctx.assign_advice(a, v)
        ctx.constrain_equal(z_i[0], a_cell)
        ctx.assign_advice(b, key)
        out = ctx.assign_advice(c, v ^ key)
        ctx.next()
        return [out]

    def process_step(self, z_i, k_table_size, spec):
        n = 1 << XOR_BITS
        return [(z_i[0] % n) ^ (self.key & (n - 1))]
