"""Range-check step circuit using a lookup argument: the port's own copy
of `sirius_tpu/gadgets/range_step_circuit.py` (the analogue of the
reference's `fibo_circuit_with_lookup` step circuits, SURVEY.md §4):

  z_{i+1} = low64(z_i^2 + z_i + 5)

The low-64 reduction is proven with a byte-decomposition whose chunks are
range-checked against a fixed 256-entry table via a Protostar
log-derivative lookup — which upgrades the host SFC to the 2-round SPS
protocol (lookup coefficient round + compression challenges), exercising
multi-commitment/multi-challenge instances through the whole IVC stack.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..fields.constants import FieldSpec
from .main_gate import MainGate, RegionCtx

TABLE_BITS = 8


@dataclass
class RangeCheckStepCircuit:
    """z' = low64(z^2 + z + 5) with byte-lookup range proofs."""

    field_spec: FieldSpec
    arity: int = 1
    LOW_BITS = 64

    def instances(self):
        return []

    def configure(self, cs):
        mg_cfg = MainGate.configure(cs, T=5)
        a = cs.advice_column()
        t = cs.fixed_column()
        cs.lookup([cs.query(a)], [cs.query(t)])
        return (mg_cfg, a, t)

    def process_step(self, z_i, k_table_size, spec):
        z = z_i[0] % spec.modulus
        v = (z * z + z + 5) % spec.modulus
        lo = v & ((1 << self.LOW_BITS) - 1)
        hi = v >> self.LOW_BITS
        assert hi < (1 << 72), "inductive 64-bit bound violated"
        return [lo]

    def synthesize_step(self, config, ctx: RegionCtx, z_i):
        mg_cfg, a, t = config
        mg = MainGate(mg_cfg, ctx.asn.p)
        asn = ctx.asn
        # witness recomputed from z_i: a pure function of the state
        p = ctx.asn.p
        zv = z_i[0].value
        vv = (zv * zv + zv + 5) % p
        lo_v = vv & ((1 << self.LOW_BITS) - 1)
        hi_v = vv >> self.LOW_BITS
        w = {
            "lo_bytes": [(lo_v >> (8 * j)) & 0xFF for j in range(8)],
            "hi_bytes": [(hi_v >> (8 * j)) & 0xFF for j in range(9)],
        }

        # fixed byte table (all rows; extra rows hold repeats, incl. 0)
        n = 1 << asn.k
        for row in range(n):
            asn.assign_fixed(t, row, row % (1 << TABLE_BITS))

        # byte chunks live in the lookup column; mirror cells in MainGate
        # rows carry the arithmetic (copy-constrained together)
        def chunk_cells(values, base_row):
            cells = []
            for j, v in enumerate(values):
                asn.assign_advice(a, base_row + j, v)
                c = mg.assign_value(ctx, v)
                asn.copy(a, base_row + j, c.column, c.row)
                cells.append(c)
            return cells

        lo_cells = chunk_cells(w["lo_bytes"], 0)
        hi_cells = chunk_cells(w["hi_bytes"], 8)

        def recompose(cells):
            acc = mg.mul_by_const(ctx, cells[-1], 1)
            for c in reversed(cells[:-1]):
                acc = mg.mul_by_const(ctx, acc, 1 << 8)
                shifted = mg.add(ctx, acc, c)
                acc = shifted
            return acc

        lo = recompose(lo_cells)
        hi = recompose(hi_cells)

        # v = z^2 + z + 5  must equal  hi * 2^64 + lo
        z = z_i[0]
        z2 = mg.mul(ctx, z, z)
        v = mg.add_with_const(ctx, mg.add(ctx, z2, z), 5)
        hi_shift = mg.mul_by_const(ctx, hi, 1 << self.LOW_BITS)
        rhs = mg.add(ctx, hi_shift, lo)
        ctx.constrain_equal(v, rhs)
        return [lo]
