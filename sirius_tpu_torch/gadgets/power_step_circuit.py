"""Parametric gate-degree step circuit: the port's own copy of
`sirius_tpu/gadgets/power_step_circuit.py`, the step of the gate-scaling
sweep.

The reference's `benches/ivc_gate_scaling.rs` sweeps folding cost against
custom-gate degree (2..9): Sangria's cross-term count and Cyclefold's
ProtoGalaxy polynomial domains both scale with the max gate degree, which is
the whole comparison the bench exists to draw.  This circuit contributes one
custom gate `s * (out - in^d)` of degree d+1 (with the selector), so the
SFC's folding degree is set by the `degree` parameter.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields.constants import FieldSpec
from .main_gate import MainGate, RegionCtx


@dataclass
class PowerStepCircuit:
    """z_{i+1} = z_i^degree + 1 via a dedicated degree-`degree` power gate."""

    field_spec: FieldSpec
    degree: int = 2
    arity: int = 1

    def instances(self):
        return []

    def configure(self, cs):
        mg_cfg = MainGate.configure(cs, T=5)
        col_in, col_out = cs.advice_column(), cs.advice_column()
        s = cs.selector()
        sq = cs.query(s)
        prod = cs.query(col_in)
        for _ in range(self.degree - 1):
            prod = prod * cs.query(col_in)
        cs.create_gate("power", [sq * (prod - cs.query(col_out))])
        return (mg_cfg, col_in, col_out, s)

    def process_step(self, z_i, k_table_size, spec):
        p = spec.modulus
        return [(pow(z_i[0] % p, self.degree, p) + 1) % p]

    def synthesize_step(self, config, ctx: RegionCtx, z_i):
        mg_cfg, col_in, col_out, s = config
        mg = MainGate(mg_cfg, ctx.asn.p)
        asn = ctx.asn
        p = asn.p
        v_in = z_i[0].value % p
        v_out = pow(v_in, self.degree, p)
        asn.enable_selector(s, 0)
        asn.assign_advice(col_in, 0, v_in)
        asn.assign_advice(col_out, 0, v_out)
        asn.copy(col_in, 0, z_i[0].column, z_i[0].row)
        out_cell = mg.assign_value(ctx, v_out)
        asn.copy(col_out, 0, out_cell.column, out_cell.row)
        return [mg.add_with_const(ctx, out_cell, 1)]
