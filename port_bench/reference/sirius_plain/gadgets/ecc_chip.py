"""On-circuit elliptic curve chip over the MainGate.

The port's own copy of `sirius_tpu/gadgets/ecc_chip.py`, with what the
port's paths use (the port imports nothing of the JAX package).

Replaces reference `src/gadgets/ecc/` (SURVEY.md §2.5): complete point
addition/doubling via case-select, and windowed double-and-add scalar
multiplication over bit cells.  The circuit field is the curve's *base*
field (the 2-cycle partner proves statements about the other curve's
points).  Infinity is encoded (0, 0) as in the reference's off-circuit
`Point` model.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from ..frontend.tape import inv0 as _inv0
from .main_gate import AssignedCell, MainGate, RegionCtx


@dataclass
class AssignedPoint:
    x: AssignedCell
    y: AssignedCell


class EccChip:
    """Reference `EccChip` (`gadgets/ecc/mod.rs:22`)."""

    def __init__(self, mg: MainGate, curve_a: int = 0):
        assert curve_a == 0, "a=0 curves only (bn256/grumpkin/pasta)"
        self.mg = mg

    # -- assignment -------------------------------------------------------------
    def assign_point(self, ctx: RegionCtx, xy: tuple[int, int] | None) -> AssignedPoint:
        """Witness a point ((0,0) = infinity); on-curve not enforced here
        (reference `EccGate::assign_point` is likewise unchecked)."""
        mg = self.mg
        x, y = xy if xy is not None else (0, 0)
        return AssignedPoint(mg.assign_value(ctx, x), mg.assign_value(ctx, y))

    def assign_affine(self, ctx: RegionCtx, pt) -> AssignedPoint:
        """From a gold AffinePoint."""
        if pt.is_identity:
            return self.assign_point(ctx, None)
        return self.assign_point(ctx, (pt.x, pt.y))

    # -- predicates --------------------------------------------------------------
    def is_infinity(self, ctx: RegionCtx, p: AssignedPoint) -> AssignedCell:
        """1 iff (x, y) == (0, 0)."""
        mg = self.mg
        zx = mg.is_zero_term(ctx, p.x)
        zy = mg.is_zero_term(ctx, p.y)
        return mg.mul(ctx, zx, zy)

    def conditional_select(self, ctx, cond, a: AssignedPoint, b: AssignedPoint) -> AssignedPoint:
        mg = self.mg
        return AssignedPoint(
            mg.conditional_select(ctx, cond, a.x, b.x),
            mg.conditional_select(ctx, cond, a.y, b.y),
        )

    # -- internal constrained division -------------------------------------------
    def _div_witness(self, ctx, num: AssignedCell, den: AssignedCell) -> AssignedCell:
        """lambda with lambda * den = num; den == 0 makes lambda
        unconstrained-but-witnessed-0 (callers must select away that case)."""
        mg, p = self.mg, self.mg.p
        dv = den.value % p
        lam = num.value * _inv0(dv, p) % p
        lam_cell = mg.assign_value(ctx, lam)
        # lam * den - num = 0 ... only enforceable when den != 0; to stay
        # complete we enforce lam*den - num*flag = 0 with flag = (den != 0):
        flag = mg.is_zero_term(ctx, den)  # 1 if den == 0
        # lam*den - num + num*flag = 0  <=>  lam*den = num*(1-flag)
        mg.apply(
            ctx,
            [lam_cell, den, num, flag],
            q_1=[0, 0, p - 1, 0],
            q_m=[1, 1],
            out_val=None,
            q_o=0,
        )
        return lam_cell

    # -- group law ---------------------------------------------------------------
    def _add_unsafe(self, ctx, a: AssignedPoint, b: AssignedPoint) -> AssignedPoint:
        """General chord addition (x1 != x2 assumed; otherwise meaningless
        values that callers select away)."""
        mg, p = self.mg, self.mg.p
        num = mg.sub(ctx, b.y, a.y)
        den = mg.sub(ctx, b.x, a.x)
        lam = self._div_witness(ctx, num, den)
        lam2 = mg.mul(ctx, lam, lam)
        x3 = mg.sub(ctx, mg.sub(ctx, lam2, a.x), b.x)
        y3 = mg.sub(ctx, mg.mul(ctx, lam, mg.sub(ctx, a.x, x3)), a.y)
        return AssignedPoint(x3, y3)

    def double(self, ctx, a: AssignedPoint) -> AssignedPoint:
        """Tangent doubling with y == 0 / infinity -> infinity."""
        mg, p = self.mg, self.mg.p
        x2 = mg.mul(ctx, a.x, a.x)
        three_x2 = mg.mul_by_const(ctx, x2, 3)
        two_y = mg.mul_by_const(ctx, a.y, 2)
        lam = self._div_witness(ctx, three_x2, two_y)
        lam2 = mg.mul(ctx, lam, lam)
        x3 = mg.sub(ctx, mg.sub(ctx, lam2, a.x), a.x)
        y3 = mg.sub(ctx, mg.mul(ctx, lam, mg.sub(ctx, a.x, x3)), a.y)
        y_zero = mg.is_zero_term(ctx, a.y)
        zero = mg.assign_constant(ctx, 0)
        inf = AssignedPoint(zero, zero)
        return self.conditional_select(ctx, y_zero, inf, AssignedPoint(x3, y3))

    def add(self, ctx, a: AssignedPoint, b: AssignedPoint) -> AssignedPoint:
        """Complete addition (reference `EccChip::add`, `ecc/mod.rs:60`)."""
        mg, p = self.mg, self.mg.p
        a_inf = self.is_infinity(ctx, a)
        b_inf = self.is_infinity(ctx, b)
        dx = mg.sub(ctx, b.x, a.x)
        dy = mg.sub(ctx, b.y, a.y)
        x_eq = mg.is_zero_term(ctx, dx)  # 1 if same x
        y_eq = mg.is_zero_term(ctx, dy)
        general = self._add_unsafe(ctx, a, b)
        doubled = self.double(ctx, a)
        zero = mg.assign_constant(ctx, 0)
        inf = AssignedPoint(zero, zero)

        # same x: if same y -> double else infinity
        same_x_case = self.conditional_select(ctx, y_eq, doubled, inf)
        out = self.conditional_select(ctx, x_eq, same_x_case, general)
        out = self.conditional_select(ctx, b_inf, a, out)
        out = self.conditional_select(ctx, a_inf, b, out)
        return out

    # -- incomplete (fast) ops ---------------------------------------------------
    def add_incomplete(self, ctx, a: AssignedPoint, b: AssignedPoint) -> AssignedPoint:
        """Chord addition assuming x1 != x2 (reference `scalar_mul_non_zero`
        fast path).  ~9 rows.  On the exceptional cases the constraints stay
        satisfiable but the value is meaningless — callers must ensure the
        case cannot matter (e.g. results selected away or probabilistically
        impossible for random commitments; see PARITY.md)."""
        mg, p = self.mg, self.mg.p
        num = mg.sub(ctx, b.y, a.y)
        den = mg.sub(ctx, b.x, a.x)
        dv = den.value % p
        lam_v = num.value * _inv0(dv, p) % p
        lam = mg.assign_value(ctx, lam_v)
        # lam * den - num = 0
        mg.apply(ctx, [lam, den, num], q_1=[0, 0, p - 1], q_m=[1, 0])
        lam2 = mg.mul(ctx, lam, lam)
        x3 = mg.sub(ctx, mg.sub(ctx, lam2, a.x), b.x)
        y3 = mg.sub(ctx, mg.mul(ctx, lam, mg.sub(ctx, a.x, x3)), a.y)
        return AssignedPoint(x3, y3)

    def double_incomplete(self, ctx, a: AssignedPoint) -> AssignedPoint:
        """Tangent doubling assuming y != 0.  ~8 rows."""
        mg, p = self.mg, self.mg.p
        x2 = mg.mul(ctx, a.x, a.x)
        three_x2 = mg.mul_by_const(ctx, x2, 3)
        two_y = mg.mul_by_const(ctx, a.y, 2)
        tv = two_y.value % p
        lam_v = three_x2.value * _inv0(tv, p) % p
        lam = mg.assign_value(ctx, lam_v)
        mg.apply(ctx, [lam, two_y, three_x2], q_1=[0, 0, p - 1], q_m=[1, 0])
        lam2 = mg.mul(ctx, lam, lam)
        x3 = mg.sub(ctx, mg.sub(ctx, lam2, a.x), a.x)
        y3 = mg.sub(ctx, mg.mul(ctx, lam, mg.sub(ctx, a.x, x3)), a.y)
        return AssignedPoint(x3, y3)

    def scalar_mul_fast(self, ctx, p0: AssignedPoint, bits: Sequence[AssignedCell]) -> AssignedPoint:
        """Double-and-add with incomplete ops + infinity tracked as a select
        chain off the accumulator (acc starts 'empty'): ~19 rows/bit.
        Completeness caveats as `add_incomplete`."""
        mg = self.mg
        zero = mg.assign_constant(ctx, 0)
        one = mg.assign_constant(ctx, 1)
        acc = AssignedPoint(zero, zero)
        acc_empty = one  # 1 while acc is still the identity
        for bit in reversed(list(bits)):
            doubled = self.double_incomplete(ctx, acc)
            acc = self.conditional_select(ctx, acc_empty, acc, doubled)
            added = self.add_incomplete(ctx, acc, p0)
            # if acc empty and bit: acc = p0; elif bit: acc = acc + p0
            take_p0 = mg.mul(ctx, acc_empty, bit)
            with_add = self.conditional_select(ctx, bit, added, acc)
            acc = self.conditional_select(ctx, take_p0, p0, with_add)
            # acc_empty' = acc_empty * (1 - bit)
            not_bit = mg.sub(ctx, one, bit)
            acc_empty = mg.mul(ctx, acc_empty, not_bit)
        return acc
