"""MainGate: the width-T universal custom gate + region synthesis helpers.

The port's own copy of `sirius_tpu/gadgets/main_gate.py`, with what the
port's paths use (the port imports nothing of the JAX package).

Replaces reference `src/main_gate.rs` (SURVEY.md §2.5).  The gate polynomial
is the reference's universal form (`main_gate.rs:558-583`):

    q_m0*s0*s1 + q_m1*s2*s3 + sum_i q_1i*s_i + sum_i q_5i*s_i^5
      + rc + q_i*input + q_o*out = 0

Cell layout inside a row is our own (idiomatic to this frontend), not a
replica of halo2's region/floor-planner placement; all on-circuit gadgets in
this package share it, so off-circuit and on-circuit computations stay
mutually consistent (see PARITY.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from ..frontend.circuit import Assignment, Column, ConstraintSystemBuilder
from ..frontend.tape import bit as _bit, inv0 as _inv0, is_zero as _is_zero


@dataclass(frozen=True)
class AssignedCell:
    """A witnessed cell: column + row + known value (host int)."""

    column: Column
    row: int
    value: int


@dataclass
class MainGateConfig:
    T: int
    state: list[Column]
    input: Column
    out: Column
    q_1: list[Column]
    q_5: list[Column]
    q_m: list[Column]  # 2 columns
    q_i: Column
    q_o: Column
    rc: Column


class RegionCtx:
    """Row cursor over an Assignment (reference `main_gate.rs:21-116`)."""

    def __init__(self, asn: Assignment, offset: int = 0):
        self.asn = asn
        self.offset = offset

    def next(self):
        self.offset += 1

    def assign_advice(self, col: Column, value: int) -> AssignedCell:
        v = value % self.asn.p
        self.asn.assign_advice(col, self.offset, v)
        return AssignedCell(col, self.offset, v)

    def assign_fixed(self, col: Column, value: int):
        self.asn.assign_fixed(col, self.offset, value)

    def constrain_equal(self, a: AssignedCell, b: AssignedCell):
        self.asn.copy(a.column, a.row, b.column, b.row)

    def copy_to(self, cell: AssignedCell, col: Column) -> AssignedCell:
        """Assign cell's value into `col` at the current row and link them."""
        new = self.assign_advice(col, cell.value)
        self.asn.copy(cell.column, cell.row, col, self.offset)
        return new


class MainGate:
    """Gadget library over the universal gate."""

    def __init__(self, config: MainGateConfig, p: int):
        self.cfg = config
        self.p = p

    @staticmethod
    def configure(cs: ConstraintSystemBuilder, T: int = 5) -> MainGateConfig:
        state = [cs.advice_column() for _ in range(T)]
        inp = cs.advice_column()
        out = cs.advice_column()
        q_1 = [cs.fixed_column() for _ in range(T)]
        q_5 = [cs.fixed_column() for _ in range(T)]
        q_m = [cs.fixed_column() for _ in range(2)]
        q_i = cs.fixed_column()
        q_o = cs.fixed_column()
        rc = cs.fixed_column()

        def q(c):
            return cs.query(c)

        expr = q(rc) + q(q_i) * q(inp) + q(q_o) * q(out)
        if T >= 2:
            expr = expr + q(q_m[0]) * q(state[0]) * q(state[1])
        if T >= 4:
            expr = expr + q(q_m[1]) * q(state[2]) * q(state[3])
        for i in range(T):
            si = q(state[i])
            expr = expr + q(q_1[i]) * si
            expr = expr + q(q_5[i]) * (si * si * si * si * si)
        cs.create_gate("main_gate", [expr])

        return MainGateConfig(T, state, inp, out, q_1, q_5, q_m, q_i, q_o, rc)

    # -- generic row ------------------------------------------------------------
    def apply(
        self,
        ctx: RegionCtx,
        state_cells: Sequence[Optional[AssignedCell | int]],
        q_1: Sequence[int] = (),
        q_5: Sequence[int] = (),
        q_m: Sequence[int] = (0, 0),
        rc: int = 0,
        input_cell: Optional[AssignedCell | int] = None,
        q_i: int = 0,
        out_val: Optional[int] = None,
        q_o: int = 0,
    ) -> Optional[AssignedCell]:
        """Assign one universal-gate row.

        state_cells entries may be AssignedCells (copied in), raw ints
        (fresh witnesses), or None (zero).  Returns the out cell when q_o != 0.
        """
        cfg, p = self.cfg, self.p
        for i, v in enumerate(state_cells):
            if v is None:
                continue
            if isinstance(v, AssignedCell):
                ctx.copy_to(v, cfg.state[i])
            else:
                ctx.assign_advice(cfg.state[i], v)
        for i, coef in enumerate(q_1):
            if coef:
                ctx.assign_fixed(cfg.q_1[i], coef)
        for i, coef in enumerate(q_5):
            if coef:
                ctx.assign_fixed(cfg.q_5[i], coef)
        for i, coef in enumerate(q_m):
            if coef:
                ctx.assign_fixed(cfg.q_m[i], coef)
        if rc:
            ctx.assign_fixed(cfg.rc, rc)
        if input_cell is not None:
            if isinstance(input_cell, AssignedCell):
                ctx.copy_to(input_cell, cfg.input)
            else:
                ctx.assign_advice(cfg.input, input_cell)
        if q_i:
            ctx.assign_fixed(cfg.q_i, q_i)
        out = None
        if q_o:
            assert out_val is not None
            ctx.assign_fixed(cfg.q_o, q_o)
            out = ctx.assign_advice(cfg.out, out_val)
        ctx.next()
        return out

    # -- arithmetic helpers ------------------------------------------------------
    def _cv(self, c: AssignedCell | int) -> int:
        return c.value if isinstance(c, AssignedCell) else c % self.p

    def add(self, ctx, a, b) -> AssignedCell:
        p = self.p
        out = (self._cv(a) + self._cv(b)) % p
        return self.apply(ctx, [a, b], q_1=[1, 1], out_val=out, q_o=p - 1)

    def sub(self, ctx, a, b) -> AssignedCell:
        p = self.p
        out = (self._cv(a) - self._cv(b)) % p
        return self.apply(ctx, [a, b], q_1=[1, p - 1], out_val=out, q_o=p - 1)

    def mul(self, ctx, a, b) -> AssignedCell:
        p = self.p
        out = self._cv(a) * self._cv(b) % p
        return self.apply(ctx, [a, b], q_m=[1, 0], out_val=out, q_o=p - 1)

    def mul_by_const(self, ctx, a, k: int) -> AssignedCell:
        p = self.p
        out = self._cv(a) * k % p
        return self.apply(ctx, [a], q_1=[k % p], out_val=out, q_o=p - 1)


    def add_with_const(self, ctx, a, k: int) -> AssignedCell:
        p = self.p
        out = (self._cv(a) + k) % p
        return self.apply(ctx, [a], q_1=[1], rc=k % p, out_val=out, q_o=p - 1)

    def assign_value(self, ctx, v: int) -> AssignedCell:
        """Witness a value with no constraint (freely assigned state cell)."""
        cell = ctx.assign_advice(self.cfg.state[0], v)
        ctx.next()
        return cell

    def assign_constant(self, ctx, k: int) -> AssignedCell:
        """out = k enforced via rc (out - k = 0)."""
        p = self.p
        return self.apply(ctx, [], rc=k % p, out_val=k % p, q_o=p - 1)

    def conditional_select(self, ctx, cond, a, b) -> AssignedCell:
        """out = cond*a + (1-cond)*b; cond must be 0/1-constrained elsewhere
        or via assert_bit."""
        p = self.p
        cv, av, bv = self._cv(cond), self._cv(a), self._cv(b)
        out = (cv * av + (1 - cv) * bv) % p
        # cond*a - cond*b + b - out = 0
        return self.apply(
            ctx,
            [cond, a, cond, b],
            q_1=[0, 0, 0, 1],
            q_m=[1, p - 1],
            out_val=out,
            q_o=p - 1,
        )

    def assert_bit(self, ctx, a):
        """a * a - a = 0."""
        p = self.p
        self.apply(ctx, [a, a], q_1=[p - 1], q_m=[1, 0])

    def assign_values_row(self, ctx, values: Sequence[int]) -> list[AssignedCell]:
        """Witness up to T unconstrained values in one row."""
        assert len(values) <= self.cfg.T
        cells = [
            ctx.assign_advice(self.cfg.state[i], v) for i, v in enumerate(values)
        ]
        ctx.next()
        return cells

    def le_num_to_bits(self, ctx, a: AssignedCell, num_bits: int) -> list[AssignedCell]:
        """Decompose into little-endian bit cells; each bit-constrained, and
        the chunked accumulation is constrained to equal `a`
        (reference `main_gate.rs` le_num_to_bits).

        Row cost ~1.5 rows/bit: T witnesses assigned per row, one
        bit-constraint row per bit, and 4-bit recomposition chunks.
        """
        p = self.p
        T = self.cfg.T
        v = self._cv(a)
        bits = [_bit(v, i) for i in range(num_bits)]
        bit_cells: list[AssignedCell] = []
        for i in range(0, num_bits, T):
            bit_cells.extend(self.assign_values_row(ctx, bits[i : i + T]))
        for cell in bit_cells:
            self.assert_bit(ctx, cell)
        # recompose MSB-first, T-1 bits per row: acc' = 2^(T-1) acc + chunk
        acc = self.assign_constant(ctx, 0)
        rev = list(reversed(bit_cells))
        for i in range(0, len(rev), T - 1):
            chunk = rev[i : i + T - 1]
            cw = len(chunk)
            coefs = [1 << (cw - 1 - j) for j in range(cw)]
            out = (acc.value * (1 << cw) + sum(c.value * co for c, co in zip(chunk, coefs))) % p
            acc = self.apply(
                ctx,
                [acc, *chunk],
                q_1=[1 << cw, *coefs],
                out_val=out,
                q_o=p - 1,
            )
        ctx.constrain_equal(acc, a)
        return bit_cells

    def le_bits_to_num(self, ctx, bits: Sequence[AssignedCell]) -> AssignedCell:
        """Constrained recomposition of little-endian bit cells."""
        p = self.p
        acc = self.assign_constant(ctx, 0)
        for cell in reversed(list(bits)):
            out = (2 * acc.value + cell.value) % p
            acc = self.apply(ctx, [acc, cell], q_1=[2, 1], out_val=out, q_o=p - 1)
        return acc

    def is_zero_term(self, ctx, a) -> AssignedCell:
        """Returns r with r = 1 if a == 0 else 0, via witness inverse:
        r = 1 - a*inv; constraints: a*r = 0 and a*inv + r - 1 = 0
        (reference `gadgets/util.rs` is_zero_term)."""
        p = self.p
        av = self._cv(a)
        inv = _inv0(av, p)
        r = _is_zero(av)
        r_cell = self.assign_value(ctx, r)
        inv_cell = self.assign_value(ctx, inv)
        # a * r = 0
        self.apply(ctx, [a, r_cell], q_m=[1, 0])
        # a * inv + r - 1 = 0
        self.apply(ctx, [a, inv_cell, r_cell], q_1=[0, 0, 1], q_m=[1, 0], rc=p - 1)
        return r_cell
