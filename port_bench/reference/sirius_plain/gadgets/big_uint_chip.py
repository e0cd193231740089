"""Nonnative big-integer arithmetic over the MainGate (cross-field gadget).

The port's own copy of `sirius_tpu/gadgets/big_uint_chip.py`, with what the
port's paths use (the port imports nothing of the JAX package).

Replaces reference `src/gadgets/nonnative/bn/` (SURVEY.md §2.5): values of
the *paired* curve's field are carried as fixed-width little-endian limbs of
native-field cells.  Default geometries match the reference: Sangria 32x10
(`lib.rs:81-87`), Cyclefold 64x20 (`ivc/cyclefold/mod.rs:26-29`).

`mult_mod` uses the standard nonnative identity a*b = q*m + r proven limbwise
with offset (always-nonnegative) carries:

    L_j = sum_{i+l=j} a_i b_l        R_j = sum_{i+l=j} q_i m_l + r_j
    L_j - R_j + c_{j-1} = 2^w c_j    with c_j range-checked after an offset
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from ..frontend.tape import clamp, is_traced
from .main_gate import AssignedCell, MainGate, RegionCtx

# reference defaults
SANGRIA_LIMB_WIDTH = 32
SANGRIA_LIMBS_COUNT = 10


@dataclass
class BigUintCells:
    """Little-endian limb cells; each limb < 2^width (range-checked at
    assignment)."""

    limbs: list[AssignedCell]
    width: int

    @property
    def value(self) -> int:
        return sum(c.value << (i * self.width) for i, c in enumerate(self.limbs))


class BigUintChip:
    """Reference `BigUintMulModChip` (`big_uint_mul_mod_chip/mod.rs:48`)."""

    def __init__(self, mg: MainGate, limb_width: int = SANGRIA_LIMB_WIDTH, limbs_count: int = SANGRIA_LIMBS_COUNT):
        self.mg = mg
        self.w = limb_width
        self.k = limbs_count

    # -- assignment --------------------------------------------------------------
    def _range_check(self, ctx: RegionCtx, cell: AssignedCell, bits: int):
        self.mg.le_num_to_bits(ctx, cell, bits)

    def assign_biguint(self, ctx: RegionCtx, value: int, range_check: bool = True) -> BigUintCells:
        """Witness limbs of `value` (< 2^(w*k)); each limb range-checked."""
        mg, w, k = self.mg, self.w, self.k
        assert 0 <= value < 1 << (w * k)
        mask = (1 << w) - 1
        cells = []
        for i in range(k):
            c = mg.assign_value(ctx, (value >> (i * w)) & mask)
            if range_check:
                self._range_check(ctx, c, w)
            cells.append(c)
        return BigUintCells(cells, w)

    def from_assigned_cell(self, ctx: RegionCtx, cell: AssignedCell, num_bits: int | None = None) -> BigUintCells:
        """Decompose a native cell into limbs with a constrained
        recomposition (reference `from_assigned_value_to_limbs`,
        `big_uint_mul_mod_chip/mod.rs:1039`)."""
        mg, w, k = self.mg, self.w, self.k
        p = mg.p
        num_bits = num_bits or p.bit_length()
        used = -(-num_bits // w)
        assert used <= k
        v = cell.value
        mask = (1 << w) - 1
        cells = []
        for i in range(k):
            limb_v = (v >> (i * w)) & mask if i < used else 0
            c = mg.assign_value(ctx, limb_v)
            self._range_check(ctx, c, w if i < used else 1)
            cells.append(c)
        # recomposition: sum limb_i * 2^(w*i) == cell, via Horner MSB-first
        acc = mg.assign_constant(ctx, 0)
        shift = pow(2, w, p)
        for c in reversed(cells[:used]):
            out = (acc.value * shift + c.value) % p
            acc = mg.apply(ctx, [acc, c], q_1=[shift, 1], out_val=out, q_o=p - 1)
        ctx.constrain_equal(acc, cell)
        return BigUintCells(cells, w)

    def to_native_cell(self, ctx: RegionCtx, a: BigUintCells) -> AssignedCell:
        """sum limb_i 2^(w i) mod native p, constrained."""
        mg, w = self.mg, self.w
        p = mg.p
        acc = mg.assign_constant(ctx, 0)
        shift = pow(2, w, p)
        for c in reversed(a.limbs):
            out = (acc.value * shift + c.value) % p
            acc = mg.apply(ctx, [acc, c], q_1=[shift, 1], out_val=out, q_o=p - 1)
        return acc

    # -- arithmetic --------------------------------------------------------------
    def assign_sum(self, ctx: RegionCtx, a: BigUintCells, b: BigUintCells) -> BigUintCells:
        """Lazy limbwise sum (no carry propagation; limbs may reach 2^(w+1);
        reference `assign_sum` OverflowingBigUint semantics).  Use red_mod to
        renormalize."""
        mg = self.mg
        assert a.width == b.width
        limbs = [mg.add(ctx, x, y) for x, y in zip(a.limbs, b.limbs)]
        return BigUintCells(limbs, a.width)

    def _column_products(self, ctx: RegionCtx, a: Sequence[AssignedCell], b: Sequence[AssignedCell]) -> list[list[AssignedCell]]:
        """All products a_i*b_l grouped by column j = i + l."""
        mg = self.mg
        cols: list[list[AssignedCell]] = [[] for _ in range(len(a) + len(b) - 1)]
        for i, ai in enumerate(a):
            for l, bl in enumerate(b):
                cols[i + l].append(mg.mul(ctx, ai, bl))
        return cols

    def _column_sum(self, ctx: RegionCtx, cells: Sequence[AssignedCell]) -> AssignedCell:
        mg, p = self.mg, self.mg.p
        if not cells:
            return mg.assign_constant(ctx, 0)
        acc = cells[0]
        for c in cells[1:]:
            acc = mg.add(ctx, acc, c)
        return acc

    def assert_less_than_const(self, ctx: RegionCtx, a: BigUintCells, bound: int):
        """Prove a < bound (a circuit constant): witness d = bound-1-a with
        range-checked limbs and prove a + d = bound-1 limbwise with boolean
        carries.  Closes the canonical-remainder soundness gap of the bare
        limb range checks."""
        mg, w, k = self.mg, self.w, self.k
        p = mg.p
        # the caller guarantees a < bound for honest witnesses (a is a MODC
        # remainder recomposed from range-checked limbs); tell the tracer
        av = clamp(a.value, 0, bound - 1)
        assert 0 <= av < bound <= 1 << (w * k)
        d = self.assign_biguint(ctx, bound - 1 - av)
        mask = (1 << w) - 1
        t_limbs = [((bound - 1) >> (i * w)) & mask for i in range(k)]
        shift = pow(2, w, p)
        carry_prev: AssignedCell | None = None
        carry_int = 0
        for j in range(k):
            s_int = a.limbs[j].value + d.limbs[j].value + carry_int
            c_int = s_int >> w
            assert (s_int & mask) == t_limbs[j], "less-than witness broken"
            # a_j + d_j + c_{j-1} - t_j - 2^w c_j = 0, c_j boolean
            state = [a.limbs[j], d.limbs[j]]
            q1 = [1, 1]
            if carry_prev is not None:
                state.append(carry_prev)
                q1.append(1)
            if j == k - 1:
                # top column: carry out must be zero, fold it into the row
                assert c_int == 0, "less-than top carry nonzero"
                self._linear_constraint(ctx, state, q1, (-t_limbs[j]) % p)
            else:
                c_cell = mg.assign_value(ctx, c_int)
                self._range_check(ctx, c_cell, 1)
                state.append(c_cell)
                q1.append((p - shift) % p)
                self._linear_constraint(ctx, state, q1, (-t_limbs[j]) % p)
                carry_prev = c_cell
                carry_int = c_int

    def mult_mod(self, ctx: RegionCtx, a: BigUintCells, b: BigUintCells, modulus: int, addend: BigUintCells | None = None) -> tuple[BigUintCells, BigUintCells]:
        """(q, r) with addend + a*b = q*modulus + r proven limbwise
        (reference `mult_mod`, `big_uint_mul_mod_chip/mod.rs:1209`; the
        optional addend fuses the reference's assign_sum+red_mod chain into
        one identity, saving ~half the rows of every nonnative fold).
        Returns (quotient, remainder); remainder limbs are range-checked and
        the canonical bound r < modulus is enforced via
        assert_less_than_const."""
        mg, w, k = self.mg, self.w, self.k
        p = mg.p
        av, bv = a.value, b.value
        add_v = addend.value if addend is not None else 0
        q_int, r_int = divmod(add_v + av * bv, modulus)
        assert q_int < 1 << (w * k), "quotient overflow: inputs must be < modulus-ish"
        q = self.assign_biguint(ctx, q_int)
        r = self.assign_biguint(ctx, r_int)

        m_limbs = [(modulus >> (i * w)) & ((1 << w) - 1) for i in range(k)]

        ab_cols = self._column_products(ctx, a.limbs, b.limbs)

        # R_j = sum_{i+l=j} q_i * m_l (constant m) + r_j
        # carry chain: L_j - R_j + c_{j-1} = 2^w * c_j
        # offset carries: c_j = c'_j - OFF, c'_j in [0, 2^cbits)
        cbits = w + k.bit_length() + 1
        OFF = 1 << (cbits - 1)
        carry_prev = None  # represents c'_{j-1} cell; c_{-1} = 0
        carry_int_prev = 0
        total_cols = 2 * k - 1
        for j in range(total_cols):
            Lj_cells = list(ab_cols[j]) if j < len(ab_cols) else []
            if addend is not None and j < k:
                Lj_cells.append(addend.limbs[j])
            Lj = self._column_sum(ctx, Lj_cells)
            # build R_j as a linear row over q limbs with constant coeffs m_l
            qs = [(q.limbs[i], m_limbs[j - i]) for i in range(max(0, j - k + 1), min(k, j + 1))]
            r_cell = r.limbs[j] if j < k else None

            # integer carry value
            L_int = sum(a.limbs[i].value * b.limbs[l].value for i in range(k) for l in range(k) if i + l == j)
            if addend is not None and j < k:
                L_int += addend.limbs[j].value
            R_int = sum(qc.value * ml for qc, ml in qs) + (r_cell.value if r_cell else 0)
            c_int = (L_int - R_int + carry_int_prev) >> w
            assert is_traced(c_int) or (L_int - R_int + carry_int_prev) & ((1 << w) - 1) == 0, \
                "carry identity broken"
            c_prime = c_int + OFF
            assert 0 <= c_prime < (1 << cbits), f"carry out of range at col {j}"
            c_cell = mg.assign_value(ctx, c_prime)
            self._range_check(ctx, c_cell, cbits)

            # constraint row:
            #   L_j - sum q_i m_l - r_j + (c'_{j-1} - OFF)*[j>0] - 2^w*(c'_j - OFF) = 0
            state = [Lj]
            q1 = [1]
            for qc, ml in qs:
                state.append(qc)
                q1.append((p - ml % p) % p)
            if r_cell is not None:
                state.append(r_cell)
                q1.append(p - 1)
            rc_const = 0
            if carry_prev is not None:
                state.append(carry_prev)
                q1.append(1)
                rc_const -= OFF
            state.append(c_cell)
            q1.append((p - pow(2, w, p)) % p)
            rc_const += OFF * pow(2, w, p)
            # split into multiple rows if too many state slots
            self._linear_constraint(ctx, state, q1, rc_const % p)
            carry_prev = c_cell
            carry_int_prev = c_int

        # top carry must be zero: c'_{last} == OFF
        final = mg.sub(ctx, carry_prev, mg.assign_constant(ctx, OFF))
        zero = mg.assign_constant(ctx, 0)
        ctx.constrain_equal(final, zero)
        self.assert_less_than_const(ctx, r, modulus)
        return q, r

    def _linear_constraint(self, ctx: RegionCtx, cells: Sequence[AssignedCell], coefs: Sequence[int], rc: int):
        """sum coef_i * cell_i + rc == 0, split across rows of width T via a
        running partial sum."""
        mg, p = self.mg, self.mg.p
        T = mg.cfg.T
        acc: AssignedCell | None = None
        items = list(zip(cells, coefs))
        first = True
        while items:
            take = items[: T - 1] if acc is not None or not first else items[:T]
            items = items[len(take) :]
            state = [c for c, _ in take]
            q1 = [co % p for _, co in take]
            if acc is not None:
                state.append(acc)
                q1.append(1)
            this_rc = rc if first else 0
            first = False
            if items:
                out = (sum(c.value * co for c, co in take) + (acc.value if acc else 0) + this_rc) % p
                acc = mg.apply(ctx, state, q_1=q1, rc=this_rc, out_val=out, q_o=p - 1)
            else:
                mg.apply(ctx, state, q_1=q1, rc=this_rc)

    def assign_biguint_const(self, ctx: RegionCtx, value: int) -> BigUintCells:
        """Constant limbs (rc-constrained, not merely witnessed)."""
        mg, w, k = self.mg, self.w, self.k
        mask = (1 << w) - 1
        return BigUintCells(
            [mg.assign_constant(ctx, (value >> (i * w)) & mask) for i in range(k)], w
        )

    def red_mod(self, ctx: RegionCtx, a: BigUintCells, modulus: int) -> tuple[BigUintCells, BigUintCells]:
        """a mod modulus via mult_mod with constant b = 1: witness q, r with
        a = q*m + r (reference `red_mod`)."""
        one = self.assign_biguint_const(ctx, 1)
        return self.mult_mod(ctx, a, one, modulus)
