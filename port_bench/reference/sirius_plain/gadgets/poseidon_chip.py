"""On-circuit Poseidon sponge over the MainGate.

The port's own copy of `sirius_tpu/gadgets/poseidon_chip.py`, with what the
port's paths use (the port imports nothing of the JAX package).

Replaces reference `src/poseidon/poseidon_circuit.rs` (SURVEY.md §2.5).
Verifies the OPTIMIZED permutation schedule — the same one the off-circuit
sponge (`ops/poseidon.py::permute_optimized`) and the reference's
`poseidon_hash.rs:205-237` run — so on-/off-circuit hashes agree bit-exactly.

Because the optimized schedule applies the sbox to the RAW state (constants
are added after the sbox, folded through the linear layer), no separate ARC
rows are needed: every round is T one-row linear-combinations of fifth
powers (`out_i = sum_j A_ij s_j^5 + rc_i`), and partial rounds use the
sparse [[row],[col | I]] matrices (reference `poseidon_circuit.rs:188-252`).
Rows per permutation drop from 2T*r_f + (T+1)*r_p to T*(r_f + r_p) + absorb.
State entries that are protocol constants (initial sponge state, padding)
fold into the gate's fixed `rc` instead of occupying witness cells.
"""

from __future__ import annotations

from typing import Sequence

from ..ops.poseidon import PoseidonSpec, optimized_spec
from .main_gate import AssignedCell, MainGate, RegionCtx


class PoseidonChip:
    """ROCircuitTrait analogue (reference `random_oracle.rs:83-125`)."""

    def __init__(self, main_gate: MainGate, spec: PoseidonSpec):
        self.mg = main_gate
        self.spec = spec
        self.buf: list[AssignedCell | int] = []

    def absorb_base(self, v: int) -> "PoseidonChip":
        """Absorb a constant (unassigned) value."""
        self.buf.append(v % self.mg.p)
        return self

    def absorb_cell(self, cell: AssignedCell) -> "PoseidonChip":
        self.buf.append(cell)
        return self

    def absorb_iter(self, cells) -> "PoseidonChip":
        for c in cells:
            self.buf.append(c)
        return self

    # -- permutation ------------------------------------------------------------
    def _row(self, ctx: RegionCtx, pow5_terms, lin_terms, rc: int) -> AssignedCell:
        """One gate row: out = sum c*s^5 (pow5_terms) + sum c*s (lin_terms)
        + rc.  Constant (int) state entries fold into rc."""
        mg, p = self.mg, self.mg.p
        cells: list = []
        q5: list = []
        q1: list = []
        rc = rc % p
        for cf, s in pow5_terms:
            if cf % p == 0:
                continue
            if isinstance(s, AssignedCell):
                cells.append(s)
                q5.append(cf % p)
                q1.append(0)
            else:
                rc = (rc + cf * pow(s % p, 5, p)) % p
        for cf, s in lin_terms:
            if cf % p == 0:
                continue
            if isinstance(s, AssignedCell):
                cells.append(s)
                q5.append(0)
                q1.append(cf % p)
            else:
                rc = (rc + cf * (s % p)) % p
        out = (
            sum(c * pow(s.value, 5, p) for c, s in zip(q5, cells))
            + sum(c * s.value for c, s in zip(q1, cells))
            + rc
        ) % p
        return mg.apply(ctx, cells, q_1=q1, q_5=q5, rc=rc, out_val=out, q_o=p - 1)

    def _mat_round(self, ctx: RegionCtx, state: list, M, k) -> list:
        """out_i = sum_j M_ij * s_j^5 + (M k)_i — one row per output."""
        p = self.mg.p
        T = self.spec.t
        return [
            self._row(
                ctx,
                [(M[i][j], state[j]) for j in range(T)],
                [],
                sum(M[i][j] * k[j] for j in range(T)) % p,
            )
            for i in range(T)
        ]

    def permutation(self, ctx: RegionCtx, state: list, inputs: Sequence) -> list:
        """Absorb inputs (+1 padding marker) then run the optimized round
        schedule — mirrors the off-circuit `permute_optimized` exactly."""
        mg, spec = self.mg, self.spec
        p = mg.p
        opt = optimized_spec(spec)
        half = spec.r_f // 2
        state = list(state)

        # pre_round: state[0] += k0[0]; state[1+i] += input_i + k0[1+i];
        # the +1 padding marker lands right after the last input
        k0 = opt.start[0]
        if isinstance(state[0], AssignedCell):
            state[0] = mg.add_with_const(ctx, state[0], k0[0])
        else:
            state[0] = (state[0] + k0[0]) % p
        for i in range(spec.rate):
            pad = 1 if i == len(inputs) else 0
            v = inputs[i] if i < len(inputs) else pad
            s = state[1 + i]
            if isinstance(v, AssignedCell) and isinstance(s, AssignedCell):
                state[1 + i] = self._row(ctx, [], [(1, s), (1, v)], k0[1 + i])
            elif isinstance(v, AssignedCell):
                state[1 + i] = mg.add_with_const(ctx, v, (s + k0[1 + i]) % p)
            elif isinstance(s, AssignedCell):
                state[1 + i] = mg.add_with_const(ctx, s, (v + k0[1 + i]) % p)
            else:
                state[1 + i] = (s + v + k0[1 + i]) % p

        for r in range(1, half):
            state = self._mat_round(ctx, state, spec.mds, opt.start[r])
        state = self._mat_round(ctx, state, opt.pre_sparse_mds, opt.start[half])

        T = spec.t
        for i in range(spec.r_p):
            g = opt.partial[i]
            row, col = opt.sparse_rows[i], opt.sparse_cols[i]
            # new0 = row . (s0^5 + g, s1, ..) ; new_j = col_{j-1}*(s0^5+g) + s_j
            new0 = self._row(
                ctx,
                [(row[0], state[0])],
                [(row[j], state[j]) for j in range(1, T)],
                row[0] * g % p,
            )
            rest = [
                self._row(
                    ctx,
                    [(col[j - 1], state[0])],
                    [(1, state[j])],
                    col[j - 1] * g % p,
                )
                for j in range(1, T)
            ]
            state = [new0] + rest

        for j in range(half - 1):
            state = self._mat_round(ctx, state, spec.mds, opt.end[j])
        return self._mat_round(ctx, state, spec.mds, (0,) * T)

    def squeeze(self, ctx: RegionCtx) -> AssignedCell:
        """Run the sponge over the buffered inputs; output = state[1]
        (reference `poseidon_circuit.rs:385` + off-circuit `output`)."""
        spec = self.spec
        rate = spec.rate
        buf = list(self.buf)
        exact = len(buf) % rate == 0

        state: list = list(spec.initial_state)
        for i in range(0, len(buf), rate):
            state = self.permutation(ctx, state, buf[i : i + rate])
        if exact:
            state = self.permutation(ctx, state, [])
        return state[1]
