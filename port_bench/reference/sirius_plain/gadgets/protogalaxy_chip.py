"""On-circuit ProtoGalaxy verifier (native field — no ECC).

The port's own copy of `sirius_tpu/gadgets/protogalaxy_chip.py`, with what the
port's paths use (the port imports nothing of the JAX package).

Replaces reference `src/ivc/protogalaxy/mod.rs` verify_chip (SURVEY.md §2.5).
Commitments appear only as 64x20-bit limb decompositions (`BigUintPoint`);
their actual EC folding is delegated to the cyclefold support circuit, so
everything here is native-field arithmetic:

  1. re-derive delta -> alpha -> gamma from the transcript (Poseidon chip,
     absorbing exactly what the off-circuit `Challenges::generate` absorbs)
  2. betas' = beta_i + alpha * delta^(2^i)
  3. fold instance field-parts and betas with L_i(gamma)
  4. e' = F(alpha) * L_0(gamma) + Z(gamma) * K(gamma)

Returns the folded assigned accumulator plus the L_i(gamma) cells (handed to
the support-circuit delegation for the W-commitment folds).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from ..fields import gold
from ..frontend.tape import inv0 as _inv0
from ..nifs.protogalaxy import (
    AccumulatorInstance,
    Proof,
    biguint_limbs,
)
from ..ops.poseidon import PoseidonSpec
from ..plonk.structure import PlonkInstance
from .big_uint_chip import BigUintCells
from .main_gate import AssignedCell, MainGate, RegionCtx
from .poseidon_chip import PoseidonChip


@dataclass
class AssignedBigUintPoint:
    """W commitment as limb cells (reference `BigUintPoint`, 64x20)."""

    x: list[AssignedCell]
    y: list[AssignedCell]


@dataclass
class AssignedPlonkInstancePG:
    W_commitments: list[AssignedBigUintPoint]
    instances: list[list[AssignedCell]]
    challenges: list[AssignedCell]


@dataclass
class AssignedAccumulatorInstance:
    ins: AssignedPlonkInstancePG
    betas: list[AssignedCell]
    e: AssignedCell


class ProtoGalaxyVerifyChip:
    def __init__(self, mg: MainGate, ro_spec: PoseidonSpec):
        self.mg = mg
        self.spec = ro_spec

    # -- assignment -------------------------------------------------------------
    def _assign_point(self, ctx, pt) -> AssignedBigUintPoint:
        mg = self.mg
        x, y = (0, 0) if pt.is_identity else (pt.x, pt.y)
        return AssignedBigUintPoint(
            [mg.assign_value(ctx, l) for l in biguint_limbs(x)],
            [mg.assign_value(ctx, l) for l in biguint_limbs(y)],
        )

    def assign_instance(self, ctx, u: PlonkInstance) -> AssignedPlonkInstancePG:
        mg = self.mg
        p = mg.p
        return AssignedPlonkInstancePG(
            [self._assign_point(ctx, c) for c in u.W_commitments],
            [[mg.assign_value(ctx, v % p) for v in inst] for inst in u.instances],
            [mg.assign_value(ctx, c % p) for c in u.challenges],
        )

    def assign_accumulator(self, ctx, acc: AccumulatorInstance) -> AssignedAccumulatorInstance:
        mg = self.mg
        p = mg.p
        return AssignedAccumulatorInstance(
            self.assign_instance(ctx, acc.ins),
            [mg.assign_value(ctx, b % p) for b in acc.betas],
            mg.assign_value(ctx, acc.e % p),
        )

    def assign_proof(self, ctx, proof: Proof) -> tuple[list[AssignedCell], list[AssignedCell]]:
        mg = self.mg
        p = mg.p
        return (
            [mg.assign_value(ctx, c % p) for c in proof.poly_F.coeffs],
            [mg.assign_value(ctx, c % p) for c in proof.poly_K.coeffs],
        )

    # -- transcript -------------------------------------------------------------
    def _absorb_instance(self, ro: PoseidonChip, u: AssignedPlonkInstancePG):
        for pt in u.W_commitments:
            ro.absorb_iter(pt.x)
            ro.absorb_iter(pt.y)
        for inst in u.instances:
            ro.absorb_iter(inst)
        ro.absorb_iter(u.challenges)

    def generate_challenges(
        self,
        ctx: RegionCtx,
        pp_digest: tuple[AssignedCell, AssignedCell],
        acc: AssignedAccumulatorInstance,
        incoming: Sequence[AssignedPlonkInstancePG],
        poly_F: Sequence[AssignedCell],
        poly_K: Sequence[AssignedCell],
    ) -> tuple[AssignedCell, AssignedCell, AssignedCell]:
        """delta -> alpha -> gamma, mirroring off-circuit
        `Challenges::generate` (squeezes are full-width, no truncation)."""
        mg = self.mg
        ro = PoseidonChip(mg, self.spec)
        ro.absorb_cell(pp_digest[0])
        ro.absorb_cell(pp_digest[1])
        self._absorb_instance(ro, acc.ins)
        ro.absorb_iter(acc.betas)
        ro.absorb_cell(acc.e)
        for u in incoming:
            self._absorb_instance(ro, u)
        delta = ro.squeeze(ctx)
        ro.absorb_iter(poly_F)
        alpha = ro.squeeze(ctx)
        ro.absorb_iter(poly_K)
        gamma = ro.squeeze(ctx)
        return delta, alpha, gamma

    def verify_sps(
        self,
        ctx: RegionCtx,
        incoming: AssignedPlonkInstancePG,
        bn,
        num_challenge_bits: int,
        bypass: AssignedCell | None = None,
    ) -> None:
        """On-circuit SPS verification (reference `verify_sps`,
        `ivc/protogalaxy/mod.rs:946-975`): re-derive the incoming trace's
        challenges from the transcript and constrain them equal.

        Mirrors `plonk.sps.sps_verify` absorb-for-absorb: instances, then per
        round the W-commitment coordinates cast into the native field
        (`PoseidonHash.absorb_point` absorbs x % p, y % p; here the cast is
        the constrained limb recomposition).  `bypass` (e.g. is_zero_step)
        skips the equality at the base case, where the incoming instance is
        the all-zero dry default with no valid transcript behind it.
        """
        if not incoming.challenges:
            return
        mg = self.mg
        ro = PoseidonChip(mg, self.spec)
        for inst in incoming.instances:
            ro.absorb_iter(inst)
        for i, expected in enumerate(incoming.challenges):
            pt = incoming.W_commitments[i]
            for coord in (pt.x, pt.y):
                cells = BigUintCells(list(coord), bn.w)
                ro.absorb_cell(bn.to_native_cell(ctx, cells))
            out = ro.squeeze(ctx)
            bits = mg.le_num_to_bits(ctx, out, mg.p.bit_length())
            derived = mg.le_bits_to_num(ctx, bits[:num_challenge_bits])
            if bypass is not None:
                derived = mg.conditional_select(ctx, bypass, expected, derived)
            ctx.constrain_equal(derived, expected)

    # -- algebra ----------------------------------------------------------------
    def betas_stroke(self, ctx, betas: Sequence[AssignedCell], alpha, delta) -> list[AssignedCell]:
        mg = self.mg
        out = []
        d = delta
        for i, b in enumerate(betas):
            ad = mg.mul(ctx, alpha, d)
            out.append(mg.add(ctx, b, ad))
            if i + 1 < len(betas):
                d = mg.mul(ctx, d, d)
        return out

    def eval_poly(self, ctx, coeffs: Sequence[AssignedCell], x: AssignedCell) -> AssignedCell:
        """Horner (reference `AssignedUnivariatePoly`/`ValuePowers`)."""
        mg = self.mg
        if not coeffs:
            return mg.assign_constant(ctx, 0)
        acc = coeffs[-1]
        for c in reversed(coeffs[:-1]):
            acc = mg.mul(ctx, acc, x)
            acc = mg.add(ctx, acc, c)
        return acc

    def lagrange_at(self, ctx, gamma: AssignedCell, log_n: int, spec) -> tuple[list[AssignedCell], AssignedCell]:
        """All L_i(gamma) for the 2^log_n domain plus Z(gamma) = gamma^n - 1,
        via witnessed constrained inverses (L_i = w^i/n * Z / (gamma - w^i))."""
        mg = self.mg
        p = mg.p
        n = 1 << log_n
        w = gold.omega_for_k(spec, log_n)
        n_inv = pow(n, -1, p)
        # gamma^n by repeated squaring (log_n muls)
        g_pow = gamma
        for _ in range(log_n):
            g_pow = mg.mul(ctx, g_pow, g_pow)
        z = mg.add_with_const(ctx, g_pow, p - 1)  # Z = gamma^n - 1
        ls = []
        w_i = 1
        for i in range(n):
            denom = mg.add_with_const(ctx, gamma, (-w_i) % p)
            inv_v = _inv0(denom.value, p)
            inv = mg.assign_value(ctx, inv_v)
            # denom * inv = 1 (gamma must not hit the domain; negligible)
            mg.apply(ctx, [denom, inv], q_m=[1, 0], rc=p - 1)
            zi = mg.mul(ctx, z, inv)
            ls.append(mg.mul_by_const(ctx, zi, w_i * n_inv % p))
            w_i = w_i * w % p
        return ls, z

    # -- the verification -------------------------------------------------------
    def verify(
        self,
        ctx: RegionCtx,
        spec_field,
        pp_digest: tuple[AssignedCell, AssignedCell],
        acc: AssignedAccumulatorInstance,
        incoming: Sequence[AssignedPlonkInstancePG],
        poly_F: Sequence[AssignedCell],
        poly_K: Sequence[AssignedCell],
    ) -> tuple[AssignedAccumulatorInstance, list[AssignedCell]]:
        """Reference `verify_chip::verify` (`ivc/protogalaxy/mod.rs:1004`).

        Returns (folded accumulator sans W-commitment folds, L_i(gamma) cells
        for the support-circuit delegation).  The folded W commitments keep
        the accumulator's limbs as placeholders — cyclefold replaces them
        with support-circuit outputs.
        """
        mg = self.mg
        L = len(incoming)
        log_n = (L + 1).bit_length() - 1
        delta, alpha, gamma = self.generate_challenges(
            ctx, pp_digest, acc, incoming, poly_F, poly_K
        )
        b_stroke = self.betas_stroke(ctx, acc.betas, alpha, delta)
        ls, z = self.lagrange_at(ctx, gamma, log_n, spec_field)

        # fold field parts: x' = l0*x_acc + sum_i l_{i+1}*x_i
        def fold_vals(get):
            acc_v = mg.mul(ctx, ls[0], get(acc.ins))
            for i, u in enumerate(incoming):
                acc_v = mg.add(ctx, acc_v, mg.mul(ctx, ls[i + 1], get(u)))
            return acc_v

        n_inst = [
            [
                fold_vals(lambda ins, r=row, c=col: ins.instances[r][c])
                for col in range(len(acc.ins.instances[row]))
            ]
            for row in range(len(acc.ins.instances))
        ]
        n_chal = [
            fold_vals(lambda ins, i=i: ins.challenges[i])
            for i in range(len(acc.ins.challenges))
        ]

        # e' = F(alpha) * L_0(gamma) + Z(gamma) * K(gamma)
        f_alpha = self.eval_poly(ctx, poly_F, alpha)
        k_gamma = self.eval_poly(ctx, poly_K, gamma)
        e_new = mg.add(ctx, mg.mul(ctx, f_alpha, ls[0]), mg.mul(ctx, z, k_gamma))

        folded = AssignedAccumulatorInstance(
            AssignedPlonkInstancePG(acc.ins.W_commitments, n_inst, n_chal),
            b_stroke,
            e_new,
        )
        return folded, ls
