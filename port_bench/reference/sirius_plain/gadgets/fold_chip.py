"""Fold chip: the in-circuit Sangria fold of a RelaxedPlonkInstance.

The port's own copy of `sirius_tpu/gadgets/fold_chip.py`, with what the
port's paths use (the port imports nothing of the JAX package).

Replaces reference `src/ivc/sangria/fold_relaxed_plonk_instance_chip.rs`
(SURVEY.md §2.5).  The circuit field is C::Base of the folded curve; points
fold natively via the ECC chip, while consistency markers / challenges / u
(C::Scalar values) fold as nonnative biguints:

    W' = W + r*W_in          (scalar_mul over the 128 squeeze bits)
    E' = E + sum r^k T_k     (powers of r computed mod q as biguints)
    m' = m + r*m_in mod q    (fold_via_biguint)
    u' = u + r mod q
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..fields.constants import CurveSpec
from ..nifs.sangria import RelaxedPlonkInstance
from ..ops.poseidon import PoseidonSpec
from ..plonk.structure import PlonkInstance
from .big_uint_chip import BigUintCells, BigUintChip
from .ecc_chip import AssignedPoint, EccChip
from .main_gate import AssignedCell, MainGate, RegionCtx
from .poseidon_chip import PoseidonChip

NUM_CHALLENGE_BITS = 128


@dataclass
class AssignedRelaxedPlonkInstance:
    """On-circuit mirror of the relaxed instance
    (reference `fold_relaxed_plonk_instance_chip.rs:99-239`)."""

    W_commitments: list[AssignedPoint]
    E_commitment: AssignedPoint
    consistency_markers: list[BigUintCells]
    challenges: list[BigUintCells]
    u: BigUintCells
    sc_hash_acc: Optional[AssignedCell]


@dataclass
class AssignedPlonkInstance:
    W_commitments: list[AssignedPoint]
    # instances[0] (the markers) live in C::Scalar which can exceed the
    # native field, so they are carried as biguint limbs of the true value
    markers: list[BigUintCells]
    sc_instances: list[list[AssignedCell]]
    challenges: list[BigUintCells]


class FoldRelaxedPlonkInstanceChip:
    def __init__(self, mg: MainGate, ro_spec: PoseidonSpec, curve: CurveSpec,
                 bn_chip: Optional[BigUintChip] = None):
        self.mg = mg
        self.ecc = EccChip(mg)
        self.bn = bn_chip or BigUintChip(mg)
        self.ro_spec = ro_spec
        self.curve = curve  # the folded curve C (scalar modulus q = nonnative)
        self.q = curve.scalar.modulus

    # -- assignment --------------------------------------------------------------
    def assign_relaxed(self, ctx: RegionCtx, U: RelaxedPlonkInstance) -> AssignedRelaxedPlonkInstance:
        mg, bn = self.mg, self.bn
        return AssignedRelaxedPlonkInstance(
            W_commitments=[self.ecc.assign_affine(ctx, c) for c in U.W_commitments],
            E_commitment=self.ecc.assign_affine(ctx, U.E_commitment),
            consistency_markers=[bn.assign_biguint(ctx, m % self.q) for m in U.consistency_markers],
            challenges=[bn.assign_biguint(ctx, c % self.q) for c in U.challenges],
            u=bn.assign_biguint(ctx, U.u % self.q),
            sc_hash_acc=(
                None
                if U.sc_instances_hash_acc is None
                else mg.assign_value(ctx, U.sc_instances_hash_acc % mg.p)
            ),
        )

    def assign_incoming(self, ctx: RegionCtx, u: PlonkInstance) -> AssignedPlonkInstance:
        mg, bn = self.mg, self.bn
        return AssignedPlonkInstance(
            W_commitments=[self.ecc.assign_affine(ctx, c) for c in u.W_commitments],
            markers=[bn.assign_biguint(ctx, v % self.q) for v in u.instances[0]],
            sc_instances=[
                [mg.assign_value(ctx, v % mg.p) for v in inst] for inst in u.instances[1:]
            ],
            challenges=[bn.assign_biguint(ctx, c % self.q) for c in u.challenges],
        )

    # -- transcript --------------------------------------------------------------
    def absorb_relaxed(self, ro: PoseidonChip, ctx: RegionCtx, U: AssignedRelaxedPlonkInstance):
        """Mirror of off-circuit RelaxedPlonkInstance.absorb_into: W points,
        [markers | challenges | u] as native casts, E point, sc-acc."""
        for pt in U.W_commitments:
            ro.absorb_cell(pt.x)
            ro.absorb_cell(pt.y)
        for bu in [*U.consistency_markers, *U.challenges, U.u]:
            ro.absorb_cell(self.bn.to_native_cell(ctx, bu))
        ro.absorb_cell(U.E_commitment.x)
        ro.absorb_cell(U.E_commitment.y)
        if U.sc_hash_acc is None:
            ro.absorb_base(0)
        else:
            ro.absorb_cell(U.sc_hash_acc)

    def absorb_incoming(self, ro: PoseidonChip, ctx: RegionCtx, u: AssignedPlonkInstance):
        """Mirror of PlonkInstance.absorb_into."""
        for pt in u.W_commitments:
            ro.absorb_cell(pt.x)
            ro.absorb_cell(pt.y)
        for m in u.markers:
            ro.absorb_cell(self.bn.to_native_cell(ctx, m))
        for inst in u.sc_instances:
            for c in inst:
                ro.absorb_cell(c)
        for bu in u.challenges:
            ro.absorb_cell(self.bn.to_native_cell(ctx, bu))

    def generate_challenge(
        self,
        ctx: RegionCtx,
        pp_digest: tuple[AssignedCell, AssignedCell],
        U: AssignedRelaxedPlonkInstance,
        u_in: AssignedPlonkInstance,
        T_commits: list[AssignedPoint],
    ) -> tuple[AssignedCell, list[AssignedCell]]:
        """r = RO(pp || U || u || T), truncated to 128 bits; returns (r cell,
        r bits) (mirrors off-circuit VanillaFS.generate_challenge)."""
        mg = self.mg
        ro = PoseidonChip(mg, self.ro_spec)
        ro.absorb_cell(pp_digest[0])
        ro.absorb_cell(pp_digest[1])
        self.absorb_relaxed(ro, ctx, U)
        self.absorb_incoming(ro, ctx, u_in)
        for t in T_commits:
            ro.absorb_cell(t.x)
            ro.absorb_cell(t.y)
        out = ro.squeeze(ctx)
        bits = mg.le_num_to_bits(ctx, out, mg.p.bit_length())
        r_bits = bits[:NUM_CHALLENGE_BITS]
        r_cell = mg.le_bits_to_num(ctx, r_bits)
        return r_cell, r_bits

    # -- nonnative helpers -------------------------------------------------------
    def fold_via_biguint(self, ctx, acc: BigUintCells, x: BigUintCells, r: BigUintCells) -> BigUintCells:
        """acc + r*x mod q (reference `fold_via_biguint`,
        `fold_relaxed_plonk_instance_chip.rs:1077`) as a single fused
        mul-add-mod identity."""
        _, out = self.bn.mult_mod(ctx, r, x, self.q, addend=acc)
        return out

    # -- the fold ---------------------------------------------------------------
    def fold(
        self,
        ctx: RegionCtx,
        U: AssignedRelaxedPlonkInstance,
        u_in: AssignedPlonkInstance,
        T_commits: list[AssignedPoint],
        pp_digest: tuple[AssignedCell, AssignedCell],
        sc_next_hash_acc: Optional[AssignedCell] = None,
    ) -> tuple[AssignedRelaxedPlonkInstance, AssignedCell]:
        """Returns (folded instance, r cell) (reference `fold`,
        `fold_relaxed_plonk_instance_chip.rs:626`)."""
        mg, bn = self.mg, self.bn
        r_cell, r_bits = self.generate_challenge(ctx, pp_digest, U, u_in, T_commits)
        r_bn = bn.from_assigned_cell(ctx, r_cell, NUM_CHALLENGE_BITS)

        # W' = W + r*W_in  (fast scalar mul over the 128 challenge bits)
        new_W = []
        for W1, W2 in zip(U.W_commitments, u_in.W_commitments):
            rW = self.ecc.scalar_mul_fast(ctx, W2, r_bits)
            new_W.append(self.ecc.add(ctx, W1, rW))

        # E' = E + sum_k r^k T_k via Horner over points:
        #   S = T_m; S = T_k + r*S (k = m-1..1); E' = E + r*S
        # every multiply uses only the 128 challenge bits — no nonnative
        # power chain needed (identical value to the off-circuit fold).
        E = U.E_commitment
        if T_commits:
            S = T_commits[-1]
            for Tk in reversed(T_commits[:-1]):
                rS = self.ecc.scalar_mul_fast(ctx, S, r_bits)
                S = self.ecc.add(ctx, Tk, rS)
            E = self.ecc.add(ctx, E, self.ecc.scalar_mul_fast(ctx, S, r_bits))

        # markers' = markers + r * u_in.markers
        new_markers = [
            self.fold_via_biguint(ctx, m_acc, m_in, r_bn)
            for m_acc, m_in in zip(U.consistency_markers, u_in.markers)
        ]

        # challenges' = challenges + r * incoming
        new_challenges = [
            self.fold_via_biguint(ctx, c_acc, c_in, r_bn)
            for c_acc, c_in in zip(U.challenges, u_in.challenges)
        ]

        # u' = u + r mod q
        s = bn.assign_sum(ctx, U.u, r_bn)
        _, new_u = bn.red_mod(ctx, s, self.q)

        folded = AssignedRelaxedPlonkInstance(
            W_commitments=new_W,
            E_commitment=E,
            consistency_markers=new_markers,
            challenges=new_challenges,
            u=new_u,
            sc_hash_acc=sc_next_hash_acc,
        )
        return folded, r_cell


def select_relaxed(ctx, mg: MainGate, cond, a: AssignedRelaxedPlonkInstance,
                   b: AssignedRelaxedPlonkInstance) -> AssignedRelaxedPlonkInstance:
    """cond ? a : b over every cell of two relaxed instances (the base-case
    select of both IVC constructions' step-folding circuits)."""

    def sel_pt(x, y):
        return AssignedPoint(mg.conditional_select(ctx, cond, x.x, y.x), mg.conditional_select(ctx, cond, x.y, y.y))

    def sel_bn(x, y):
        return BigUintCells([mg.conditional_select(ctx, cond, l1, l2) for l1, l2 in zip(x.limbs, y.limbs)], x.width)

    return AssignedRelaxedPlonkInstance(
        W_commitments=[sel_pt(x, y) for x, y in zip(a.W_commitments, b.W_commitments)],
        E_commitment=sel_pt(a.E_commitment, b.E_commitment),
        consistency_markers=[sel_bn(x, y) for x, y in zip(a.consistency_markers, b.consistency_markers)],
        challenges=[sel_bn(x, y) for x, y in zip(a.challenges, b.challenges)],
        u=sel_bn(a.u, b.u),
        sc_hash_acc=None if a.sc_hash_acc is None else mg.conditional_select(ctx, cond, a.sc_hash_acc, b.sc_hash_acc),
    )
