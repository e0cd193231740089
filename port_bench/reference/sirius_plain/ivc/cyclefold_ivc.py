"""Cyclefold IVC: ProtoGalaxy on the primary curve and a Sangria-folded EC
support circuit on the secondary curve.

Counterpart of `sirius_tpu/ivc/cyclefold_ivc.py` (reference
`src/ivc/cyclefold/`), bit for bit, for the verifier: the public
parameters (the step-folding circuit's and the support circuit's
structures, collected by dry syntheses, and the pp digest over them), the
marker that binds a step's state, and `verify` over a chain's state.  The
prover is left out.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional, Sequence

from ..fields import gold
from ..fields.constants import FieldSpec, bn256_fq, bn256_fr, bn256_g1, grumpkin
from ..frontend.circuit import ConstraintSystemBuilder
from ..frontend.runner import CircuitRunner, ConstraintSystemMetainfo
from ..frontend.tape import TapeBuilder
from ..frontend.taped import _TrPoint, point_leaves, sc_trace_bind
from ..gadgets.big_uint_chip import BigUintChip
from ..gadgets.fold_chip import FoldRelaxedPlonkInstanceChip, select_relaxed
from ..gadgets.main_gate import MainGate, RegionCtx
from ..gadgets.poseidon_chip import PoseidonChip
from ..gadgets.protogalaxy_chip import (
    AssignedAccumulatorInstance,
    AssignedBigUintPoint,
    AssignedPlonkInstancePG,
    ProtoGalaxyVerifyChip,
)
from ..nifs import protogalaxy as pg
from ..nifs import sangria as sg
from ..ops.poseidon import PoseidonHash
from ..plonk import satisfy
from ..plonk.structure import PlonkInstance, PlonkTrace
from ..poly.expression import QueryIndexContext
from ..poly.univariate import UnivariatePoly
from ..util.digest import digest_ints_to_bits, into_curve_from_bits, structure_digest_stream
from ..util.ro import NUM_CHALLENGE_BITS, default_ro_spec
from .step_circuit import StepCircuit
from .support_fold import SUPPORT_IO, SUPPORT_K, SupportFoldChain, support_structure


class CyclefoldError(Exception):
    pass


def _ro() -> PoseidonHash:
    return PoseidonHash(default_ro_spec(bn256_fr))


def cyclefold_marker(spec: FieldSpec, pp_digest: tuple[int, int], step: int, z_0: Sequence[int],
                     z_i: Sequence[int], self_acc: pg.AccumulatorInstance,
                     support_acc: sg.RelaxedPlonkInstance) -> int:
    """Off-circuit marker hash; the SFC's `_marker_hash` mirrors it cell for
    cell."""
    p = spec.modulus
    ro = PoseidonHash(default_ro_spec(spec))
    ro.absorb_field(pp_digest[0] % p)
    ro.absorb_field(pp_digest[1] % p)
    ro.absorb_field(step % p)
    for v in [*z_0, *z_i]:
        ro.absorb_field(v % p)
    pg.absorb_instance(ro, self_acc.ins, p)  # PG accumulator: W limbs, instances, challenges
    for b in self_acc.betas:
        ro.absorb_field(b % p)
    ro.absorb_field(self_acc.e % p)
    support_acc.absorb_into(ro, p)  # the Sangria support accumulator over grumpkin
    return ro.squeeze(NUM_CHALLENGE_BITS) % p


# -- the step-folding circuit (primary side) -------------------------------------------


@dataclass
class CyclefoldStepInputs:
    step: int
    pp_digest: tuple[int, int]
    z_0: list[int]
    z_i: list[int]
    self_acc: pg.AccumulatorInstance  # PG accumulator (instance side)
    self_incoming: PlonkInstance  # the previous primary trace's instance
    proof: pg.Proof
    support_acc: sg.RelaxedPlonkInstance  # Sangria accumulator of the support traces
    support_incoming: list[PlonkInstance]  # this step's support instances, one per primary W commitment
    support_cross_commits: list[list]  # grumpkin points, per support fold


class CyclefoldSFC:
    """Reference `src/ivc/cyclefold/sfc/` (the JAX package's layout)."""

    def __init__(self, step_circuit: StepCircuit, inputs: Optional[CyclefoldStepInputs], field_spec: FieldSpec):
        self.sc = step_circuit
        self.inp = inputs
        self.spec = field_spec
        self.x1_value: Optional[int] = None

    def configure(self, cs: ConstraintSystemBuilder):
        mg_cfg = MainGate.configure(cs, T=5)
        inst = cs.instance_column()
        sc_cfg = self.sc.configure(cs)
        return (mg_cfg, inst, sc_cfg)

    def _marker_hash(self, ctx, mg, pg_chip, fold_chip, pp, step_cell, z_0, z_i, acc_assigned, support_assigned):
        """On-circuit mirror of `cyclefold_marker`."""
        ro = PoseidonChip(mg, default_ro_spec(self.spec))
        ro.absorb_cell(pp[0])
        ro.absorb_cell(pp[1])
        ro.absorb_cell(step_cell)
        ro.absorb_iter(z_0)
        ro.absorb_iter(z_i)
        pg_chip._absorb_instance(ro, acc_assigned.ins)
        ro.absorb_iter(acc_assigned.betas)
        ro.absorb_cell(acc_assigned.e)
        fold_chip.absorb_relaxed(ro, ctx, support_assigned)
        out = ro.squeeze(ctx)
        bits = mg.le_num_to_bits(ctx, out, mg.p.bit_length())
        return mg.le_bits_to_num(ctx, bits[:NUM_CHALLENGE_BITS])

    def synthesize(self, config, asn):
        mg_cfg, inst, sc_cfg = config
        mg = MainGate(mg_cfg, asn.p)
        inp = self.inp
        ro_spec = default_ro_spec(self.spec)
        pg_chip = ProtoGalaxyVerifyChip(mg, ro_spec)
        # support instances live in grumpkin's scalar field (bn256 Fq), carried
        # as 32 x 10 nonnative limbs (the reference uses 64 x 20; PARITY.md)
        bn = BigUintChip(mg)
        fold_chip = FoldRelaxedPlonkInstanceChip(mg, ro_spec, grumpkin, bn)
        ctx = RegionCtx(asn)

        pp0 = mg.assign_value(ctx, inp.pp_digest[0])
        pp1 = mg.assign_value(ctx, inp.pp_digest[1])
        step_cell = mg.assign_value(ctx, inp.step)
        z_0 = [mg.assign_value(ctx, v) for v in inp.z_0]
        z_i = [mg.assign_value(ctx, v) for v in inp.z_i]

        acc_assigned = pg_chip.assign_accumulator(ctx, inp.self_acc)
        incoming_assigned = pg_chip.assign_instance(ctx, inp.self_incoming)
        pF, pK = pg_chip.assign_proof(ctx, inp.proof)
        support_acc_assigned = fold_chip.assign_relaxed(ctx, inp.support_acc)
        support_in_assigned = [fold_chip.assign_incoming(ctx, u) for u in inp.support_incoming]
        support_T_assigned = [[fold_chip.ecc.assign_affine(ctx, t) for t in cross]
                              for cross in inp.support_cross_commits]
        is_zero_step = mg.is_zero_term(ctx, step_cell)

        # input marker check (bypassed at the base case): the incoming trace's
        # OUTPUT marker (markers[1]) binds the state this step folds from
        computed_x0 = self._marker_hash(ctx, mg, pg_chip, fold_chip, (pp0, pp1), step_cell, z_0, z_i,
                                        acc_assigned, support_acc_assigned)
        u_markers = incoming_assigned.instances[0]
        expected = mg.conditional_select(ctx, is_zero_step, u_markers[1], computed_x0)
        ctx.constrain_equal(expected, u_markers[1])

        # on-circuit SPS verify of the incoming trace (bypassed at the base case)
        pg_chip.verify_sps(ctx, incoming_assigned, bn, NUM_CHALLENGE_BITS, bypass=is_zero_step)

        # on-circuit ProtoGalaxy verify
        folded_acc, ls = pg_chip.verify(ctx, self.spec, (pp0, pp1), acc_assigned, [incoming_assigned], pF, pK)

        # delegation consistency: the i-th support instance's public IO binds
        # p0 = acc W[i], p1 = incoming W[i], (l0, l1) and p_out = new W[i];
        # each support instance is then Sangria-folded on-circuit
        new_Ws = []
        folded_support = support_acc_assigned
        for i, (sup_in, sup_T) in enumerate(zip(support_in_assigned, support_T_assigned)):
            sup = sup_in.markers  # 8 BigUintCells
            acc_W, inc_W = acc_assigned.ins.W_commitments[i], incoming_assigned.W_commitments[i]
            for limb_a, limb_b in zip(sup[0].limbs + sup[1].limbs, acc_W.x + acc_W.y):
                ctx.constrain_equal(limb_a, limb_b)
            for limb_a, limb_b in zip(sup[2].limbs + sup[3].limbs, inc_W.x + inc_W.y):
                ctx.constrain_equal(limb_a, limb_b)
            l0_native = bn.to_native_cell(ctx, sup[4])
            l1_native = bn.to_native_cell(ctx, sup[5])
            ctx.constrain_equal(mg.conditional_select(ctx, is_zero_step, l0_native, ls[0]), l0_native)
            ctx.constrain_equal(mg.conditional_select(ctx, is_zero_step, l1_native, ls[1]), l1_native)
            new_Ws.append(AssignedBigUintPoint(sup[6].limbs, sup[7].limbs))
            folded_support, _r = fold_chip.fold(ctx, folded_support, sup_in, sup_T, (pp0, pp1))
        folded_acc.ins.W_commitments = new_Ws

        # base-case selects
        def sel_cells(a, b):
            return mg.conditional_select(ctx, is_zero_step, a, b)

        acc_out = AssignedAccumulatorInstance(
            AssignedPlonkInstancePG(
                [AssignedBigUintPoint([sel_cells(a, b) for a, b in zip(acc_W.x, new_W.x)],
                                      [sel_cells(a, b) for a, b in zip(acc_W.y, new_W.y)])
                 for acc_W, new_W in zip(acc_assigned.ins.W_commitments, new_Ws)],
                [[sel_cells(a, b) for a, b in zip(ra, rb)]
                 for ra, rb in zip(acc_assigned.ins.instances, folded_acc.ins.instances)],
                [sel_cells(a, b) for a, b in zip(acc_assigned.ins.challenges, folded_acc.ins.challenges)],
            ),
            [sel_cells(a, b) for a, b in zip(acc_assigned.betas, folded_acc.betas)],
            sel_cells(acc_assigned.e, folded_acc.e),
        )
        support_out = select_relaxed(ctx, mg, is_zero_step, support_acc_assigned, folded_support)

        # the user step
        sc_ctx = RegionCtx(asn, ctx.offset)
        z_next = self.sc.synthesize_step(sc_cfg, sc_ctx, z_i)
        ctx.offset = sc_ctx.offset
        self.z_next_values = [c.value for c in z_next]

        # output marker
        step_next = mg.add_with_const(ctx, step_cell, 1)
        x1 = self._marker_hash(ctx, mg, pg_chip, fold_chip, (pp0, pp1), step_next, z_0, z_next,
                               acc_out, support_out)
        asn.copy(u_markers[1].column, u_markers[1].row, inst, 0)
        asn.copy(x1.column, x1.row, inst, 1)
        self.x1_value = x1.value
        self.x0_value = u_markers[1].value

    def instances(self, markers: Sequence[int]) -> list[list[int]]:
        return [list(markers)]


# -- witness-tape input packing ------------------------------------------------------
# `_cf_pack` is the one walk over the dynamic leaves of CyclefoldStepInputs:
# the flattener (replay inputs) and the tracer (Tr wrapping) both ride it, so
# the two orders cannot drift.


def _cf_pack(inp: CyclefoldStepInputs, P) -> CyclefoldStepInputs:
    def pt(g):
        x, y = point_leaves(g)
        return _TrPoint(P(x), P(y))

    def pi(u):
        return SimpleNamespace(
            W_commitments=[pt(c) for c in u.W_commitments],
            instances=[[P(v) for v in row] for row in u.instances],
            challenges=[P(v) for v in u.challenges],
        )

    acc, sup = inp.self_acc, inp.support_acc
    return CyclefoldStepInputs(
        step=P(inp.step),
        pp_digest=(P(inp.pp_digest[0]), P(inp.pp_digest[1])),
        z_0=[P(v) for v in inp.z_0],
        z_i=[P(v) for v in inp.z_i],
        self_acc=SimpleNamespace(ins=pi(acc.ins), betas=[P(b) for b in acc.betas], e=P(acc.e)),
        self_incoming=pi(inp.self_incoming),
        proof=SimpleNamespace(
            poly_F=SimpleNamespace(coeffs=[P(c) for c in inp.proof.poly_F.coeffs]),
            poly_K=SimpleNamespace(coeffs=[P(c) for c in inp.proof.poly_K.coeffs]),
        ),
        support_acc=SimpleNamespace(
            W_commitments=[pt(c) for c in sup.W_commitments],
            E_commitment=pt(sup.E_commitment),
            consistency_markers=[P(v) for v in sup.consistency_markers],
            challenges=[P(v) for v in sup.challenges],
            u=P(sup.u),
            sc_instances_hash_acc=None if sup.sc_instances_hash_acc is None else P(sup.sc_instances_hash_acc),
        ),
        support_incoming=[pi(u) for u in inp.support_incoming],
        support_cross_commits=[[pt(t) for t in cross] for cross in inp.support_cross_commits],
    )


class CyclefoldPublicParams:
    """Reference `ivc/cyclefold/.../public_params.rs` (the JAX package's
    simplified form): the support and primary structures, the pp digest and
    the two folding schemes' parameters."""

    def __init__(self, step_circuit: StepCircuit, k: int, ck_primary, ck_support):
        self.sc = step_circuit
        self.k = k
        self.ck1 = ck_primary
        self.ck2 = ck_support
        self.f1 = bn256_fr
        self.f2 = bn256_fq
        self.S_support = support_structure(SUPPORT_K)

        # primary SFC structure by a dry run; the gate count and degrees are
        # probed first so that the dry proof polynomials have the real lengths
        probe_cs = ConstraintSystemBuilder()
        CyclefoldSFC(step_circuit, None, self.f1).configure(probe_cs)
        probe_meta = ConstraintSystemMetainfo.build(k, probe_cs)
        self.n_gates = max(len(probe_meta.gates), 1)
        probe_ctx = QueryIndexContext(
            num_selectors=probe_cs.num_selectors,
            num_fixed=probe_cs.num_fixed,
            num_advice=probe_cs.num_advice,
            num_lookups=probe_meta.lookup_arguments.num_lookups() if probe_meta.lookup_arguments else 0,
            num_challenges=probe_meta.num_challenges,
        )
        self.max_gate_degree = max((g.degree(probe_ctx) for g in probe_meta.gates), default=0)
        self.num_challenges_primary = probe_meta.num_challenges
        self.num_witness_primary = len(probe_meta.round_sizes)
        # the structure by a dry synthesis over traced inputs
        sfc_tape = TapeBuilder()
        dry_inputs = _cf_pack(self._dry_inputs(), lambda v: sfc_tape.input())
        restore_sc = sc_trace_bind(sfc_tape, step_circuit)
        dry = CyclefoldSFC(step_circuit, dry_inputs, self.f1)
        runner = CircuitRunner(k, self.f1, dry, [[0, 0]])
        try:
            self.S_primary = runner.collect_plonk_structure()
        finally:
            restore_sc()
        if len(self.S_primary.gates) != self.n_gates:
            raise CyclefoldError(f"dry structure has {len(self.S_primary.gates)} gates, probe {self.n_gates}")

        bits = digest_ints_to_bits(structure_digest_stream(self.S_primary) + structure_digest_stream(self.S_support))
        self.digest = into_curve_from_bits(bn256_g1, bits)

    def digest_coords(self) -> tuple[int, int]:
        d = self.digest
        return (0, 0) if d.is_identity else (d.x, d.y)

    def digest_hex(self) -> str:
        x, y = self.digest_coords()
        return f"{x:064x}{y:064x}"

    def num_cross_terms_support(self) -> int:
        return self.S_support.get_degree_for_folding() - 1

    def count_padded(self) -> int:
        return pg._next_pow2((1 << self.k) * self.n_gates)

    def betas_count(self) -> int:
        return self.count_padded().bit_length() - 1

    def _dry_inputs(self) -> CyclefoldStepInputs:
        f_len = pg._next_pow2(self.betas_count() + 1)
        g_pts = pg._next_pow2(self.max_gate_degree + 1)  # L = 1
        k_len = 1 << pg._next_pow2(max(g_pts + 1 - 2, 1))
        return CyclefoldStepInputs(
            step=0,
            pp_digest=(0, 0),
            z_0=[0] * self.sc.arity,
            z_i=[0] * self.sc.arity,
            self_acc=self._initial_pg_acc_instance(),
            self_incoming=self._default_primary_incoming(),
            proof=pg.Proof(UnivariatePoly(self.f1, [0] * f_len), UnivariatePoly(self.f1, [0] * k_len)),
            support_acc=sg.RelaxedPlonkInstance.new(grumpkin, 0, 1, 0, markers_len=SUPPORT_IO),
            support_incoming=[PlonkInstance([gold.identity(grumpkin)], [[0] * SUPPORT_IO], [])
                              for _ in range(self.num_witness_primary)],
            support_cross_commits=[[gold.identity(grumpkin)] * self.num_cross_terms_support()
                                   for _ in range(self.num_witness_primary)],
        )

    def _default_primary_incoming(self) -> PlonkInstance:
        return PlonkInstance([gold.identity(bn256_g1)] * self.num_witness_primary, [[0, 0]],
                             [0] * self.num_challenges_primary)

    def _initial_pg_acc_instance(self) -> pg.AccumulatorInstance:
        return pg.AccumulatorInstance(self._default_primary_incoming(), [0] * self.betas_count(), 0)


# -- verify ---------------------------------------------------------------------------


class CyclefoldIVC:
    """A Cyclefold chain's state as a verifier holds it, and `verify`
    (reference `ivc/cyclefold/incrementally_verifiable_computation`).  The
    prover (`new`, `next`) is left out: the state is the program's."""

    def __init__(self, pp: CyclefoldPublicParams, step: int, z_0: Sequence[int], z_i: Sequence[int],
                 self_acc: pg.Accumulator, primary_trace: PlonkTrace, support: SupportFoldChain):
        self.pp, self.step, self.z_0, self.z_i = pp, step, list(z_0), list(z_i)
        self.self_acc, self.primary_trace, self.support = self_acc, primary_trace, support

    def verify(self) -> list:
        """Marker replay and is_sat of both accumulators and the pending
        trace (reference `verify`, mod.rs:337-393)."""
        pp = self.pp
        f1 = pp.f1
        errors = []
        # the pending trace's X1 commits to the current accumulator state
        expected_x1 = cyclefold_marker(f1, pp.digest_coords(), self.step, self.z_0, self.z_i,
                                       pg.AccumulatorInstance.from_acc(self.self_acc), self.support.acc.U)
        if expected_x1 != self.primary_trace.u.instances[0][1] % f1.modulus:
            errors.append("marker X1 mismatch")
        errors += [f"pg: {e}" for e in pg.ProtoGalaxy.is_sat(pp.ck1, pp.S_primary, self.self_acc,
                                                              check_commit=False)]
        errors += [f"support: {e}" for e in self.support.is_sat()]
        try:
            satisfy.is_sat(pp.S_primary, pp.ck1, _ro(), self.primary_trace.u, self.primary_trace.w,
                           check_commit=False)
        except satisfy.IsSatError as e:
            errors.append(f"primary trace: {e}")
        # one RLC MSM covers every primary-curve opening: the PG accumulator's
        # witness rounds and the pending trace's
        pairs = (list(zip(self.self_acc.trace.w.W, self.self_acc.trace.u.W_commitments))
                 + list(zip(self.primary_trace.w.W, self.primary_trace.u.W_commitments)))
        bad = pp.ck1.batched_commit_check(pairs)
        if bad:
            errors.append(f"commitment mismatch (pair indices {bad})")
        return errors
