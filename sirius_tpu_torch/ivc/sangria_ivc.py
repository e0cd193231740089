"""Sangria IVC: two mirrored step-folding circuits on the bn256/grumpkin cycle.

Counterpart of `sirius_tpu/ivc/sangria_ivc.py` (reference `src/ivc/sangria/
{incrementally_verifiable_computation,step_folding_circuit,public_params}.rs`),
bit for bit.  The public parameters trace both sides' step-folding circuits
once, during the dry syntheses that collect their structures
(`frontend/taped.py`); every witness after that, the secondary pre-round
trace's included, is a native replay of those tapes.  Direct synthesis
(`IVC._witness_direct`) is the replay's plain version, used by the tests
and `chip_smoke.py` only.

Each side's StepFoldingCircuit (the augmented circuit F') verifies the fold
of the *other* side's instances:

  1. assign pp digest, step, z_0, z_i, relaxed U, incoming u, cross terms T
  2. recompute the input consistency marker X0 = RO(pp, step, z_0, z_i, U)
     and constrain it against the incoming instance's output marker
     (bypassed at step 0)
  3. fold: U' = fold(U, u, T) via the fold chip (base case selects U)
  4. run the user step circuit z_{i+1} = F(z_i)
  5. expose X0 and X1 = RO(pp, step+1, z_0, z_{i+1}, U') as the two public
     consistency markers

Tensors live on the keys' device; under an active mesh that divides a
side's rows, that side's W rounds and E as row blocks (`parallel/rows.py`:
the SPS places them, `RelaxedPlonkWitness.from_regular` places the
relaxed pre-round trace).  `fold_step` runs in the spans
`prove_secondary`, `sfc_witness_primary`, `sps_primary`, `prove_primary`,
`sfc_witness_secondary` and `sps_secondary` (`util/profiling`); each prove
holds `sangria_cross_terms`, `sangria_challenge` and `sangria_fold`.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional, Sequence

from ..fields import gold
from ..fields.constants import CurveSpec, FieldSpec, bn256_g1, grumpkin
from ..frontend.circuit import ConstraintSystemBuilder
from ..frontend.runner import CircuitRunner, ConstraintSystemMetainfo
from ..frontend.tape import TapeBuilder
from ..frontend.taped import TapedSynthesis, _TrPoint, point_leaves, sc_dynamic_values, sc_trace_bind
from ..gadgets.big_uint_chip import BigUintCells, BigUintChip
from ..gadgets.ecc_chip import AssignedPoint
from ..gadgets.fold_chip import AssignedRelaxedPlonkInstance, FoldRelaxedPlonkInstanceChip
from ..gadgets.main_gate import AssignedCell, MainGate, RegionCtx
from ..gadgets.poseidon_chip import PoseidonChip
from ..nifs.sangria import RelaxedPlonkInstance, RelaxedPlonkTrace, RelaxedPlonkWitness, VanillaFS
from ..ops.poseidon import PoseidonHash
from ..plonk import satisfy
from ..plonk.sps import run_sps_protocol
from ..plonk.structure import PlonkInstance
from ..util.digest import digest_ints_to_bits, into_curve_from_bits, structure_digest_stream
from ..util.profiling import span
from ..util.ro import NUM_CHALLENGE_BITS, default_ro_spec
from .consistency_markers import DEFAULT_MARKER_LIMB_WIDTH, DEFAULT_MARKER_LIMBS_COUNT, generate_consistency_marker
from .step_circuit import StepCircuit

MAIN_GATE_T = 5


class SangriaIVCError(Exception):
    pass


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


@dataclass
class StepInputs:
    """Host-side inputs of one SFC synthesis (reference `StepInputs`)."""

    step: int
    pp_digest: tuple[int, int]  # paired-curve point coords (native field)
    z_0: list[int]
    z_i: list[int]
    U: RelaxedPlonkInstance  # of the paired curve
    u: PlonkInstance  # incoming paired instance
    cross_term_commits: list  # gold points on the paired curve


class StepFoldingCircuit:
    """One side's augmented circuit (reference `step_folding_circuit.rs`)."""

    def __init__(self, step_circuit: StepCircuit, inputs: StepInputs, paired_curve: CurveSpec, field_spec: FieldSpec):
        self.sc = step_circuit
        self.inp = inputs
        self.paired = paired_curve
        self.spec = field_spec
        self.x1_value: Optional[int] = None

    def configure(self, cs: ConstraintSystemBuilder):
        mg_cfg = MainGate.configure(cs, T=MAIN_GATE_T)
        inst = cs.instance_column()
        sc_cfg = self.sc.configure(cs)
        return (mg_cfg, inst, sc_cfg)

    def _marker_hash(self, ctx: RegionCtx, mg: MainGate, bn: BigUintChip, pp: tuple[AssignedCell, AssignedCell],
                     step_cell: AssignedCell, z_0: Sequence[AssignedCell], z_i: Sequence[AssignedCell],
                     U: AssignedRelaxedPlonkInstance) -> AssignedCell:
        """On-circuit mirror of `generate_consistency_marker`: the markers and
        challenges enter as the 32 x 10 limbs of their native cast."""
        ro = PoseidonChip(mg, default_ro_spec(self.spec))
        ro.absorb_cell(pp[0])
        ro.absorb_cell(pp[1])
        ro.absorb_cell(step_cell)
        ro.absorb_iter(z_0)
        ro.absorb_iter(z_i)
        for pt in U.W_commitments:
            ro.absorb_cell(pt.x)
            ro.absorb_cell(pt.y)
        ro.absorb_cell(U.E_commitment.x)
        ro.absorb_cell(U.E_commitment.y)
        cast_bn = BigUintChip(mg, DEFAULT_MARKER_LIMB_WIDTH, DEFAULT_MARKER_LIMBS_COUNT)
        for bu in [*U.consistency_markers, *U.challenges]:
            native = bn.to_native_cell(ctx, bu)
            ro.absorb_iter(cast_bn.from_assigned_cell(ctx, native).limbs)
        ro.absorb_cell(bn.to_native_cell(ctx, U.u))
        if U.sc_hash_acc is None:
            ro.absorb_base(0)
        else:
            ro.absorb_cell(U.sc_hash_acc)
        out = ro.squeeze(ctx)
        # truncated to 128 bits like the off-circuit marker
        bits = mg.le_num_to_bits(ctx, out, mg.p.bit_length())
        return mg.le_bits_to_num(ctx, bits[:NUM_CHALLENGE_BITS])

    def synthesize(self, config, asn):
        mg_cfg, inst, sc_cfg = config
        mg = MainGate(mg_cfg, asn.p)
        bn = BigUintChip(mg)
        fold_chip = FoldRelaxedPlonkInstanceChip(mg, default_ro_spec(self.spec), self.paired, bn)
        ctx = RegionCtx(asn)
        inp = self.inp

        pp0 = mg.assign_value(ctx, inp.pp_digest[0])
        pp1 = mg.assign_value(ctx, inp.pp_digest[1])
        step_cell = mg.assign_value(ctx, inp.step)
        z_0 = [mg.assign_value(ctx, v) for v in inp.z_0]
        z_i = [mg.assign_value(ctx, v) for v in inp.z_i]

        U_assigned = fold_chip.assign_relaxed(ctx, inp.U)
        u_assigned = fold_chip.assign_incoming(ctx, inp.u)
        T_assigned = [fold_chip.ecc.assign_affine(ctx, t) for t in inp.cross_term_commits]

        is_zero_step = mg.is_zero_term(ctx, step_cell)

        # X0 input-hash check (reference :512-568): the recomputed hash of this
        # side's input state must equal the incoming instance's first marker
        # (which the previous step set to this side's own X1); bypassed at the
        # base case
        computed_x0 = self._marker_hash(ctx, mg, bn, (pp0, pp1), step_cell, z_0, z_i, U_assigned)
        u_x0_native = bn.to_native_cell(ctx, u_assigned.markers[0])
        u_x1_native = bn.to_native_cell(ctx, u_assigned.markers[1])
        expected = mg.conditional_select(ctx, is_zero_step, u_x0_native, computed_x0)
        ctx.constrain_equal(expected, u_x0_native)

        # the step circuit's public-instance hash chain (reference
        # `instances_accumulator_computation.rs:70-84`): acc' = Poseidon(acc,
        # u.instances[1:]) reduced mod the paired scalar field
        sc_next_cell = None
        if U_assigned.sc_hash_acc is not None:
            sc_ro = PoseidonChip(mg, default_ro_spec(self.spec))
            sc_ro.absorb_cell(U_assigned.sc_hash_acc)
            for col in u_assigned.sc_instances:
                sc_ro.absorb_iter(col)
            s = sc_ro.squeeze(ctx)
            _, r_bn = bn.red_mod(ctx, bn.from_assigned_cell(ctx, s), fold_chip.q)
            sc_next_cell = bn.to_native_cell(ctx, r_bn)

        # fold (non-base) then the base-case select (reference :572-635)
        folded, _r = fold_chip.fold(ctx, U_assigned, u_assigned, T_assigned, (pp0, pp1), sc_next_hash_acc=sc_next_cell)
        U_out = select_relaxed(ctx, mg, is_zero_step, U_assigned, folded)

        # the user step (reference :637-643)
        sc_ctx = RegionCtx(asn, ctx.offset)
        z_next = self.sc.synthesize_step(sc_cfg, sc_ctx, z_i)
        ctx.offset = sc_ctx.offset

        # step counter and the output hash X1 (reference :478-509, 645-700)
        self.z_next_values = [c.value for c in z_next]
        step_next = mg.add_with_const(ctx, step_cell, 1)
        x1 = self._marker_hash(ctx, mg, bn, (pp0, pp1), step_next, z_0, z_next, U_out)

        # the public instance [X0, X1]
        asn.copy(u_x1_native.column, u_x1_native.row, inst, 0)
        asn.copy(x1.column, x1.row, inst, 1)
        self.x1_value = x1.value
        self.x0_value = u_x1_native.value

    def instances(self, markers: Sequence[int]) -> list[list[int]]:
        """[markers] + the step circuit's own public instance columns."""
        return [list(markers)] + [list(c) for c in self.sc.instances()]


# -- witness-tape input packing (the Cyclefold SFC's scheme: ivc/cyclefold_ivc._cf_pack) --


def _sg_pack(inp: StepInputs, P) -> StepInputs:
    def pt(g):
        x, y = point_leaves(g)
        return _TrPoint(P(x), P(y))

    U = inp.U
    return StepInputs(
        step=P(inp.step),
        pp_digest=(P(inp.pp_digest[0]), P(inp.pp_digest[1])),
        z_0=[P(v) for v in inp.z_0],
        z_i=[P(v) for v in inp.z_i],
        U=SimpleNamespace(
            W_commitments=[pt(c) for c in U.W_commitments],
            E_commitment=pt(U.E_commitment),
            consistency_markers=[P(v) for v in U.consistency_markers],
            challenges=[P(v) for v in U.challenges],
            u=P(U.u),
            sc_instances_hash_acc=None if U.sc_instances_hash_acc is None else P(U.sc_instances_hash_acc),
        ),
        u=SimpleNamespace(
            W_commitments=[pt(c) for c in inp.u.W_commitments],
            instances=[[P(v) for v in row] for row in inp.u.instances],
            challenges=[P(v) for v in inp.u.challenges],
        ),
        cross_term_commits=[pt(t) for t in inp.cross_term_commits],
    )


def _sg_flatten(inp: StepInputs, sc=None) -> list[int]:
    """The SFC tape's inputs for `inp`, then the step circuit's dynamic
    witness (stateful step circuits only)."""
    out: list[int] = []

    def P(v):
        out.append(int(v))
        return v

    _sg_pack(inp, P)
    if sc is not None:
        out.extend(sc_dynamic_values(sc))
    return out


def _trace_sfc(k: int, fspec: FieldSpec, sc: StepCircuit, inputs: StepInputs, paired: CurveSpec, instances):
    """Dry-run an SFC in trace mode: returns (structure, TapedSynthesis)."""
    tape = TapeBuilder()
    wrapped = _sg_pack(inputs, lambda v: tape.input())
    restore_sc = sc_trace_bind(tape, sc)
    sfc = StepFoldingCircuit(sc, wrapped, paired, fspec)
    runner = CircuitRunner(k, fspec, sfc, instances)
    try:
        S = runner.collect_plonk_structure()
    finally:
        restore_sc()
    named = {"x0": sfc.x0_value, "x1": sfc.x1_value}
    named.update({f"z{i}": v for i, v in enumerate(sfc.z_next_values)})
    return S, TapedSynthesis(tape, runner._asn, named=named)


# -- public parameters ----------------------------------------------------------------


@dataclass
class SideParams:
    curve: CurveSpec  # the curve whose scalar field this side's circuit uses
    paired: CurveSpec
    k: int
    ck: object  # CommitmentKey on `curve`, or a test double
    S: object = None  # PlonkStructure, filled by PublicParams
    taped: object = None  # the SFC's TapedSynthesis, filled by PublicParams


@dataclass
class SideProbe:
    """Shape of one side's SFC instances from a configure-only pass: cross
    terms, SPS challenges and witness commitments (all change when the step
    circuit registers gates of its own), and the lengths of the step
    circuit's own public instance columns."""

    num_cross_terms: int
    num_challenges: int
    num_witness: int
    sc_instance_lens: tuple[int, ...] = ()


def _initial_relaxed(paired: CurveSpec, probe: Optional[SideProbe] = None) -> RelaxedPlonkInstance:
    return RelaxedPlonkInstance.new(
        paired,
        num_challenges=probe.num_challenges if probe else 0,
        num_witness=probe.num_witness if probe else 1,
        num_sc_instances=sum(probe.sc_instance_lens) if probe else 0,
    )


def _default_incoming(paired: CurveSpec, probe: Optional[SideProbe] = None) -> PlonkInstance:
    return PlonkInstance(
        [gold.identity(paired)] * (probe.num_witness if probe else 1),
        [[0, 0]] + [[0] * n for n in (probe.sc_instance_lens if probe else ())],
        [0] * (probe.num_challenges if probe else 0),
    )


def _ro(spec: FieldSpec) -> PoseidonHash:
    return PoseidonHash(default_ro_spec(spec))


class PublicParams:
    """Reference `public_params.rs:245-385`: both sides' probes and
    structures (from dry SFCs), the secondary pre-round trace and the two pp
    digest points."""

    def __init__(self, primary_sc: StepCircuit, secondary_sc: StepCircuit, k1: int, k2: int, ck1, ck2):
        self.primary = SideParams(bn256_g1, grumpkin, k1, ck1)
        self.secondary = SideParams(grumpkin, bn256_g1, k2, ck2)
        self.primary_sc = primary_sc
        self.secondary_sc = secondary_sc
        f1 = self.primary.curve.scalar  # bn256 Fr
        f2 = self.secondary.curve.scalar  # bn256 Fq

        # each side's shapes come from its own gates: a step circuit with gates
        # of its own raises the folding degree and the challenge count, and the
        # paired SFC assigns exactly this many cross terms
        self.primary_probe = self._probe_side(primary_sc, self.primary, f1, k1)
        self.secondary_probe = self._probe_side(secondary_sc, self.secondary, f2, k2)
        self.primary_num_cross_terms = self.primary_probe.num_cross_terms
        self.secondary_num_cross_terms = self.secondary_probe.num_cross_terms

        # both structures by dry-running the SFCs on traced placeholders (the
        # dry runs are the witness traces); each SFC folds the paired side's
        # instances, so it assigns the paired side's shapes
        def dry_inputs(side: SideParams, sc, paired_probe: SideProbe) -> StepInputs:
            return StepInputs(
                step=0, pp_digest=(0, 0), z_0=[0] * sc.arity, z_i=[0] * sc.arity,
                U=_initial_relaxed(side.paired, paired_probe), u=_default_incoming(side.paired, paired_probe),
                cross_term_commits=[gold.identity(side.paired)] * paired_probe.num_cross_terms,
            )

        pri_inp = dry_inputs(self.primary, primary_sc, self.secondary_probe)
        self.primary.S, self.primary.taped = _trace_sfc(
            k1, f1, primary_sc, pri_inp, self.primary.paired,
            StepFoldingCircuit(primary_sc, pri_inp, self.primary.paired, f1).instances([0, 0]))

        # the secondary structure and the initial secondary trace (pre-round)
        sec_inp = dry_inputs(self.secondary, secondary_sc, self.primary_probe)
        sec_sfc = StepFoldingCircuit(secondary_sc, sec_inp, self.secondary.paired, f2)
        sec_z_out = secondary_sc.process_step([0] * secondary_sc.arity, k2, f2)
        sec_markers = [
            0,  # the cast of the default incoming u's marker[1]
            generate_consistency_marker(default_ro_spec(f2), self.secondary.paired,
                                        gold.identity(self.secondary.paired), 1, [0] * secondary_sc.arity,
                                        sec_z_out, _initial_relaxed(self.secondary.paired, self.primary_probe)),
        ]
        self.secondary.S, self.secondary.taped = _trace_sfc(k2, f2, secondary_sc, sec_inp, self.secondary.paired,
                                                             sec_sfc.instances(sec_markers))
        sec_witness = IVC._witness(self.secondary, sec_sfc, f2, sec_markers[1])
        self.secondary_initial_plonk_trace = run_sps_protocol(
            self.secondary.S, ck2, sec_sfc.instances(sec_markers), sec_witness, _ro(f1))

        bits = digest_ints_to_bits(structure_digest_stream(self.primary.S) + structure_digest_stream(self.secondary.S))
        self.digest_1 = into_curve_from_bits(self.primary.curve, bits)
        self.digest_2 = into_curve_from_bits(self.secondary.curve, bits)

    @staticmethod
    def _probe_side(sc: StepCircuit, side: SideParams, fspec: FieldSpec, k: int) -> SideProbe:
        """Cross-term count = the compressed gate's grouped length minus 1 (one
        T per degree >= 1 term), plus the SPS challenge and witness-commitment
        counts, from a configure-only pass (the gate set does not depend on
        the inputs)."""
        dummy = StepInputs(step=0, pp_digest=(0, 0), z_0=[0] * sc.arity, z_i=[0] * sc.arity,
                           U=_initial_relaxed(side.paired), u=_default_incoming(side.paired), cross_term_commits=[])
        cs = ConstraintSystemBuilder()
        StepFoldingCircuit(sc, dummy, side.paired, fspec).configure(cs)
        meta = ConstraintSystemMetainfo.build(k, cs)
        return SideProbe(
            num_cross_terms=len(meta.custom_gates_lookup_compressed.grouped) - 1,
            num_challenges=meta.num_challenges,
            num_witness=len(meta.round_sizes),
            sc_instance_lens=tuple(len(c) for c in sc.instances()),
        )

    def digest_coords(self, which: int) -> tuple[int, int]:
        d = self.digest_1 if which == 1 else self.digest_2
        return (0, 0) if d.is_identity else (d.x, d.y)


# -- new / fold_step / verify ---------------------------------------------------------


class IVC:
    """Reference `IVC` (`incrementally_verifiable_computation.rs:116`)."""

    def __init__(self, pp: PublicParams, primary_z_0: Sequence[int], secondary_z_0: Sequence[int]):
        """The zero step (reference `IVC::new`)."""
        f1 = pp.primary.curve.scalar
        f2 = pp.secondary.curve.scalar
        self.pp = pp
        self.step = 1

        sec_pre_trace = pp.secondary_initial_plonk_trace
        primary_z_out = pp.primary_sc.process_step(primary_z_0, pp.primary.k, f1)
        # the secondary accumulator starts as the relaxation of the pre-round
        # trace (reference `RelaxedPlonkTrace::from_regular`, ivc::new :218)
        sec_relaxed = RelaxedPlonkTrace(
            U=RelaxedPlonkInstance.from_instance(pp.secondary.curve, sec_pre_trace.u),
            W=RelaxedPlonkWitness.from_regular(sec_pre_trace.w, pp.secondary.k, pp.secondary.S.field),
        )
        primary_markers = [
            sec_pre_trace.u.instances[0][1] % f1.modulus,
            generate_consistency_marker(default_ro_spec(f1), pp.primary.paired, pp.digest_2, 1, list(primary_z_0),
                                        primary_z_out, sec_relaxed.U),
        ]
        primary_sfc = StepFoldingCircuit(
            pp.primary_sc,
            StepInputs(0, pp.digest_coords(2), list(primary_z_0), list(primary_z_0), sec_relaxed.U, sec_pre_trace.u,
                       [gold.identity(pp.primary.paired)] * pp.secondary_num_cross_terms),
            pp.primary.paired, f1,
        )
        primary_instances = primary_sfc.instances(primary_markers)
        primary_witness = self._witness(pp.primary, primary_sfc, f1, primary_markers[1])

        self.primary_nifs_pp, _ = VanillaFS.setup_params(pp.digest_1, pp.primary.S)
        self.secondary_nifs_pp, _ = VanillaFS.setup_params(pp.digest_2, pp.secondary.S)

        primary_trace = run_sps_protocol(pp.primary.S, pp.primary.ck, primary_instances, primary_witness, _ro(f2))
        # the primary accumulator is the relaxation of the step-0 primary trace
        primary_relaxed = RelaxedPlonkTrace(
            U=RelaxedPlonkInstance.from_instance(pp.primary.curve, primary_trace.u),
            W=RelaxedPlonkWitness.from_regular(primary_trace.w, pp.primary.k, pp.primary.S.field),
        )

        secondary_z_out = pp.secondary_sc.process_step(secondary_z_0, pp.secondary.k, f2)
        secondary_markers = [
            primary_trace.u.instances[0][1] % f2.modulus,
            generate_consistency_marker(default_ro_spec(f2), pp.secondary.paired, pp.digest_1, 1,
                                        list(secondary_z_0), secondary_z_out, primary_relaxed.U),
        ]
        secondary_sfc = StepFoldingCircuit(
            pp.secondary_sc,
            StepInputs(0, pp.digest_coords(1), list(secondary_z_0), list(secondary_z_0), primary_relaxed.U,
                       primary_trace.u, [gold.identity(pp.secondary.paired)] * pp.primary_num_cross_terms),
            pp.secondary.paired, f2,
        )
        secondary_instances = secondary_sfc.instances(secondary_markers)
        secondary_witness = self._witness(pp.secondary, secondary_sfc, f2, secondary_markers[1])
        secondary_trace = run_sps_protocol(pp.secondary.S, pp.secondary.ck, secondary_instances, secondary_witness,
                                           _ro(f1))

        self.primary_z_0, self.primary_z_i = list(primary_z_0), primary_z_out
        self.secondary_z_0, self.secondary_z_i = list(secondary_z_0), secondary_z_out
        self.primary_relaxed = primary_relaxed
        self.secondary_relaxed = sec_relaxed
        self.secondary_trace = secondary_trace
        # seeded with the traces the accumulators were relaxed from, so that the
        # sc-instance hash replay in is_sat covers the whole chain
        self.primary_pub_instances: list = [primary_trace.u.instances]
        self.secondary_pub_instances: list = [sec_pre_trace.u.instances]

    @staticmethod
    def _witness(side: SideParams, sfc: StepFoldingCircuit, fspec: FieldSpec, expect_x1: int):
        """The SFC's advice columns by native replay of the side's tape, with
        the on- and off-circuit X1 checked equal."""
        W, named = side.taped.replay(_sg_flatten(sfc.inp, sfc.sc))
        if named["x1"] != expect_x1 % fspec.modulus:
            raise SangriaIVCError("on- and off-circuit X1 markers differ (a stateful step circuit must implement "
                                  "dynamic_witness/bind_witness: ivc/step_circuit.py)")
        return W

    @staticmethod
    def _witness_direct(side: SideParams, sfc: StepFoldingCircuit, fspec: FieldSpec, instances, expect_x1: int):
        """The replay's plain version: the SFC's advice columns by direct
        synthesis, with the on- and off-circuit X1 checked equal."""
        W = CircuitRunner(side.k, fspec, sfc, instances).collect_witness()
        if sfc.x1_value != expect_x1 % fspec.modulus:
            raise SangriaIVCError("on- and off-circuit X1 markers differ")
        return W

    def fold_step(self):
        """One IVC step (reference `fold_step`)."""
        pp = self.pp
        f1 = pp.primary.curve.scalar
        f2 = pp.secondary.curve.scalar

        # fold the secondary trace into the secondary accumulator (off-circuit)
        with span("prove_secondary"):
            sec_new_trace, sec_ct_commits = VanillaFS.prove(pp.secondary.ck, self.secondary_nifs_pp, _ro(f1),
                                                            self.secondary_relaxed, self.secondary_trace)
        self.secondary_pub_instances.append(self.secondary_trace.u.instances)

        # the primary SFC verifies that fold
        primary_z_next = pp.primary_sc.process_step(self.primary_z_i, pp.primary.k, f1)
        primary_markers = [
            self.secondary_trace.u.instances[0][1] % f1.modulus,
            generate_consistency_marker(default_ro_spec(f1), pp.primary.paired, pp.digest_2, self.step + 1,
                                        self.primary_z_0, primary_z_next, sec_new_trace.U),
        ]
        primary_sfc = StepFoldingCircuit(
            pp.primary_sc,
            StepInputs(self.step, pp.digest_coords(2), self.primary_z_0, self.primary_z_i, self.secondary_relaxed.U,
                       self.secondary_trace.u, sec_ct_commits),
            pp.primary.paired, f1,
        )
        primary_instances = primary_sfc.instances(primary_markers)
        with span("sfc_witness_primary"):
            primary_witness = self._witness(pp.primary, primary_sfc, f1, primary_markers[1])
        self.primary_z_i = primary_z_next
        self.secondary_relaxed = sec_new_trace
        with span("sps_primary"):
            primary_trace = run_sps_protocol(pp.primary.S, pp.primary.ck, primary_instances, primary_witness,
                                             _ro(f2))

        # fold the primary trace into the primary accumulator (off-circuit)
        with span("prove_primary"):
            pri_new_trace, pri_ct_commits = VanillaFS.prove(pp.primary.ck, self.primary_nifs_pp, _ro(f2),
                                                            self.primary_relaxed, primary_trace)
        self.primary_pub_instances.append(primary_trace.u.instances)

        # the secondary SFC verifies that fold
        secondary_z_next = pp.secondary_sc.process_step(self.secondary_z_i, pp.secondary.k, f2)
        secondary_markers = [
            primary_trace.u.instances[0][1] % f2.modulus,
            generate_consistency_marker(default_ro_spec(f2), pp.secondary.paired, pp.digest_1, self.step + 1,
                                        self.secondary_z_0, secondary_z_next, pri_new_trace.U),
        ]
        secondary_sfc = StepFoldingCircuit(
            pp.secondary_sc,
            StepInputs(self.step, pp.digest_coords(1), self.secondary_z_0, self.secondary_z_i,
                       self.primary_relaxed.U, primary_trace.u, pri_ct_commits),
            pp.secondary.paired, f2,
        )
        secondary_instances = secondary_sfc.instances(secondary_markers)
        with span("sfc_witness_secondary"):
            secondary_witness = self._witness(pp.secondary, secondary_sfc, f2, secondary_markers[1])
        self.secondary_z_i = secondary_z_next
        self.primary_relaxed = pri_new_trace
        with span("sps_secondary"):
            self.secondary_trace = run_sps_protocol(pp.secondary.S, pp.secondary.ck, secondary_instances,
                                                    secondary_witness, _ro(f1))
        self.step += 1

    def verify(self) -> list:
        """Marker replay and is_sat of both accumulators and the pending
        secondary trace (reference `verify`)."""
        pp = self.pp
        f1 = pp.primary.curve.scalar
        f2 = pp.secondary.curve.scalar
        errors = []
        expected_x0 = generate_consistency_marker(default_ro_spec(f1), pp.primary.paired, pp.digest_2, self.step,
                                                  self.primary_z_0, self.primary_z_i, self.secondary_relaxed.U)
        if expected_x0 != self.secondary_trace.u.instances[0][0] % f1.modulus:
            errors.append("primary X0 marker mismatch")
        expected_x1 = generate_consistency_marker(default_ro_spec(f2), pp.secondary.paired, pp.digest_1, self.step,
                                                  self.secondary_z_0, self.secondary_z_i, self.primary_relaxed.U)
        if expected_x1 != self.secondary_trace.u.instances[0][1] % f2.modulus:
            errors.append("secondary X1 marker mismatch")
        with span("verify_primary_is_sat"):
            errors += [f"primary: {e}" for e in VanillaFS.is_sat(pp.primary.ck, pp.primary.S, self.primary_relaxed,
                                                                  self.primary_pub_instances)]
        with span("verify_secondary_is_sat"):
            errors += [f"secondary: {e}" for e in VanillaFS.is_sat(pp.secondary.ck, pp.secondary.S,
                                                                    self.secondary_relaxed,
                                                                    self.secondary_pub_instances)]
        with span("verify_secondary_trace"):
            try:
                satisfy.is_sat(pp.secondary.S, pp.secondary.ck, _ro(f1), self.secondary_trace.u,
                               self.secondary_trace.w)
            except satisfy.IsSatError as e:
                errors.append(f"secondary trace: {e}")
        return errors
