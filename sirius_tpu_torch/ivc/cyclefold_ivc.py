"""Cyclefold IVC: ProtoGalaxy on the primary curve and a Sangria-folded EC
support circuit on the secondary curve.

Counterpart of `sirius_tpu/ivc/cyclefold_ivc.py` (reference
`src/ivc/cyclefold/`), bit for bit.  The public parameters trace the
step-folding circuit and the support circuit once, during the dry syntheses
that collect their structures (`frontend/taped.py`); every step's witnesses
are native replays of those tapes.  Direct synthesis
(`CyclefoldIVC._sfc_witness_direct`) is the replay's plain version, used by
the tests and `chip_smoke.py` only:

  next(z_i):
    1. ProtoGalaxy prove(primary_acc, [primary_trace])        (off-circuit)
    2. re-derive gamma verifier-style; [l0, l1] = L(gamma)
    3. delegate W_new = l0 W_acc + l1 W_inc to the support circuit, one
       support fold per W commitment (`ivc/support_fold.py`), checked
       against the PG fold's W commitment
    4. synthesize the step-folding circuit (SFC, over bn256 Fr): on-circuit
       ProtoGalaxy verify, on-circuit Sangria fold of the support instances,
       the delegation consistency, the input/output markers
    5. SPS the new primary trace on the primary key
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
from ..frontend.taped import TapedSynthesis, _TrPoint, point_leaves, sc_dynamic_values, sc_is_stateful, sc_trace_bind
from ..gadgets.big_uint_chip import BigUintChip
from ..gadgets.fold_chip import FoldRelaxedPlonkInstanceChip
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
from ..plonk.sps import run_sps_protocol
from ..plonk.structure import PlonkInstance, PlonkTrace, PlonkWitness
from ..poly import lagrange
from ..poly.expression import QueryIndexContext
from ..poly.univariate import UnivariatePoly
from ..util.digest import digest_ints_to_bits, into_curve_from_bits, structure_digest_stream
from ..util.profiling import span
from ..util.ro import MAX_BITS, NUM_CHALLENGE_BITS, default_ro_spec
from .sangria_ivc import select_relaxed
from .step_circuit import StepCircuit
from .support_circuit import InstanceInput
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


def _cf_flatten(inp: CyclefoldStepInputs, sc=None) -> list[int]:
    """The SFC tape's inputs for `inp`, then the step circuit's dynamic
    witness (stateful step circuits only)."""
    out: list[int] = []

    def P(v):
        out.append(int(v))
        return v

    _cf_pack(inp, P)
    if sc is not None:
        out.extend(sc_dynamic_values(sc))
    return out


# -- public parameters -------------------------------------------------------------


class CyclefoldPublicParams:
    """Reference `ivc/cyclefold/.../public_params.rs` (the JAX package's
    simplified form): the support and primary structures, the pp digest and
    the two folding schemes' parameters."""

    @span("public_params")
    def __init__(self, step_circuit: StepCircuit, k: int, ck_primary, ck_support):
        self.sc = step_circuit
        self.k = k
        self.ck1 = ck_primary
        self.ck2 = ck_support
        self.f1 = bn256_fr
        self.f2 = bn256_fq
        self.S_support, self.support_taped = support_structure(SUPPORT_K)

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
        # the dry structure synthesis doubles as the SFC's witness trace
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
        named = {"x0": dry.x0_value, "x1": dry.x1_value}
        named.update({f"z{i}": v for i, v in enumerate(dry.z_next_values)})
        self.sfc_taped = TapedSynthesis(sfc_tape, runner._asn, named=named)

        bits = digest_ints_to_bits(structure_digest_stream(self.S_primary) + structure_digest_stream(self.S_support))
        self.digest = into_curve_from_bits(bn256_g1, bits)
        self.pg_pp = pg.ProverParam(self.S_primary, self.digest_coords())

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


# -- new / next / verify --------------------------------------------------------------


class CyclefoldIVC:
    """Reference `ivc/cyclefold/incrementally_verifiable_computation` (new /
    next / verify).  Tensors live on the primary key's device; under an
    active mesh that divides the rows, every W round as row blocks
    (`parallel/rows.py`), the support chain's W and E too."""

    @span("ivc_new")
    def __init__(self, pp: CyclefoldPublicParams, z_0: Sequence[int]):
        f1 = pp.f1
        self.pp = pp
        self.step = 1
        self.z_0 = [v % f1.modulus for v in z_0]
        # the initial PG accumulator from the all-zero dry trace
        dry_trace = PlonkTrace(pp._default_primary_incoming(),
                               PlonkWitness.zeros(pp.S_primary.field, pp.S_primary.round_sizes, pp.ck1.device,
                                                  n=pp.S_primary.n))
        self.self_acc = pg.ProtoGalaxy.new_accumulator(pp.pg_pp, _ro(), dry_trace, bn256_g1)
        self.support = SupportFoldChain(pp.ck2, pp.S_support, pp.support_taped, pp_digest=pp.digest)

        inputs = pp._dry_inputs()
        inputs.pp_digest = pp.digest_coords()
        inputs.z_0 = list(self.z_0)
        inputs.z_i = list(self.z_0)
        inputs.self_acc = pg.AccumulatorInstance.from_acc(self.self_acc)
        inputs.support_acc = self.support_acc.U
        W, z_out, x1 = self._sfc_witness(inputs, lambda z: cyclefold_marker(
            f1, pp.digest_coords(), 1, self.z_0, z, pg.AccumulatorInstance.from_acc(self.self_acc),
            self.support_acc.U))
        self.primary_trace = run_sps_protocol(pp.S_primary, pp.ck1, [[0, x1]], W, _ro())
        self.z_i = z_out

    # the support chain carries the Sangria accumulator and the public
    # instances of every support trace folded so far
    @property
    def support_acc(self) -> sg.RelaxedPlonkTrace:
        return self.support.acc

    @property
    def support_pub_instances(self) -> list:
        return self.support.pub_instances

    def _sfc_witness(self, inputs: CyclefoldStepInputs, marker_of_z):
        """(advice columns, z_next, x1) of the SFC for `inputs` by native
        replay of the pp's SFC tape, with the on- and off-circuit X1 checked
        equal.  A stateful step circuit first advances its host state (e.g.
        the Merkle tree) and its dynamic witness, and its replayed z_next is
        checked against the host's."""
        pp = self.pp
        q = pp.f1.modulus
        z_host = pp.sc.process_step(inputs.z_i, pp.k, pp.f1) if sc_is_stateful(pp.sc) else None
        W, named = pp.sfc_taped.replay(_cf_flatten(inputs, pp.sc))
        z_next = [named[f"z{i}"] for i in range(pp.sc.arity)]
        if z_host is not None and z_next != [v % q for v in z_host]:
            raise CyclefoldError("replayed z_next differs from the host's process_step")
        x1 = marker_of_z(z_next)
        if named["x1"] != x1:
            raise CyclefoldError("on- and off-circuit X1 markers differ (a stateful step circuit must implement "
                                 "dynamic_witness/bind_witness: ivc/step_circuit.py)")
        return W, z_next, x1

    def _sfc_witness_direct(self, inputs: CyclefoldStepInputs, x0: int, x1: int) -> list[list[int]]:
        """The replay's plain version: the SFC's advice columns for `inputs`
        by direct synthesis of the gadget stack (a stateful step circuit
        synthesizes the dynamic witness its last `process_step` bound)."""
        pp = self.pp
        sfc = CyclefoldSFC(pp.sc, inputs, pp.f1)
        W = CircuitRunner(pp.k, pp.f1, sfc, [[x0, x1]]).collect_witness()
        if sfc.x1_value != x1:
            raise CyclefoldError("on- and off-circuit X1 markers differ")
        return W

    def next(self):
        """One Cyclefold step (reference `next`, mod.rs:210-324), in a root
        span `next` that gives its spans the step number."""
        with span("next", step=self.step):
            pp = self.pp
            f1 = pp.f1
            q = f1.modulus
            prev_acc_ins = pg.AccumulatorInstance.from_acc(self.self_acc)
            prev_trace = self.primary_trace
            prev_support_U = self.support_acc.U

            with span("pg_prove"):
                new_acc, proof = pg.ProtoGalaxy.prove(pp.ck1, pp.pg_pp, _ro(), self.self_acc, [prev_trace])

            # re-derive gamma verifier-style to evaluate L0, L1
            ro2 = _ro()
            pp.pg_pp.absorb_into(ro2, q)
            prev_acc_ins.absorb_into(ro2, q)
            pg.absorb_instance(ro2, prev_trace.u, q)
            ro2.squeeze(MAX_BITS)  # delta
            for c in proof.poly_F.coeffs:
                ro2.absorb_field(c % q)
            ro2.squeeze(MAX_BITS)  # alpha
            for c in proof.poly_K.coeffs:
                ro2.absorb_field(c % q)
            gamma = ro2.squeeze(MAX_BITS) % q
            l0, l1 = list(lagrange.iter_eval_lagrange_poly_for_cyclic_group(f1, gamma, 1))[:2]

            # support-circuit delegation, one fold per W-commitment pair:
            # W_new[i] = l0 W_acc[i] + l1 W_inc[i], Sangria-chained
            support_incoming, support_cross = [], []
            with span("support_folds"):
                for i, (W_a, W_i) in enumerate(zip(prev_acc_ins.ins.W_commitments, prev_trace.u.W_commitments)):
                    sup_input = InstanceInput(W_a, W_i, l0, l1)
                    if sup_input.p_out() != new_acc.trace.u.W_commitments[i]:
                        raise CyclefoldError(f"support delegation #{i} disagrees with the PG-folded W commitment")
                    self.support.fold(sup_input)
                    support_incoming.append(self.support.incoming[-1])
                    support_cross.append(self.support.cross[-1])

            inputs = CyclefoldStepInputs(
                step=self.step,
                pp_digest=pp.digest_coords(),
                z_0=list(self.z_0),
                z_i=list(self.z_i),
                self_acc=prev_acc_ins,
                self_incoming=prev_trace.u,
                proof=proof,
                support_acc=prev_support_U,
                support_incoming=support_incoming,
                support_cross_commits=support_cross,
            )
            x0 = prev_trace.u.instances[0][1]
            with span("sfc_witness"):
                W, z_next, x1 = self._sfc_witness(inputs, lambda z: cyclefold_marker(
                    f1, pp.digest_coords(), self.step + 1, self.z_0, z, pg.AccumulatorInstance.from_acc(new_acc),
                    self.support_acc.U))
            with span("sps_primary"):
                self.primary_trace = run_sps_protocol(pp.S_primary, pp.ck1, [[x0, x1]], W, _ro())
            self.self_acc = new_acc
            self.z_i = z_next
            self.step += 1

    def checkpoint(self, path: str):
        """Write the whole IVC state to `path`.json / `path`.npz, keyed by the
        pp digest, in the JAX package's format (`util/checkpoint.py`)."""
        from ..util.checkpoint import save_cyclefold_state

        save_cyclefold_state(path, self, self.pp.digest_hex())

    @staticmethod
    def resume(pp: CyclefoldPublicParams, path: str) -> "CyclefoldIVC":
        """The IVC of a checkpoint on `pp`'s primary-key device; refuses a
        checkpoint of other public parameters (ValueError).  The support
        chain's `incoming` and `cross` lists are not checkpointed and restart
        empty: `next` needs only the entries it appends itself, while
        `self.support.verify()` replays only the folds made since the
        resume."""
        from ..util.checkpoint import load_cyclefold_state

        return load_cyclefold_state(path, pp, pp.digest_hex(), device=pp.ck1.device)

    def verify(self) -> list:
        """Marker replay and is_sat of both accumulators and the pending
        trace (reference `verify`, mod.rs:337-393)."""
        pp = self.pp
        f1 = pp.f1
        errors = []
        # the pending trace's X1 commits to the current accumulator state
        expected_x1 = cyclefold_marker(f1, pp.digest_coords(), self.step, self.z_0, self.z_i,
                                       pg.AccumulatorInstance.from_acc(self.self_acc), self.support_acc.U)
        if expected_x1 != self.primary_trace.u.instances[0][1] % f1.modulus:
            errors.append("marker X1 mismatch")
        with span("verify_pg_is_sat"):
            errors += [f"pg: {e}" for e in pg.ProtoGalaxy.is_sat(pp.ck1, pp.S_primary, self.self_acc,
                                                                  check_commit=False)]
        with span("verify_support_is_sat"):
            errors += [f"support: {e}" for e in self.support.is_sat()]
        with span("verify_primary_trace"):
            try:
                satisfy.is_sat(pp.S_primary, pp.ck1, _ro(), self.primary_trace.u, self.primary_trace.w,
                               check_commit=False)
            except satisfy.IsSatError as e:
                errors.append(f"primary trace: {e}")
        # one RLC MSM covers every primary-curve opening: the PG accumulator's
        # witness rounds and the pending trace's
        with span("verify_commitments"):
            pairs = (list(zip(self.self_acc.trace.w.W, self.self_acc.trace.u.W_commitments))
                     + list(zip(self.primary_trace.w.W, self.primary_trace.u.W_commitments)))
            bad = pp.ck1.batched_commit_check(pairs)
            if bad:
                errors.append(f"commitment mismatch (pair indices {bad})")
        return errors
