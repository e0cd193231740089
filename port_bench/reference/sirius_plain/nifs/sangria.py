"""Sangria NIFS, the verifier's half: the relaxed PLONK instance and its
satisfaction checks (the homogeneous gate against E, the log-derivative
sums, the permutation with the step-circuit instance columns cut out, the
commitment openings, the step-circuit instances' hash chain).

Counterpart of `sirius_tpu/nifs/sangria.py`.  The prover (cross terms, the
folds) is left out.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from ..fields import gold
from ..fields.constants import CurveSpec
from ..ops.poseidon import PoseidonHash, poseidon_spec
from ..plonk.eval import PlonkEvalDomain
from ..plonk.permutation import device_perm_mismatches, perm_index_vector
from ..plonk.satisfy import is_sat_log_derivative
from ..plonk.structure import PlonkInstance, PlonkStructure, PlonkWitness
from ..util.ro import DEFAULT_R_F, DEFAULT_R_P, DEFAULT_RATE, DEFAULT_T

CONSISTENCY_MARKERS_COUNT = 2


class SangriaError(Exception):
    pass


class VerifyError(Exception):
    pass


def absorb_in_sc_instances_accumulator(curve: CurveSpec, acc: int, instances: Sequence[Sequence[int]]) -> int:
    """acc' = Poseidon_base(acc, instances...) cast back to the scalar field."""
    base, scalar = curve.base, curve.scalar
    ro = PoseidonHash(poseidon_spec(base, DEFAULT_T, DEFAULT_RATE, DEFAULT_R_F, DEFAULT_R_P))
    ro.absorb_field(acc % base.modulus)
    for inst in instances:
        for v in inst:
            ro.absorb_field(v % base.modulus)
    return ro.squeeze(base.num_bits) % scalar.modulus


def get_initial_sc_instances_accumulator(curve: CurveSpec) -> int:
    return 0


@dataclass
class RelaxedPlonkInstance:
    W_commitments: list  # gold.AffinePoint
    consistency_markers: list[int]
    challenges: list[int]
    E_commitment: object  # gold.AffinePoint
    u: int
    sc_instances_hash_acc: Optional[int]

    @staticmethod
    def new(curve: CurveSpec, num_challenges: int, num_witness: int, num_sc_instances: int,
            markers_len: int = CONSISTENCY_MARKERS_COUNT) -> "RelaxedPlonkInstance":
        """The trivially satisfied relaxed instance (u = 0)."""
        return RelaxedPlonkInstance(
            W_commitments=[gold.identity(curve)] * num_witness,
            consistency_markers=[0] * markers_len,
            challenges=[0] * num_challenges,
            E_commitment=gold.identity(curve),
            u=0,
            sc_instances_hash_acc=None if num_sc_instances == 0 else get_initial_sc_instances_accumulator(curve),
        )


    def clone(self) -> "RelaxedPlonkInstance":
        return RelaxedPlonkInstance(list(self.W_commitments), list(self.consistency_markers), list(self.challenges),
                                    self.E_commitment, self.u, self.sc_instances_hash_acc)

    def fold(self, curve: CurveSpec, U2: PlonkInstance, cross_term_commits: Sequence, r: int) -> "RelaxedPlonkInstance":
        q = curve.scalar.modulus
        W = [w1.add(w2.mul(r)) for w1, w2 in zip(self.W_commitments, U2.W_commitments)]
        markers = [(a + r * b) % q for a, b in zip(self.consistency_markers, U2.instances[0])]
        challenges = [(a + r * b) % q for a, b in zip(self.challenges, U2.challenges)]
        comm_E, r_pow = self.E_commitment, r
        for tk in cross_term_commits:
            comm_E = comm_E.add(tk.mul(r_pow))
            r_pow = r_pow * r % q
        sc_acc = self.sc_instances_hash_acc
        if sc_acc is not None:
            sc_acc = absorb_in_sc_instances_accumulator(curve, sc_acc, U2.instances[1:])
        return RelaxedPlonkInstance(W, markers, challenges, comm_E, (self.u + r) % q, sc_acc)

    def absorb_into(self, ro: PoseidonHash, base_modulus: int):
        """W commitments, [markers | challenges | u] cast to base, E
        commitment, sc-hash-acc (zero when None)."""
        for c in self.W_commitments:
            ro.absorb_point(c)
        for v in [*self.consistency_markers, *self.challenges, self.u]:
            ro.absorb_field(v % base_modulus)
        ro.absorb_point(self.E_commitment)
        ro.absorb_field(0 if self.sc_instances_hash_acc is None else self.sc_instances_hash_acc % base_modulus)


@dataclass
class RelaxedPlonkWitness:
    """W rounds + error vector E, (size, 8) Montgomery tensors."""

    W: list[torch.Tensor]
    E: torch.Tensor


@dataclass
class RelaxedPlonkTrace:
    U: RelaxedPlonkInstance
    W: RelaxedPlonkWitness


class VanillaFS:
    """Sangria's satisfaction checks; all methods static."""

    # -- satisfaction checks --------------------------------------------------------
    @staticmethod
    def is_sat_accumulation(S: PlonkStructure, acc: RelaxedPlonkTrace) -> None:
        f = S.field
        dev = acc.W.E.device
        challenges = [f.encode(c % f.p, dev) for c in [*acc.U.challenges, acc.U.u]]
        out = PlonkEvalDomain(S, challenges, list(acc.W.W), []).evaluate(
            [S.custom_gates_lookup_compressed.homogeneous])[0]
        count = int((~f.eq(out, acc.W.E)).sum())
        if count:
            raise VerifyError(f"accumulation gate mismatch on {count}/{S.n} rows")
        if not is_sat_log_derivative(S, PlonkWitness(acc.W.W)):
            raise VerifyError("log derivative not satisfied")

    @staticmethod
    def is_sat_permutation(S: PlonkStructure, acc: RelaxedPlonkTrace) -> None:
        """P' @ Z == Z with the step-circuit instance columns cut out."""
        f = S.field
        n = S.n
        PAD = 0xFFFFFFF
        head = list(acc.U.consistency_markers)
        for io_len in S.num_io[1:]:
            head.extend([PAD] * io_len)
        total = len(head) + n * S.num_advice_columns
        key = ("perm_cut", total)
        idx = S.cache.get(key)
        if idx is None:
            cut = S.permutation_data.rm_copy_constraints(range(1, len(S.num_io)))
            idx = perm_index_vector(cut.matrix(S.k, S.num_io, S.num_advice_columns), total)
            S.cache[key] = idx
        mismatch = device_perm_mismatches(f, idx, head, acc.W.W[0][: S.num_advice_columns * n])
        if mismatch:
            raise VerifyError(f"permutation mismatch on {mismatch} entries")

    @staticmethod
    def is_sat_witness_commit(ck, acc: RelaxedPlonkTrace) -> None:
        pairs = list(zip(acc.W.W, acc.U.W_commitments)) + [(acc.W.E, acc.U.E_commitment)]
        bad = ck.batched_commit_check(pairs)
        if bad:
            last = len(pairs) - 1
            names = ["E" if i == last else f"round {i}" for i in bad]
            raise VerifyError(f"witness commitment mismatch: {', '.join(names)}")

    @staticmethod
    def is_sat_pub_instances(curve: CurveSpec, acc: RelaxedPlonkTrace, all_instances) -> None:
        """Replay the hash chain over every folded trace's step-circuit instances."""
        if acc.U.sc_instances_hash_acc is None:
            return
        h = get_initial_sc_instances_accumulator(curve)
        for instances in all_instances:
            h = absorb_in_sc_instances_accumulator(curve, h, instances[1:])
        if h != acc.U.sc_instances_hash_acc:
            raise VerifyError("step-circuit instances hash mismatch")

    @staticmethod
    def is_sat(ck, S: PlonkStructure, acc: RelaxedPlonkTrace, all_instances) -> list:
        errors = []
        for check in (
            lambda: VanillaFS.is_sat_accumulation(S, acc),
            lambda: VanillaFS.is_sat_permutation(S, acc),
            lambda: VanillaFS.is_sat_witness_commit(ck, acc),
            lambda: VanillaFS.is_sat_pub_instances(ck.curve.spec, acc, all_instances),
        ):
            try:
                check()
            except VerifyError as e:
                errors.append(e)
        return errors
