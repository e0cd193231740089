"""Sangria NIFS: Nova-style folding for relaxed PLONK.

Counterpart of `sirius_tpu/nifs/sangria.py`.  Cross terms come from
evaluating the homogeneous gate at X = 0..D on W1 + X*W2 and interpolating
with the inverse Vandermonde matrix; witness folds are device axpys;
commitment folds are host scalar muls; the transcript RO runs on the host
between the device phases.

Under row blocks (`parallel/rows.py`) W, E and the cross terms are row
blocks: the cross terms' evaluations and their Vandermonde combinations
run per block, both folds block by block with no copy between devices, and
only the cross terms' commitment gathers them to the key's device (as the
JAX package commits them there).  The accumulation check counts
mismatches per block; the permutation check gathers W0's advice columns to
the first device (the JAX package replicates them).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Sequence

import torch

from ..fields import gold
from ..fields.constants import CurveSpec
from ..ops.poseidon import PoseidonHash, poseidon_spec
from ..parallel.rows import blockwise, blocks_of, expanded, gathered, home, leading, place, row_mesh, zero_round
from ..plonk.eval import PlonkEvalDomain
from ..plonk.permutation import device_perm_mismatches, perm_index_vector
from ..plonk.satisfy import is_sat_log_derivative
from ..plonk.sps import run_sps_protocol, sps_verify
from ..plonk.structure import PlonkInstance, PlonkStructure, PlonkTrace, PlonkWitness
from ..util.profiling import span
from ..util.ro import DEFAULT_R_F, DEFAULT_R_P, DEFAULT_RATE, DEFAULT_T, NUM_CHALLENGE_BITS

CONSISTENCY_MARKERS_COUNT = 2


@lru_cache(maxsize=None)
def _vandermonde_inv(p: int, D: int) -> tuple[tuple[int, ...], ...]:
    """out[k][j] = coefficient of X^k in the Lagrange basis poly L_j(X) for
    the points x_j = j (j = 0..D) mod p."""
    rows = [[0] * (D + 1) for _ in range(D + 1)]
    for j in range(D + 1):
        coeffs, denom = [1], 1
        for i in range(D + 1):
            if i == j:
                continue
            denom = denom * (j - i) % p
            nxt = [0] * (len(coeffs) + 1)
            for d, c in enumerate(coeffs):
                nxt[d] = (nxt[d] - i * c) % p
                nxt[d + 1] = (nxt[d + 1] + c) % p
            coeffs = nxt
        dinv = pow(denom, -1, p)
        for k, c in enumerate(coeffs):
            rows[k][j] = c * dinv % p
    return tuple(tuple(r) for r in rows)


def fold_witness(f, weights: Sequence[int], Ws: Sequence[torch.Tensor]) -> torch.Tensor:
    """sum_j weights[j] * Ws[j] (the witness axpy of
    `sirius_tpu/nifs/protogalaxy.py:_fold_w_fn`); a vector of weight 1 is
    added without a product.  Block by block for row blocks."""
    return blockwise(lambda *ws: _axpy(f, weights, ws), *Ws)


def _axpy(f, weights: Sequence[int], Ws: Sequence[torch.Tensor]) -> torch.Tensor:
    """`fold_witness` on one device."""
    dev = Ws[0].device
    parts = [w for x, w in zip(weights, Ws) if x % f.p == 1]
    scaled = [(x % f.p, w) for x, w in zip(weights, Ws) if x % f.p != 1]
    if scaled:
        wts = f.encode([x for x, _ in scaled], dev)
        parts += list(f.mul(torch.stack([w for _, w in scaled]), wts[:, None, :]))
    return f.sum_reduce(torch.stack(parts))


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

    @staticmethod
    def from_instance(curve: CurveSpec, u: PlonkInstance,
                      markers_len: int = CONSISTENCY_MARKERS_COUNT) -> "RelaxedPlonkInstance":
        """The relaxation of a plain instance (u = 1, E the identity); the
        step-circuit instance columns seed the hash accumulator (reference
        `accumulator.rs:123-157`)."""
        if len(u.instances[0]) != markers_len:
            raise SangriaError("the first instance column must hold the consistency markers")
        sc = u.instances[1:]
        return RelaxedPlonkInstance(
            W_commitments=list(u.W_commitments),
            consistency_markers=list(u.instances[0]),
            challenges=list(u.challenges),
            E_commitment=gold.identity(curve),
            u=1,
            sc_instances_hash_acc=absorb_in_sc_instances_accumulator(curve, 0, sc) if sc else None,
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

    @staticmethod
    def from_regular(w: PlonkWitness, k: int, field) -> "RelaxedPlonkWitness":
        """W's rounds and E = 0 over 2^k rows, on W's device; under the row
        mesh of 2^k (`parallel/rows.row_mesh`) W and E as row blocks."""
        n = 1 << k
        if row_mesh(n) is None:
            return RelaxedPlonkWitness(list(w.W), field.zeros((n,), w.W[0].device))
        return RelaxedPlonkWitness([place(x, n) for x in w.W], zero_round(field, n, n, None))

    @staticmethod
    def zeros(field, round_sizes, n: int, device) -> "RelaxedPlonkWitness":
        """The zero accumulator's rounds and E over n rows on `device`, row
        blocks under the row mesh of n."""
        return RelaxedPlonkWitness([zero_round(field, sz, n, device) for sz in round_sizes],
                                   zero_round(field, n, n, device))

    def fold(self, f, W2: PlonkWitness, cross_terms: Sequence[torch.Tensor], r: int) -> "RelaxedPlonkWitness":
        """W += r W2; E += sum_k r^k T_k."""
        newW = [fold_witness(f, [1, r], [w1, w2]) for w1, w2 in zip(self.W, W2.W)]
        r_pows = [pow(r, k, f.p) for k in range(len(cross_terms) + 1)]
        newE = fold_witness(f, r_pows, [self.E, *cross_terms])
        return RelaxedPlonkWitness(newW, newE)


@dataclass
class RelaxedPlonkTrace:
    U: RelaxedPlonkInstance
    W: RelaxedPlonkWitness


@dataclass
class ProverParam:
    S: PlonkStructure
    pp_digest: tuple[int, int]


@dataclass
class VerifierParam:
    pp_digest: tuple[int, int]


class VanillaFS:
    """Sangria folding scheme; all methods static."""

    @staticmethod
    def setup_params(pp_digest_point, S: PlonkStructure):
        coords = (0, 0) if pp_digest_point.is_identity else (pp_digest_point.x, pp_digest_point.y)
        return ProverParam(S, coords), VerifierParam(coords)

    @staticmethod
    def generate_plonk_trace(ck, instances, witness, pp: ProverParam, ro_nark: PoseidonHash,
                             markers_len: int = CONSISTENCY_MARKERS_COUNT) -> PlonkTrace:
        """The SPS trace of a synthesized witness, whose first instance
        column must hold the consistency markers."""
        tr = run_sps_protocol(pp.S, ck, instances, witness, ro_nark)
        if len(tr.u.instances[0]) != markers_len:
            raise SangriaError("the first instance column must hold the consistency markers")
        return tr

    @staticmethod
    def commit_cross_terms(ck, S: PlonkStructure, U1: RelaxedPlonkInstance, W1: RelaxedPlonkWitness,
                           U2: PlonkInstance, W2: PlonkWitness):
        """Cross terms T_1..T_D of P_homo(acc + X inc): Q(X) evaluated at
        X = 0..D and interpolated (the coefficient vectors of Q are exactly
        the grouped terms)."""
        f = S.field
        p = f.p
        D = S.get_degree_for_folding() - 1
        if D < 1:
            return [], []
        expr = S.custom_gates_lookup_compressed.homogeneous
        ch1 = [*U1.challenges, U1.u]
        ch2 = [*U2.challenges, 1]
        if len(ch1) != len(ch2):
            raise SangriaError(f"challenge count mismatch: {len(ch1)} != {len(ch2)}")
        dev = home(W1.E)
        evals = []
        WX = list(W1.W)
        for X in range(D + 1):
            if X:  # W1 + X W2, one add a point
                WX = [blockwise(f.add, a, b) for a, b in zip(WX, W2.W)]
            chX = [f.encode((a + X * b) % p, dev) for a, b in zip(ch1, ch2)]
            evals.append(expanded(PlonkEvalDomain(S, chX, WX, []).evaluate([expr])[0], S.n))
        vinv = _vandermonde_inv(p, D)
        cross_terms = [fold_witness(f, vinv[k], evals) for k in range(1, D + 1)]
        return cross_terms, ck.commit_device_many(torch.stack([gathered(t, ck.device) for t in cross_terms]))

    @staticmethod
    def generate_challenge(pp_digest, ro_acc: PoseidonHash, U1: RelaxedPlonkInstance, U2: PlonkInstance,
                           cross_term_commits, base_modulus: int) -> int:
        """r = RO(pp || U1 || U2 || T-commits)."""
        ro_acc.absorb_field(pp_digest[0] % base_modulus)
        ro_acc.absorb_field(pp_digest[1] % base_modulus)
        U1.absorb_into(ro_acc, base_modulus)
        for c in U2.W_commitments:
            ro_acc.absorb_point(c)
        for inst in U2.instances:
            for v in inst:
                ro_acc.absorb_field(v % base_modulus)
        for ch in U2.challenges:
            ro_acc.absorb_field(ch % base_modulus)
        for c in cross_term_commits:
            ro_acc.absorb_point(c)
        return ro_acc.squeeze(NUM_CHALLENGE_BITS)

    @staticmethod
    def prove(ck, pp: ProverParam, ro_acc: PoseidonHash, accumulator: RelaxedPlonkTrace, incoming: PlonkTrace):
        """Fold one incoming trace into the accumulator."""
        curve = ck.curve.spec
        S = pp.S
        U1, W1 = accumulator.U, accumulator.W
        U2, W2 = incoming.u, incoming.w
        with span("sangria_cross_terms"):
            cross_terms, commits = VanillaFS.commit_cross_terms(ck, S, U1, W1, U2, W2)
        with span("sangria_challenge"):
            r = VanillaFS.generate_challenge(pp.pp_digest, ro_acc, U1, U2, commits, curve.base.modulus)
        with span("sangria_fold"):
            U = U1.fold(curve, U2, commits, r)
            W = W1.fold(S.field, W2, cross_terms, r)
        return RelaxedPlonkTrace(U, W), commits

    @staticmethod
    def verify(vp: VerifierParam, curve: CurveSpec, ro_nark: PoseidonHash, ro_acc: PoseidonHash,
               U1: RelaxedPlonkInstance, U2: PlonkInstance, cross_term_commits) -> RelaxedPlonkInstance:
        """Instance-side fold."""
        sps_verify(U2, ro_nark)
        r = VanillaFS.generate_challenge(vp.pp_digest, ro_acc, U1, U2, cross_term_commits, curve.base.modulus)
        return U1.fold(curve, U2, cross_term_commits, r)

    # -- satisfaction checks --------------------------------------------------------
    @staticmethod
    def is_sat_accumulation(S: PlonkStructure, acc: RelaxedPlonkTrace) -> None:
        f = S.field
        dev = home(acc.W.E)
        challenges = [f.encode(c % f.p, dev) for c in [*acc.U.challenges, acc.U.u]]
        out = PlonkEvalDomain(S, challenges, list(acc.W.W), []).evaluate(
            [S.custom_gates_lookup_compressed.homogeneous])[0]
        count = sum(int(m.sum()) for m in blocks_of(blockwise(lambda o, e: ~f.eq(o, e), out, acc.W.E)))
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
        mismatch = device_perm_mismatches(f, idx, head, leading(acc.W.W[0], S.num_advice_columns, n))
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
