"""ProtoGalaxy NIFS, the verifier's half: the accumulator, its transcript
absorption, and its satisfaction checks (e against the pow-weighted gate
sum, the permutation).

Counterpart of `sirius_tpu/nifs/protogalaxy.py` (reference
`src/nifs/protogalaxy/`): e is evaluated as the reference's weighted
binary-tree reduce of every gate over every row, gate-major, zero-padded to
`count_of_evaluation_with_padding` leaves, on (n, 8) Montgomery word
tensors.  The prover (F, G, K, the fold) is left out.

The reference's leaf indexer collapses every leaf to row 0 (`plonk/mod.rs:714`,
`index & total_row`); like the JAX package this uses `index % total_row`
(PARITY.md).  The permutation index of `is_sat` lives in the structure's
own cache.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from ..fields.jfield import WORDS, Field
from ..ops.poseidon import PoseidonHash
from ..plonk.eval import PlonkEvalDomain
from ..plonk.permutation import device_perm_mismatches, perm_index_vector
from ..plonk.structure import PlonkInstance, PlonkStructure, PlonkTrace
from ..poly.univariate import UnivariatePoly

# commitment-coordinate decompositions: the 32 x 10 geometry of the JAX
# package (the reference uses 64 x 20; PARITY.md)
DEFAULT_LIMB_WIDTH = 32
DEFAULT_LIMBS_COUNT = 10


class VerifyError(Exception):
    pass


def biguint_limbs(x: int, width: int = DEFAULT_LIMB_WIDTH, count: int = DEFAULT_LIMBS_COUNT) -> list[int]:
    """Little-endian fixed-width limb decomposition (reference `BigUintPoint`)."""
    mask = (1 << width) - 1
    return [(x >> (i * width)) & mask for i in range(count)]


def absorb_point_limbs(ro: PoseidonHash, pt, scalar_modulus: int):
    """Absorb a commitment as limb decompositions of its affine coordinates
    (identity -> (0, 0))."""
    x, y = (0, 0) if pt.is_identity else (pt.x, pt.y)
    for v in biguint_limbs(x) + biguint_limbs(y):
        ro.absorb_field(v % scalar_modulus)


def absorb_instance(ro: PoseidonHash, u: PlonkInstance, q: int):
    for c in u.W_commitments:
        absorb_point_limbs(ro, c, q)
    for inst in u.instances:
        for v in inst:
            ro.absorb_field(v % q)
    for ch in u.challenges:
        ro.absorb_field(ch % q)


@dataclass
class Accumulator:
    """Reference `accumulator.rs:16-57`."""

    trace: PlonkTrace
    betas: list[int]
    e: int


@dataclass
class AccumulatorInstance:
    ins: PlonkInstance
    betas: list[int]
    e: int

    @staticmethod
    def from_acc(acc: Accumulator) -> "AccumulatorInstance":
        return AccumulatorInstance(acc.trace.u.clone(), list(acc.betas), acc.e)

    def absorb_into(self, ro: PoseidonHash, q: int):
        """W limbs, instances, challenges, betas, e (reference
        `accumulator.rs:100-129`)."""
        absorb_instance(ro, self.ins, q)
        for b in self.betas:
            ro.absorb_field(b % q)
        ro.absorb_field(self.e % q)


@dataclass
class Proof:
    poly_F: UnivariatePoly
    poly_K: UnivariatePoly


# -- sizes (reference `poly/mod.rs:205-269,511-545`) -----------------------------


def _next_pow2(x: int) -> int:
    return 1 << max((x - 1).bit_length(), 0) if x > 1 else 1


def count_of_evaluation(S: PlonkStructure) -> int:
    return S.n * len(S.gates)


def count_of_evaluation_with_padding(S: PlonkStructure) -> int:
    return _next_pow2(count_of_evaluation(S))


# -- the gate sweep and the pow-weighted reduce ------------------------------------


def gate_leaves(S: PlonkStructure, challenges: Sequence[torch.Tensor], W: Sequence[torch.Tensor]) -> torch.Tensor:
    """Every gate over every row, gate-major ([gate0 rows | gate1 rows | ..]),
    zero-padded to `count_of_evaluation_with_padding(S)` leaves: (N, 8)."""
    dev = W[0].device
    outs = PlonkEvalDomain(S, list(challenges), list(W), []).evaluate(list(S.gates))
    flat = [o.expand(S.n, WORDS) for o in outs]
    pad = count_of_evaluation_with_padding(S) - count_of_evaluation(S)
    if pad:
        flat.append(S.field.zeros((pad,), dev))
    return torch.cat(flat)


def pow_poly_coeffs(f: Field, leaves: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """sum_i pow_i(betas) leaves[i] for N = 2^m leaves, (1, 8): level h joins
    sibling nodes as left + beta_h right.  Field sums do not depend on the
    order, so this is the reference's weighted binary-tree reduce, word for
    word."""
    P = leaves[:, None, :]
    for h in range(leaves.shape[0].bit_length() - 1):
        P = f.add(P[0::2], f.mul(P[1::2], betas[h]))
    return P[0]


def _weights(f: Field, weight_ints: Sequence[Sequence[int]], device) -> torch.Tensor:
    """(t, m) host ints -> (t, m, 8) Montgomery words in one encode."""
    t, m = len(weight_ints), len(weight_ints[0])
    return f.encode([w % f.p for row in weight_ints for w in row], device).reshape(t, m, WORDS)


def _challenges(f: Field, values: Sequence[int], device) -> list[torch.Tensor]:
    return [f.encode(c % f.p, device) for c in values]


def evaluate_e_from_trace(S: PlonkStructure, trace: PlonkTrace, betas: Sequence[int]) -> int:
    """Reference `evaluate_e_from_trace` (`nifs/protogalaxy/mod.rs:571-640`)."""
    if count_of_evaluation(S) == 0:
        return 0
    f = S.field
    dev = trace.w.W[0].device
    leaves = gate_leaves(S, _challenges(f, trace.u.challenges, dev), trace.w.W)
    return f.decode_one(pow_poly_coeffs(f, leaves, _weights(f, [list(betas)], dev)[0]))


class ProtoGalaxy:
    """The scheme's checks; all methods static."""

    # -- satisfaction (reference `nifs/protogalaxy/mod.rs:642-745`) --------------------
    @staticmethod
    def is_sat_accumulation(S: PlonkStructure, acc: Accumulator) -> None:
        evaluated = evaluate_e_from_trace(S, acc.trace, acc.betas)
        if evaluated != acc.e % S.spec.modulus:
            raise VerifyError(f"e mismatch: {hex(acc.e)} vs evaluated {hex(evaluated)}")

    @staticmethod
    def is_sat_permutation(S: PlonkStructure, acc: Accumulator) -> None:
        """P @ Z == Z over Z = [instances | advice] (the whole permutation)."""
        head = [v for inst in acc.trace.u.instances for v in inst]
        total = len(head) + S.n * S.num_advice_columns
        key = ("perm_full", total)
        idx = S.cache.get(key)
        if idx is None:
            idx = S.cache[key] = perm_index_vector(S.permutation_matrix(), total)
        mism = device_perm_mismatches(S.field, idx, head, acc.trace.w.W[0][: S.num_advice_columns * S.n])
        if mism:
            raise VerifyError(f"permutation mismatch on {mism} entries")

    @staticmethod
    def is_sat_witness_commit(ck, acc: Accumulator) -> None:
        pairs = list(zip(acc.trace.w.W, acc.trace.u.W_commitments))
        bad = ck.batched_commit_check(pairs)
        if bad:
            raise VerifyError(f"witness commitment mismatch rounds {bad}")

    @staticmethod
    def is_sat(ck, S: PlonkStructure, acc: Accumulator, check_commit: bool = True) -> list:
        checks = [
            ("pg_is_sat_accumulation", lambda: ProtoGalaxy.is_sat_accumulation(S, acc)),
            ("pg_is_sat_permutation", lambda: ProtoGalaxy.is_sat_permutation(S, acc)),
        ]
        if check_commit:
            checks.append(("pg_is_sat_witness_commit", lambda: ProtoGalaxy.is_sat_witness_commit(ck, acc)))
        errors = []
        for name, check in checks:
            try:
                check()
            except VerifyError as e:
                errors.append(e)
        return errors
