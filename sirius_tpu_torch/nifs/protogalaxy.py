"""ProtoGalaxy NIFS: multi-instance folding with F/G/K polynomials.

Counterpart of `sirius_tpu/nifs/protogalaxy.py` (reference
`src/nifs/protogalaxy/`), bit for bit: the same transcript (commitments
absorbed as 32 x 10-bit-limb decompositions of their coordinates, F's and
K's coefficients before alpha and gamma), the same leaf order and the same
accumulators.

Device work runs as the port's field ops on (n, 8) Montgomery word tensors,
element-major (the JAX package's limb-first layout was for the TPU's lanes):
- the gate-leaf sweep: every gate of the structure over every row,
  gate-major, zero-padded to `count_of_evaluation_with_padding` leaves;
- the pow-weighted reduce sum_i pow_i(w) leaf_i as a binary tree, and F's
  coefficients by the same tree over polynomials in X (`pow_poly_coeffs`):
  the JAX package evaluates F at t points and interpolates on the host, the
  same coefficients (F's degree is below t) for ~4 products a leaf instead
  of t;
- the witness fold sum_j L_j w_j, as w_0 + sum_{j>0} L_j (w_j - w_0).
The K interpolation runs on the host (`gold.coset_ifft`), as in the JAX
package.

Under row blocks (`parallel/rows.py`, D blocks of n / D rows) the leaves of
gate g on block d are leaves [g n + d n / D, g n + (d + 1) n / D): an
aligned subtree of height log2(n / D).  Each block reduces its subtrees
with the first log2(n / D) betas and deltas, the (gates x D) partial
polynomials go to the mesh's first device in leaf order, followed by the
all-zero subtrees of the padding, and the upper levels finish there
(`gate_pow_coeffs`): the same tree, so the same coefficients word for
word.  The witness folds run block by block.

The reference's leaf indexer collapses every leaf to row 0 (`plonk/mod.rs:714`,
`index & total_row`); like the JAX package this uses `index % total_row`
(PARITY.md).  Nothing here is cached across structures: the permutation
index of `is_sat` lives in the structure's own cache.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from ..fields import gold
from ..fields.constants import CurveSpec
from ..fields.jfield import WORDS, Field
from ..ops.poseidon import PoseidonHash
from ..parallel.rows import RowBlocks, blockwise, home, leading
from ..plonk.eval import PlonkEvalDomain
from ..plonk.permutation import device_perm_mismatches, perm_index_vector
from ..plonk.sps import sps_verify
from ..plonk.structure import PlonkInstance, PlonkStructure, PlonkTrace, PlonkWitness
from ..poly import lagrange
from ..poly.univariate import UnivariatePoly
from ..util.profiling import span
from ..util.ro import MAX_BITS

# commitment-coordinate decompositions: the 32 x 10 geometry of the JAX
# package (the reference uses 64 x 20; PARITY.md)
DEFAULT_LIMB_WIDTH = 32
DEFAULT_LIMBS_COUNT = 10


class ProtoGalaxyError(Exception):
    pass


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


@dataclass
class ProverParam:
    S: PlonkStructure
    pp_digest: tuple[int, int]

    def absorb_into(self, ro: PoseidonHash, q: int):
        ro.absorb_field(self.pp_digest[0] % q)
        ro.absorb_field(self.pp_digest[1] % q)


# -- sizes (reference `poly/mod.rs:205-269,511-545`) -----------------------------


def _next_pow2(x: int) -> int:
    return 1 << max((x - 1).bit_length(), 0) if x > 1 else 1


def count_of_evaluation(S: PlonkStructure) -> int:
    return S.n * len(S.gates)


def count_of_evaluation_with_padding(S: PlonkStructure) -> int:
    return _next_pow2(count_of_evaluation(S))


@dataclass
class PolyContext:
    S: PlonkStructure
    L: int  # number of incoming traces

    @property
    def instances_to_fold(self) -> int:
        n = self.L + 1
        if n & (n - 1):
            raise ProtoGalaxyError(f"L + 1 = {n} must be a power of two")
        return n

    @property
    def count_padded(self) -> int:
        return count_of_evaluation_with_padding(self.S)

    @property
    def betas_count(self) -> int:
        return self.count_padded.bit_length() - 1

    @property
    def fft_points_count_F(self) -> int:
        return _next_pow2(self.betas_count + 1)

    @property
    def max_gate_degree(self) -> int:
        ctx = self.S.query_index_ctx
        return max((g.degree(ctx) for g in self.S.gates), default=0)

    @property
    def fft_points_count_G(self) -> int:
        return _next_pow2(self.L * self.max_gate_degree + 1)

    @property
    def lagrange_domain(self) -> int:
        return self.instances_to_fold.bit_length() - 1

    @property
    def fft_log_domain_size_K(self) -> int:
        # as the reference (`poly/mod.rs:263-268`): next_power_of_two of the
        # point count used as the log itself (an oversized, harmless domain)
        return _next_pow2(max(self.fft_points_count_G + 1 - self.instances_to_fold, 1))


# -- device sweeps and reduces ---------------------------------------------------


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


def pow_poly_coeffs(f: Field, leaves: torch.Tensor, betas: torch.Tensor,
                    deltas: torch.Tensor | None = None, level0: int = 0, levels: int | None = None) -> torch.Tensor:
    """The coefficients of sum_i prod_h (betas[h] + X deltas[h])^bit_h(i)
    leaves[i] in X, low first: (m + 1, 8) for N = 2^m leaves; without deltas
    the one value sum_i pow_i(betas) leaves[i], (1, 8).  Level h joins
    sibling nodes (polynomials of degree h) as left + (beta_h + X delta_h)
    right: two products a coefficient of the right node, ~4 a leaf in all
    (one a leaf without deltas).  Field sums do not depend on the order, so
    this is the reference's weighted binary-tree reduce, word for word.

    `leaves` may instead be the N nodes of level `level0`, (N, h0 + 1, 8)
    polynomials (one coefficient without deltas), which the tree then joins
    from level h0 on; `levels` stops it after that many levels and returns
    the (N / 2^levels, ., 8) nodes reached."""
    P = leaves[:, None, :] if leaves.dim() == 2 else leaves  # (N, 1, 8): one constant polynomial a leaf
    top = leaves.shape[0].bit_length() - 1 if levels is None else levels
    for h in range(level0, level0 + top):
        left, right = P[0::2], P[1::2]
        if deltas is None:
            P = f.add(left, f.mul(right, betas[h]))
            continue
        zero = f.zeros((left.shape[0], 1), leaves.device)
        scaled = f.add(torch.cat([f.mul(right, betas[h]), zero], 1), torch.cat([zero, f.mul(right, deltas[h])], 1))
        P = f.add(torch.cat([left, zero], 1), scaled)
    return P[0] if levels is None else P


def gate_pow_coeffs(S: PlonkStructure, challenges: Sequence[torch.Tensor], W: Sequence,
                    betas: torch.Tensor, deltas: torch.Tensor | None = None) -> torch.Tensor:
    """`pow_poly_coeffs` of `gate_leaves(S, challenges, W)` on the first
    device.  Under row blocks each block reduces its aligned subtrees of
    height h0 = log2(n / D) on its device with the first h0 betas (and
    deltas); the (gates x D) partial polynomials are gathered in leaf order
    (leaf g n + r: gate g, block r // (n / D)), the padding's subtrees
    follow as zeros, and the tree finishes from level h0 (the module
    docstring)."""
    f = S.field
    if not isinstance(W[0], RowBlocks):
        return pow_poly_coeffs(f, gate_leaves(S, challenges, W), betas, deltas)
    mesh = W[0].mesh
    nb = S.n // mesh.size
    h0 = nb.bit_length() - 1
    outs = PlonkEvalDomain(S, list(challenges), list(W), []).evaluate(list(S.gates))
    parts = []
    for d, dev in enumerate(mesh.devices):
        leaves = torch.cat([o.blocks[d] for o in outs])  # gate-major: (gates x n / D, 8)
        parts.append(pow_poly_coeffs(f, leaves, betas[:h0].to(dev), None if deltas is None else deltas[:h0].to(dev),
                                     levels=h0).to(mesh.first))
    nodes = torch.stack(parts, 1).reshape(len(S.gates) * mesh.size, -1, WORDS)
    pad = count_of_evaluation_with_padding(S) // nb - nodes.shape[0]
    if pad:
        nodes = torch.cat([nodes, f.zeros((pad, nodes.shape[1]), mesh.first)])
    return pow_poly_coeffs(f, nodes, betas, deltas, level0=h0)


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
    dev = home(trace.w.W[0])
    return f.decode_one(gate_pow_coeffs(S, _challenges(f, trace.u.challenges, dev), trace.w.W,
                                        _weights(f, [list(betas)], dev)[0]))


def compute_F(ctx: PolyContext, betas: Sequence[int], delta: int, trace: PlonkTrace) -> UnivariatePoly:
    """F(X) = sum_i pow_i(beta + X * delta_sq) f_i (reference `poly/mod.rs:68-203`;
    edge weight at level h: beta[h] + X * delta^(2^h)), as its
    t = fft_points_count_F coefficients: the m + 1 of `pow_poly_coeffs` and
    zeros, the coefficients the reference interpolates from t points."""
    S = ctx.S
    spec = S.spec
    p = spec.modulus
    if count_of_evaluation(S) == 0:
        return UnivariatePoly(spec, [])
    f = S.field
    dev = home(trace.w.W[0])
    t = ctx.fft_points_count_F
    m = ctx.betas_count
    deltas, d = [], delta % p
    for _ in range(m):
        deltas.append(d)
        d = d * d % p
    w = _weights(f, [list(betas[:m]), deltas], dev)
    coeffs = f.decode(gate_pow_coeffs(S, _challenges(f, trace.u.challenges, dev), trace.w.W, w[0], w[1]))
    return UnivariatePoly(spec, coeffs + [0] * (t - len(coeffs)))


def fold_witness(f: Field, witnesses: Sequence[PlonkWitness], ls: Sequence[int]) -> PlonkWitness:
    """sum_j ls[j] w_j, round by round, for Lagrange values ls (they sum to
    1): w_0 + sum_{j>0} ls[j] (w_j - w_0), one product per incoming witness
    and none where ls[j] is 0 or 1; block by block for row blocks."""
    if sum(ls) % f.p != 1:
        raise ProtoGalaxyError("fold weights must be Lagrange values, summing to 1")
    return PlonkWitness([blockwise(lambda *rs: _fold_round(f, rs, ls), *rnds)
                         for rnds in zip(*(wit.W for wit in witnesses))])


def _fold_round(f: Field, rounds: Sequence[torch.Tensor], ls: Sequence[int]) -> torch.Tensor:
    """`fold_witness` of one round on one device."""
    out = rounds[0]
    for l, w in zip(ls[1:], rounds[1:]):
        l %= f.p
        if l:
            dr = f.sub(w, rounds[0])
            out = f.add(out, dr if l == 1 else f.mul(dr, f.encode(l, dr.device)))
    return out


def compute_G(ctx: PolyContext, betas_stroke: Sequence[int], accumulator: PlonkTrace,
              traces: Sequence[PlonkTrace]) -> UnivariatePoly:
    """G(X) = sum_i pow_i(beta') f_i(sum_j L_j(X) w_j) (reference
    `poly/mod.rs:308-425`): per point X of the size-fft_points_count_G
    subgroup one witness fold, one leaf sweep and one reduce; peak memory is
    one point's folded witness."""
    S = ctx.S
    spec = S.spec
    p = spec.modulus
    f = S.field
    dev = home(accumulator.w.W[0])
    weights = _weights(f, [list(betas_stroke)], dev)[0]
    all_traces = [accumulator, *traces]
    pts = []
    for X in lagrange.iter_cyclic_subgroup(spec, ctx.fft_points_count_G.bit_length() - 1):
        ls = list(lagrange.iter_eval_lagrange_poly_for_cyclic_group(spec, X, ctx.lagrange_domain))
        ch = [
            sum(l * (t.u.challenges[ci] if ci < len(t.u.challenges) else 0) for l, t in zip(ls, all_traces)) % p
            for ci in range(S.num_challenges)
        ]
        folded = fold_witness(f, [t.w for t in all_traces], ls)
        pts.append(gate_pow_coeffs(S, _challenges(f, ch, dev), folded.W, weights)[0])
    points = f.decode(torch.stack(pts))
    return UnivariatePoly(spec, gold.fft(points, spec, inverse=True))


def compute_K(ctx: PolyContext, poly_F_in_alpha: int, betas_stroke: Sequence[int], accumulator: PlonkTrace,
              traces: Sequence[PlonkTrace]) -> UnivariatePoly:
    """K from G on a zeta coset (reference `poly/mod.rs:464-509`)."""
    spec = ctx.S.spec
    p = spec.modulus
    poly_G = compute_G(ctx, betas_stroke, accumulator, traces)
    values = []
    for Xi in lagrange.iter_cyclic_subgroup(spec, ctx.fft_log_domain_size_K):
        X = spec.zeta * Xi % p
        l0_x = next(iter(lagrange.iter_eval_lagrange_poly_for_cyclic_group(spec, X, ctx.lagrange_domain)))
        z_x = lagrange.eval_vanish_polynomial(spec, ctx.lagrange_domain, X)
        values.append((poly_G.eval(X) - poly_F_in_alpha * l0_x) * pow(z_x, -1, p) % p)
    return UnivariatePoly(spec, gold.coset_ifft(values, spec))


def calculate_e(poly_F: UnivariatePoly, poly_K: UnivariatePoly, gamma: int, alpha: int, log_n: int) -> int:
    """e' = F(alpha) L_0(gamma) + Z(gamma) K(gamma) (reference
    `nifs/protogalaxy/mod.rs:748-764`)."""
    spec = poly_F.spec
    l0 = next(iter(lagrange.iter_eval_lagrange_poly_for_cyclic_group(spec, gamma, log_n)))
    return (poly_F.eval(alpha) * l0
            + lagrange.eval_vanish_polynomial(spec, log_n, gamma) * poly_K.eval(gamma)) % spec.modulus


def betas_stroke_of(betas: Sequence[int], alpha: int, delta: int, p: int) -> list[int]:
    """beta'[i] = beta[i] + alpha * delta^(2^i) (reference `iter_beta_stroke`)."""
    out, d = [], delta % p
    for b in betas:
        out.append((b + alpha * d) % p)
        d = d * d % p
    return out


class ProtoGalaxy:
    """The scheme; all methods static."""

    @staticmethod
    def setup_params(pp_digest_point, S: PlonkStructure):
        coords = (0, 0) if pp_digest_point.is_identity else (pp_digest_point.x, pp_digest_point.y)
        return ProverParam(S, coords), ProverParam(S, coords)

    @staticmethod
    def _delta(pp, ro_acc: PoseidonHash, acc_ins: AccumulatorInstance, instances, q: int) -> int:
        pp.absorb_into(ro_acc, q)
        acc_ins.absorb_into(ro_acc, q)
        for u in instances:
            absorb_instance(ro_acc, u, q)
        return ro_acc.squeeze(MAX_BITS) % q

    @staticmethod
    def new_accumulator(pp: ProverParam, ro_acc: PoseidonHash, plonk_trace: PlonkTrace,
                        curve: CurveSpec) -> Accumulator:
        """Reference `new_accumulator` (`nifs/protogalaxy/mod.rs:144-174`):
        beta from the transcript over the all-zero accumulator instance,
        betas[i] = beta * 2^i, e from the trace."""
        S = pp.S
        q = S.spec.modulus
        zero = AccumulatorInstance(
            PlonkInstance([gold.identity(curve)] * len(S.round_sizes), [[0] * io for io in S.num_io],
                          [0] * S.num_challenges),
            [0] * (count_of_evaluation_with_padding(S).bit_length() - 1),
            0,
        )
        b = ProtoGalaxy._delta(pp, ro_acc, zero, [], q)
        betas = []
        for _ in zero.betas:
            betas.append(b)
            b = b * 2 % q
        return Accumulator(plonk_trace, betas, evaluate_e_from_trace(S, plonk_trace, betas))

    @staticmethod
    def fold_instance(acc_u: PlonkInstance, incoming: Sequence[PlonkInstance], ls: Sequence[int],
                      q: int) -> PlonkInstance:
        l0 = ls[0]
        W = [w.mul(l0) for w in acc_u.W_commitments]
        instances = [[v * l0 % q for v in inst] for inst in acc_u.instances]
        challenges = [c * l0 % q for c in acc_u.challenges]
        for u, l in zip(incoming, ls[1:]):
            W = [a.add(b.mul(l)) for a, b in zip(W, u.W_commitments)]
            instances = [[(av + l * bv) % q for av, bv in zip(ai, bi)] for ai, bi in zip(instances, u.instances)]
            challenges = [(a + l * b) % q for a, b in zip(challenges, u.challenges)]
        return PlonkInstance(W, instances, challenges)

    @staticmethod
    def prove(ck, pp: ProverParam, ro_acc: PoseidonHash, accumulator: Accumulator,
              incoming: Sequence[PlonkTrace]) -> tuple[Accumulator, Proof]:
        """Reference `prove` (`nifs/protogalaxy/mod.rs:400-481`)."""
        S = pp.S
        q = S.spec.modulus
        L = len(incoming)
        ctx = PolyContext(S, L)
        delta = ProtoGalaxy._delta(pp, ro_acc, AccumulatorInstance.from_acc(accumulator),
                                   [t.u for t in incoming], q)
        with span("compute_F"):
            poly_F = compute_F(ctx, accumulator.betas, delta, accumulator.trace)
        for c in poly_F.coeffs:
            ro_acc.absorb_field(c % q)
        alpha = ro_acc.squeeze(MAX_BITS) % q

        b_stroke = betas_stroke_of(accumulator.betas, alpha, delta, q)
        with span("compute_K"):
            poly_K = compute_K(ctx, poly_F.eval(alpha), b_stroke, accumulator.trace, incoming)
        for c in poly_K.coeffs:
            ro_acc.absorb_field(c % q)
        gamma = ro_acc.squeeze(MAX_BITS) % q

        ls = list(lagrange.iter_eval_lagrange_poly_for_cyclic_group(S.spec, gamma, ctx.lagrange_domain))[: L + 1]
        with span("fold_trace"):
            new_acc = Accumulator(
                trace=PlonkTrace(
                    ProtoGalaxy.fold_instance(accumulator.trace.u, [t.u for t in incoming], ls, q),
                    fold_witness(S.field, [accumulator.trace.w, *[t.w for t in incoming]], ls),
                ),
                betas=b_stroke,
                e=calculate_e(poly_F, poly_K, gamma, alpha, ctx.lagrange_domain),
            )
        return new_acc, Proof(poly_F, poly_K)

    @staticmethod
    def verify(vp, S_spec, ro_nark: PoseidonHash, ro_acc: PoseidonHash, accumulator: AccumulatorInstance,
               incoming: Sequence[PlonkInstance], proof: Proof) -> AccumulatorInstance:
        """Reference `verify` (`nifs/protogalaxy/mod.rs:510-553`)."""
        q = S_spec.modulus
        L = len(incoming)
        lagrange_domain = (L + 1).bit_length() - 1
        for u in incoming:
            sps_verify(u, ro_nark)
        delta = ProtoGalaxy._delta(vp, ro_acc, accumulator, incoming, q)
        for c in proof.poly_F.coeffs:
            ro_acc.absorb_field(c % q)
        alpha = ro_acc.squeeze(MAX_BITS) % q
        for c in proof.poly_K.coeffs:
            ro_acc.absorb_field(c % q)
        gamma = ro_acc.squeeze(MAX_BITS) % q
        ls = list(lagrange.iter_eval_lagrange_poly_for_cyclic_group(S_spec, gamma, lagrange_domain))
        return AccumulatorInstance(
            ins=ProtoGalaxy.fold_instance(accumulator.ins, incoming, ls, q),
            betas=betas_stroke_of(accumulator.betas, alpha, delta, q),
            e=calculate_e(proof.poly_F, proof.poly_K, gamma, alpha, lagrange_domain),
        )

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
        mism = device_perm_mismatches(S.field, idx, head, leading(acc.trace.w.W[0], S.num_advice_columns, S.n))
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
                with span(name):
                    check()
            except VerifyError as e:
                errors.append(e)
        return errors
