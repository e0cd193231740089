"""Poseidon sponge on the host: Grain LFSR constants, the optimized round
schedule, and the transcript hash.

Counterpart of the host half of `sirius_tpu/ops/poseidon.py` (Python ints,
bit-identical: the same Grain derivation, the PSE optimized schedule with
sparse partial-round matrices, and the reference sponge semantics of
squeezing `state[1]` over the whole absorbed buffer).  The batched device
permutation (`DevicePoseidon`) is not on the ported path.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Sequence

from ..fields.constants import FieldSpec

STATE_BITS = 80


class Grain:
    """Grain LFSR from the Poseidon reference spec (also used by PSE poseidon
    and halo2_gadgets).  Host-side, setup-time only."""

    def __init__(self, field: FieldSpec, t: int, r_f: int, r_p: int):
        bits = [1] * STATE_BITS

        def set_bits(offset: int, length: int, value: int):
            # parameters are placed MSB-first
            for i in range(length):
                bits[offset + length - 1 - i] = (value >> i) & 1

        FIELD_TAG_PRIME = 1
        SBOX_TAG_POW = 0
        set_bits(0, 2, FIELD_TAG_PRIME)
        set_bits(2, 4, SBOX_TAG_POW)
        set_bits(6, 12, field.num_bits)
        set_bits(18, 12, t)
        set_bits(30, 10, r_f)
        set_bits(40, 10, r_p)

        self.state = bits
        self.field = field
        # discard the first 160 update bits
        for _ in range(160):
            self._update()

    def _update(self) -> int:
        s = self.state
        nb = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        self.state = s[1:] + [nb]
        return nb

    def next_bit(self) -> int:
        """Self-shrinking output: evaluate update bits in pairs; when the
        first is 1 emit the second, otherwise discard both."""
        while True:
            a = self._update()
            b = self._update()
            if a:
                return b

    def _next_bits_value(self) -> int:
        """Draw field.num_bits bits, first bit = MSB, as an integer."""
        v = 0
        for _ in range(self.field.num_bits):
            v = (v << 1) | self.next_bit()
        return v

    def next_field_element(self) -> int:
        """Rejection sampling (round constants)."""
        while True:
            v = self._next_bits_value()
            if v < self.field.modulus:
                return v

    def next_field_element_without_rejection(self) -> int:
        """No rejection: reduce mod p (MDS x/y samples)."""
        return self._next_bits_value() % self.field.modulus


@dataclass(frozen=True)
class PoseidonSpec:
    """Round constants + MDS for a (field, T, RATE, r_f, r_p) instance."""

    field: FieldSpec
    t: int
    rate: int
    r_f: int
    r_p: int
    round_constants: tuple  # (r_f + r_p) tuples of t ints
    mds: tuple  # t tuples of t ints

    @property
    def initial_state(self) -> list[int]:
        # PSE poseidon State::default(): capacity element 2^64, rest zero
        return [1 << 64] + [0] * (self.t - 1)


# --- host modular matrix helpers (setup-time only) -------------------------


def _mat_vec(M, v, p):
    return tuple(sum(m * x for m, x in zip(row, v)) % p for row in M)


def _mat_mul(A, B, p):
    return tuple(
        tuple(sum(A[i][k] * B[k][j] for k in range(len(B))) % p for j in range(len(B[0])))
        for i in range(len(A))
    )


def _mat_inv(M, p):
    """Gauss-Jordan inverse mod p."""
    n = len(M)
    aug = [list(row) + [1 if i == j else 0 for j in range(n)] for i, row in enumerate(M)]
    for col in range(n):
        piv = next(r for r in range(col, n) if aug[r][col] % p)
        aug[col], aug[piv] = aug[piv], aug[col]
        inv = pow(aug[col][col], -1, p)
        aug[col] = [(x * inv) % p for x in aug[col]]
        for r in range(n):
            if r != col and aug[r][col]:
                fac = aug[r][col]
                aug[r] = [(x - fac * y) % p for x, y in zip(aug[r], aug[col])]
    return tuple(tuple(row[n:]) for row in aug)


@dataclass(frozen=True)
class OptimizedPoseidon:
    """PSE optimized-schedule constants (reference `poseidon_hash.rs:206-237`):
    start (half+1 rows), partial (r_p scalars), end (half-1 rows),
    pre_sparse_mds (t x t), and per-partial-round sparse matrices
    [[row], [col | I]] (apply: new0 = row . s; new_i = col[i-1]*s0 + s_i)."""

    start: tuple
    partial: tuple
    end: tuple
    pre_sparse_mds: tuple
    sparse_rows: tuple
    sparse_cols: tuple


@lru_cache(maxsize=None)
def optimized_spec(spec: PoseidonSpec) -> OptimizedPoseidon:
    """Fold the plain (ARC -> sbox -> MDS) schedule into the optimized form.

    Backward induction with invariant u_i = A_i v_i + a_i over the partial
    chain (v_i = plain pre-sbox state, A_i = [[1,0],[0,Ahat]], a_i[0] = 0):
      A_rp = I, a_rp = 0
      D = A_{i+1} M;  Sigma_i = [[D00, v Dhat^-1], [w, I]];  A_i = [[1,0],[0,Dhat]]
      u = Sigma_i^-1 (A_{i+1} c_{half+i+1} + a_{i+1});  g_i = u[0];  a_i = u - e0 g_i
      pre_sparse = A_0 M;  start[half] = pre_sparse^-1 (A_0 c_half + a_0)
    Full-round constants just pass through M^-1 (sbox-then-add form).
    """
    p = spec.field.modulus
    t, r_f, r_p = spec.t, spec.r_f, spec.r_p
    half = r_f // 2
    M = spec.mds
    M_inv = _mat_inv(M, p)
    c = spec.round_constants  # (r_f + r_p) rows of t

    ident_tail = tuple(
        tuple(1 if i == j else 0 for j in range(t - 1)) for i in range(t - 1)
    )

    A = tuple(tuple(1 if i == j else 0 for j in range(t)) for i in range(t))  # A_rp
    a = (0,) * t
    sparse_rows: list = [None] * r_p
    sparse_cols: list = [None] * r_p
    partial: list = [None] * r_p
    for i in range(r_p - 1, -1, -1):
        D = _mat_mul(A, M, p)
        Dhat = tuple(row[1:] for row in D[1:])
        w = tuple(row[0] for row in D[1:])
        v = D[0][1:]
        Dhat_inv = _mat_inv(Dhat, p)
        row = (D[0][0],) + tuple(
            sum(v[k] * Dhat_inv[k][j] for k in range(t - 1)) % p for j in range(t - 1)
        )
        sparse_rows[i] = row
        sparse_cols[i] = w
        # Sigma_i as a full matrix for the constants solve
        Sigma = (row,) + tuple((w[j],) + ident_tail[j] for j in range(t - 1))
        R = tuple(
            (x + y) % p for x, y in zip(_mat_vec(A, c[half + i + 1], p), a)
        )
        u = _mat_vec(_mat_inv(Sigma, p), R, p)
        partial[i] = u[0]
        a = (0,) + u[1:]
        A = ((1,) + (0,) * (t - 1),) + tuple((0,) + Dhat[j] for j in range(t - 1))

    pre_sparse = _mat_mul(A, M, p)
    start_last = _mat_vec(
        _mat_inv(pre_sparse, p),
        tuple((x + y) % p for x, y in zip(_mat_vec(A, c[half], p), a)),
        p,
    )
    start = (tuple(c[0]),) + tuple(_mat_vec(M_inv, c[j], p) for j in range(1, half)) + (
        start_last,
    )
    end = tuple(_mat_vec(M_inv, c[half + r_p + 1 + j], p) for j in range(half - 1))
    return OptimizedPoseidon(
        start=start,
        partial=tuple(partial),
        end=end,
        pre_sparse_mds=pre_sparse,
        sparse_rows=tuple(sparse_rows),
        sparse_cols=tuple(sparse_cols),
    )


@lru_cache(maxsize=None)
def poseidon_spec(field: FieldSpec, t: int, rate: int, r_f: int, r_p: int) -> PoseidonSpec:
    assert rate == t - 1
    grain = Grain(field, t, r_f, r_p)
    p = field.modulus
    rc = tuple(
        tuple(grain.next_field_element() for _ in range(t)) for _ in range(r_f + r_p)
    )
    xs = [grain.next_field_element_without_rejection() for _ in range(t)]
    ys = [grain.next_field_element_without_rejection() for _ in range(t)]
    mds = tuple(
        tuple(pow((x + y) % p, -1, p) for y in ys) for x in xs
    )
    return PoseidonSpec(field, t, rate, r_f, r_p, rc, mds)


# ---------------------------------------------------------------------------
# Host permutation + sponge (python ints; transcript sequencing path)
# ---------------------------------------------------------------------------


def permute(spec: PoseidonSpec, state: list[int], inputs: Sequence[int]) -> list[int]:
    """One absorbing permutation: add inputs (+1 padding marker right after
    the last input when it fits) then run the full round schedule.

    Mirrors the reference's `pre_round` absorption folding
    (`poseidon_hash.rs:206-237`) in its unoptimized-equivalent form.
    """
    p = spec.field.modulus
    t, r_f, r_p = spec.t, spec.r_f, spec.r_p
    assert len(inputs) <= spec.rate
    s = list(state)
    for i, v in enumerate(inputs):
        s[1 + i] = (s[1 + i] + v) % p
    if len(inputs) < spec.rate:
        s[1 + len(inputs)] = (s[1 + len(inputs)] + 1) % p

    half = r_f // 2
    for r in range(r_f + r_p):
        rc = spec.round_constants[r]
        s = [(x + c) % p for x, c in zip(s, rc)]
        if half <= r < half + r_p:
            s[0] = pow(s[0], 5, p)
        else:
            s = [pow(x, 5, p) for x in s]
        s = [sum(m * x for m, x in zip(row, s)) % p for row in spec.mds]
    return s


def permute_optimized(spec: PoseidonSpec, state: list[int], inputs: Sequence[int]) -> list[int]:
    """One absorbing permutation on the optimized schedule — mirrors the
    reference `poseidon_hash.rs:205-237` step for step (pre_round,
    sbox_full+mds, sbox_full+pre_sparse_mds, sbox_part+sparse, sbox_full+mds,
    final zero-constant full round).  Bit-identical output to `permute`."""
    p = spec.field.modulus
    t, r_f, r_p = spec.t, spec.r_f, spec.r_p
    half = r_f // 2
    opt = optimized_spec(spec)
    assert len(inputs) <= spec.rate

    # pre_round: add inputs + start[0] (+1 padding marker after the inputs)
    s = list(state)
    k0 = opt.start[0]
    s[0] = (s[0] + k0[0]) % p
    for i in range(spec.rate):
        v = inputs[i] if i < len(inputs) else (1 if i == len(inputs) else 0)
        s[1 + i] = (s[1 + i] + v + k0[1 + i]) % p

    def sbox_full(s, ks):
        return [(pow(x, 5, p) + k) % p for x, k in zip(s, ks)]

    def mat(M, s):
        return [sum(m * x for m, x in zip(row, s)) % p for row in M]

    for j in range(1, half):
        s = mat(spec.mds, sbox_full(s, opt.start[j]))
    s = mat(opt.pre_sparse_mds, sbox_full(s, opt.start[half]))

    for i in range(r_p):
        s[0] = (pow(s[0], 5, p) + opt.partial[i]) % p
        row, col = opt.sparse_rows[i], opt.sparse_cols[i]
        s0 = sum(r * x for r, x in zip(row, s)) % p
        s = [s0] + [(c * s[0] + x) % p for c, x in zip(col, s[1:])]

    for j in range(half - 1):
        s = mat(spec.mds, sbox_full(s, opt.end[j]))
    return mat(spec.mds, sbox_full(s, (0,) * t))


class PoseidonHash:
    """Host transcript random oracle (`ROTrait` analogue).

    Reference: `src/poseidon/poseidon_hash.rs:155-237` and
    `src/poseidon/random_oracle.rs:22-79`.  Note the reference's buffer is
    *not* cleared by `output` — squeezing re-hashes the whole absorbed prefix
    and further absorbs extend it; we reproduce that.
    """

    def __init__(self, spec: PoseidonSpec):
        self.spec = spec
        self.buf: list[int] = []

    def absorb_field(self, v: int) -> "PoseidonHash":
        self.buf.append(v % self.spec.field.modulus)
        return self

    def absorb_iter(self, vs) -> "PoseidonHash":
        for v in vs:
            self.absorb_field(int(v))
        return self

    def absorb_point(self, pt) -> "PoseidonHash":
        """Absorb an affine point's coordinates cast into this field
        (identity absorbs (0, 0)); reference `poseidon_hash.rs:128-141`."""
        p = self.spec.field.modulus
        if pt.is_identity:
            self.buf += [0, 0]
        else:
            self.buf += [pt.x % p, pt.y % p]
        return self

    def squeeze(self, num_bits: int) -> int:
        """Output `num_bits` little-endian bits of state[1] as an integer.

        The result is < 2^num_bits, suitable for lifting into any field of
        >= num_bits bits (the reference squeezes into a *different* field D).
        """
        spec = self.spec
        rate = spec.rate
        buf = list(self.buf)
        exact = len(buf) % rate == 0

        state = spec.initial_state
        for i in range(0, len(buf), rate):
            state = permute_optimized(spec, state, buf[i : i + rate])
        if exact:
            state = permute_optimized(spec, state, [])

        return state[1] & ((1 << num_bits) - 1)
