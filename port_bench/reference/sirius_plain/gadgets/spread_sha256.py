"""Spread-table SHA-256 step circuit — the lookup-heavy table16-class
workload: the port's own copy of `sirius_tpu/gadgets/spread_sha256.py`
(reference `examples/sha256/table16/`, driven from
`examples/sha256/main.rs:363-432`; BASELINE.md row "SHA256 (table16)").

NOT a port of halo2's table16.  Same underlying technique — every bitwise op
becomes linear algebra over *spread* words (bit i of a dense word lands at
bit 2i), with a (dense, spread) lookup table supplying the spread forms —
but re-designed around this frontend:

  * ONE width-2 vector lookup (dense, spread) over a 2^H-row table; halo2's
    (tag, dense, spread) tags are replaced by a uniform shifted-dense second
    lookup for sub-H bit widths (c < 2^w  <=>  c·2^(H-w) < 2^H), which keeps
    every range obligation inside the same argument — the whole circuit then
    rides the log-derivative lookup machinery that already runs as fused
    row sweeps (`plonk/lookup.py`).
  * H parameterizes the half-width: H=16 matches the reference scale (2^16
    table, primary k>=17); H=8 gives a 256-row table so the full compression
    is testable on CPU at k=14.
  * Words are little-endian vectors of H-bit *pieces*, each piece a
    (dense, spread) cell pair.  Rotations/shifts never move data: Σ/σ/Ch/Maj
    are linear combinations of piece-spread cells with power-of-4 weights,
    followed by an even/odd interleave split (sum of <=3 spreads has base-4
    digits <=3, so S = spread(even) + 2·spread(odd) uniquely).

Core identities (FIPS 180-4 ops in spread space):
    xor3(a,b,c)  = even(spr a + spr b + spr c)
    Maj(a,b,c)   = odd (spr a + spr b + spr c)
    Ch(e,f,g)    = odd(spr e + spr f) + odd(spr ~e + spr g)   (disjoint)
    spr(~e)      = spr(2^32-1) - spr(e)
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields.constants import FieldSpec
from ..frontend.tape import bit as _bit
from .main_gate import AssignedCell, MainGate, RegionCtx
from .sha256_step_circuit import DOMAIN_WORDS, IV, K, step_fn

M32 = 0xFFFFFFFF
SPREAD_ONES_32 = sum(1 << (2 * j) for j in range(32))  # spread(2^32 - 1)

# rotation/shift schedules (FIPS 180-4): (kind, amount)
SIGMA0_BIG = (("rot", 2), ("rot", 13), ("rot", 22))
SIGMA1_BIG = (("rot", 6), ("rot", 11), ("rot", 25))
SIGMA0_SMALL = (("rot", 7), ("rot", 18), ("shr", 3))
SIGMA1_SMALL = (("rot", 17), ("rot", 19), ("shr", 10))


def _spread(v, w: int):
    """spread(v) over w bits."""
    out = 0
    for j in range(w):
        out = out + _bit(v, j) * (1 << (2 * j))
    return out


@dataclass(frozen=True)
class SpreadVar:
    """One looked-up piece: dense cell + its spread cell."""

    dense: AssignedCell
    spread: AssignedCell
    width: int


@dataclass
class W32:
    """A 32-bit word as little-endian H-bit pieces (dense+spread cells)."""

    pieces: list  # list[SpreadVar]
    H: int

    @property
    def value(self):
        v = 0
        for i, pc in enumerate(self.pieces):
            v = v + pc.dense.value * (1 << (i * self.H))
        return v

    def dense_terms(self):
        return [(pc.dense, 1 << (i * self.H)) for i, pc in enumerate(self.pieces)]

    def spread_terms(self, scale: int = 1):
        return [
            (pc.spread, scale * (1 << (2 * i * self.H)))
            for i, pc in enumerate(self.pieces)
        ]


class SpreadChip:
    """Lookup-backed spread arithmetic over the (dense, spread) table."""

    def __init__(self, mg: MainGate, lookup_cols, half_bits: int = 16):
        self.mg = mg
        self.l_dense, self.l_spread, self.sel = lookup_cols
        self.H = half_bits

    # -- configuration -------------------------------------------------------
    @staticmethod
    def configure(cs):
        """Returns (lookup_cols, table_cols); caller owns the MainGate."""
        l_dense = cs.advice_column()
        l_spread = cs.advice_column()
        sel = cs.selector()
        t_dense = cs.fixed_column()
        t_spread = cs.fixed_column()
        sq = cs.query(sel)
        cs.lookup(
            [sq * cs.query(l_dense), sq * cs.query(l_spread)],
            [cs.query(t_dense), cs.query(t_spread)],
        )
        return (l_dense, l_spread, sel), (t_dense, t_spread)

    def fill_table(self, asn, table_cols):
        """(dense, spread) rows for all 2^H dense values (row 0 = (0,0), the
        sink for selector-off rows)."""
        t_dense, t_spread = table_cols
        spreads = [0] * (1 << self.H)
        for v in range(1, 1 << self.H):
            spreads[v] = spreads[v >> 1] * 4 + (v & 1)
        for v in range(1 << self.H):
            asn.assign_fixed(t_dense, v, v)
            asn.assign_fixed(t_spread, v, spreads[v])

    # -- primitive rows ------------------------------------------------------
    def _lookup_row(self, ctx: RegionCtx, dense_val, spread_val) -> SpreadVar:
        ctx.asn.enable_selector(self.sel, ctx.offset)
        d = ctx.assign_advice(self.l_dense, dense_val)
        s = ctx.assign_advice(self.l_spread, spread_val)
        ctx.next()
        return SpreadVar(d, s, self.H)

    def witness_piece(self, ctx: RegionCtx, val, width: int) -> SpreadVar:
        """Witness val < 2^width with its spread.  width <= H; widths < H add
        a shifted-dense lookup (tag replacement, see module docstring)."""
        H = self.H
        assert width <= H
        sv = self._lookup_row(ctx, val, _spread(val, width))
        if width < H:
            sh = H - width
            shifted = self._lookup_row(
                ctx, val * (1 << sh), sv.spread.value * (1 << (2 * sh))
            )
            # shifted.dense = dense * 2^sh
            p = self.mg.p
            self.mg.apply(
                ctx, [sv.dense, shifted.dense], q_1=[1 << sh, p - 1]
            )
        return SpreadVar(sv.dense, sv.spread, width)

    def lin(self, ctx: RegionCtx, terms, rc: int = 0) -> AssignedCell:
        """Constrained linear combination Σ coef·cell + rc, chained over
        width-T rows; returns the out cell."""
        mg, p = self.mg, self.mg.p
        T = mg.cfg.T
        acc = None
        const = rc % p
        i = 0
        terms = list(terms)
        while i < len(terms) or acc is None:
            room = T - (1 if acc is not None else 0)
            chunk = terms[i : i + room]
            i += room
            cells = ([acc] if acc is not None else []) + [c for c, _ in chunk]
            coefs = ([1] if acc is not None else []) + [k % p for _, k in chunk]
            out = const if acc is None else 0
            for c, k in chunk:
                out = out + c.value * (k % p)
            if acc is not None:
                out = out + acc.value
            out = out % p
            acc = mg.apply(
                ctx, cells, q_1=coefs,
                rc=const if (acc is None) else 0,
                out_val=out, q_o=p - 1,
            )
            const = 0
            if i >= len(terms):
                break
        return acc

    def lin_eq(self, ctx: RegionCtx, terms, target: AssignedCell, rc: int = 0):
        out = self.lin(ctx, terms, rc=rc)
        ctx.constrain_equal(out, target)
        return out

    # -- word-level ops ------------------------------------------------------
    def witness_word32(self, ctx: RegionCtx, val) -> W32:
        H = self.H
        mask = (1 << H) - 1
        pieces = [
            self.witness_piece(ctx, (val >> (i * H)) & mask, H)
            for i in range(32 // H)
        ]
        return W32(pieces, H)

    def constant_word32(self, ctx: RegionCtx, k: int) -> W32:
        """IV/state constants: pieces as rc-constrained constants (no lookup
        rows needed — both dense and spread values are compile-time)."""
        H = self.H
        mask = (1 << H) - 1
        pieces = []
        for i in range(32 // H):
            d = (k >> (i * H)) & mask
            dc = self.mg.assign_constant(ctx, d)
            sc = self.mg.assign_constant(ctx, _spread(d, H))
            pieces.append(SpreadVar(dc, sc, H))
        return W32(pieces, H)

    def split_even_odd(self, ctx: RegionCtx, s_cell: AssignedCell, true_val=None):
        """S = spread(even) + 2·spread(odd); returns (even, odd) as W32s.
        Sound for sums of <=3 spreads (base-4 digits <=3, representation
        unique given both outputs are looked-up spreads).

        true_val: the sum as a plain integer when s_cell.value is only
        correct mod p (any lin() with negative coefficients, e.g. Ch's
        spr(~e) term); positive-sum cells (< 2^66 << p) pass None."""
        S = s_cell.value if true_val is None else true_val
        even = 0
        odd = 0
        for j in range(32):
            even = even + _bit(S, 2 * j) * (1 << j)
            odd = odd + _bit(S, 2 * j + 1) * (1 << j)
        ew = self.witness_word32(ctx, even)
        ow = self.witness_word32(ctx, odd)
        self.lin_eq(ctx, ew.spread_terms() + ow.spread_terms(scale=2), s_cell)
        return ew, ow

    def _sigma_pieces(self, rots):
        """Piece boundaries for a Σ/σ schedule: rotation cuts ∪ H-grid."""
        cuts = sorted({r for _, r in rots} | set(range(0, 32, self.H)) | {32})
        return [(b, e - b) for b, e in zip(cuts, cuts[1:])]

    def sigma(self, ctx: RegionCtx, word: W32, rots) -> W32:
        """Σ/σ(word): decompose into rotation-aligned pieces, take the
        3-rotation spread sum in ONE linear combination, split; returns the
        even word (= the xor of the three rotations)."""
        layout = self._sigma_pieces(rots)
        val = word.value
        chunks = [
            self.witness_piece(ctx, (val >> b) & ((1 << w) - 1), w)
            for b, w in layout
        ]
        # chunk recomposition == word pieces
        recomposed = self.lin(ctx, [(c.dense, 1 << b) for c, (b, _) in zip(chunks, layout)])
        wcell = self.lin(ctx, word.dense_terms())
        ctx.constrain_equal(recomposed, wcell)
        # combined rotation-sum coefficients (per chunk, over all 3 rotations)
        terms = []
        for c, (b, w) in zip(chunks, layout):
            coef = 0
            for kind, r in rots:
                if kind == "rot":
                    coef += 1 << (2 * ((b - r) % 32))
                else:  # shr
                    if b >= r:
                        coef += 1 << (2 * (b - r))
            if coef:
                terms.append((c.spread, coef))
        s_cell = self.lin(ctx, terms)
        even, _odd = self.split_even_odd(ctx, s_cell)
        return even

    def add_mod32(self, ctx: RegionCtx, words, extra_terms=(), const: int = 0,
                  out_bits: int = 32) -> W32:
        """Σ words + Σ extra dense terms + const  ==  out + carry·2^32, with
        out a looked-up word and carry bit-decomposed.  Returns out."""
        mg, p = self.mg, self.mg.p
        total = const
        terms = []
        max_total = const
        for wd in words:
            total = total + wd.value
            terms += wd.dense_terms()
            max_total += M32
        for cell, coef, bound in extra_terms:
            total = total + cell.value * coef
            terms.append((cell, coef))
            max_total += bound * coef
        out_val = total & ((1 << out_bits) - 1)
        carry_val = total >> out_bits
        out = self.witness_word32(ctx, out_val) if out_bits == 32 else None
        assert out_bits == 32, "add_mod32 always produces full words"
        nbits = max((max_total >> out_bits).bit_length(), 1)
        neg = []
        for i in range(nbits):
            b = mg.assign_value(ctx, _bit(carry_val, i))
            mg.assert_bit(ctx, b)
            neg.append((b, -(1 << (out_bits + i))))
        self.lin_eq(
            ctx,
            [(c, -k) for c, k in out.dense_terms()] + neg + terms,
            mg.assign_constant(ctx, 0),
            rc=const,
        )
        return out


# ------------------------------------------------------------------ circuit


@dataclass
class SpreadSha256StepCircuit:
    """IVC step: z_{i+1} = pack(sha256_compress(IV, unpack(z_i) || domain)).

    Same step semantics as `Sha256StepCircuit` (`step_fn`), so the two
    circuits are interchangeable inside the IVC drivers; this one carries
    the table16-class lookup load: ~44 (dense, spread) lookups per round,
    ~4.5k lookup rows per compression at H=16.

    half_bits=16 needs table k>=17; half_bits=8 (256-row table) is the
    CPU-testable scale.  rounds<64 gives reduced-round variants for fast
    tests (host model reduced identically; NOT FIPS output).
    """

    field_spec: FieldSpec
    arity: int = 1
    half_bits: int = 16
    rounds: int = 64

    def instances(self):
        return []

    def configure(self, cs):
        mg_cfg = MainGate.configure(cs, T=5)
        lookup_cols, table_cols = SpreadChip.configure(cs)
        return mg_cfg, lookup_cols, table_cols

    def process_step(self, z_i, k_table_size, spec):
        return [self._step_fn(z_i[0] % spec.modulus, spec.modulus)]

    def _step_fn(self, z: int, modulus: int) -> int:
        if self.rounds == 64:
            return step_fn(z, modulus)
        w = [(z >> (32 * i)) & M32 for i in range(8)] + DOMAIN_WORDS
        s = self._compress_reduced(IV, w)
        out = sum(s[i] << (32 * i) for i in range(7)) + (s[7] & ((1 << 28) - 1)) * (1 << 224)
        return out % modulus

    def _compress_reduced(self, state, w):
        """Host model with self.rounds rounds (test scale)."""
        from .sha256_step_circuit import _rotr

        ws = list(w)
        for i in range(16, self.rounds):
            s0 = _rotr(ws[i - 15], 7) ^ _rotr(ws[i - 15], 18) ^ (ws[i - 15] >> 3)
            s1 = _rotr(ws[i - 2], 17) ^ _rotr(ws[i - 2], 19) ^ (ws[i - 2] >> 10)
            ws.append((ws[i - 16] + s0 + ws[i - 7] + s1) & M32)
        a, b, c, d, e, f, g, h = state
        for i in range(self.rounds):
            S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
            ch = (e & f) ^ (~e & g)
            t1 = (h + S1 + ch + K[i] + ws[i]) & M32
            S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
            maj = (a & b) ^ (a & c) ^ (b & c)
            t2 = (S0 + maj) & M32
            h, g, f, e, d, c, b, a = g, f, e, (d + t1) & M32, c, b, a, (t1 + t2) & M32
        return [(x + y) & M32 for x, y in zip(state, [a, b, c, d, e, f, g, h])]

    # -- synthesis -----------------------------------------------------------
    def synthesize_step(self, config, ctx: RegionCtx, z_i):
        mg_cfg, lookup_cols, table_cols = config
        mg = MainGate(mg_cfg, ctx.asn.p)
        chip = SpreadChip(mg, lookup_cols, self.half_bits)
        chip.fill_table(ctx.asn, table_cols)
        H = chip.H
        p = mg.p

        zv = z_i[0].value
        # unpack z into message words w0..w7 (w7 < 2^28) + domain constants
        words = []
        for i in range(7):
            words.append(chip.witness_word32(ctx, (zv >> (32 * i)) & M32))
        w7v = (zv >> 224) & ((1 << 28) - 1)
        w7 = self._witness_narrow_word(chip, ctx, w7v, 28)
        words.append(w7)
        z_terms = []
        for i, wd in enumerate(words):
            z_terms += [(c, k * (1 << (32 * i))) for c, k in wd.dense_terms()]
        chip.lin_eq(ctx, z_terms, z_i[0])
        for kw in DOMAIN_WORDS:
            words.append(chip.constant_word32(ctx, kw))

        # message schedule
        for i in range(16, self.rounds):
            s0 = chip.sigma(ctx, words[i - 15], SIGMA0_SMALL)
            s1 = chip.sigma(ctx, words[i - 2], SIGMA1_SMALL)
            words.append(chip.add_mod32(ctx, [words[i - 16], s0, words[i - 7], s1]))

        # rounds
        state = [chip.constant_word32(ctx, v) for v in IV]
        a, b, c, d, e, f, g, h = state
        for i in range(self.rounds):
            S1 = chip.sigma(ctx, e, SIGMA1_BIG)
            # Ch(e,f,g): P = spr e + spr f ; Q = spr(~e) + spr g
            p_cell = chip.lin(ctx, e.spread_terms() + f.spread_terms())
            _pe, po = chip.split_even_odd(ctx, p_cell)
            q_cell = chip.lin(
                ctx,
                [(cl, -k) for cl, k in e.spread_terms()] + g.spread_terms(),
                rc=SPREAD_ONES_32,
            )
            q_int = SPREAD_ONES_32
            for cl, k in e.spread_terms():
                q_int = q_int - cl.value * k
            for cl, k in g.spread_terms():
                q_int = q_int + cl.value * k
            _qe, qo = chip.split_even_odd(ctx, q_cell, true_val=q_int)
            S0 = chip.sigma(ctx, a, SIGMA0_BIG)
            m_cell = chip.lin(
                ctx, a.spread_terms() + b.spread_terms() + c.spread_terms()
            )
            _me, maj = chip.split_even_odd(ctx, m_cell)

            # e' = d + h + S1 + ch + K + w ; a' = t1 + t2 (t1 folded in directly)
            t1_words = [h, S1, po, qo, words[i]]
            e_new = chip.add_mod32(ctx, [d] + t1_words, const=K[i])
            a_new = chip.add_mod32(ctx, t1_words + [S0, maj], const=K[i])
            h, g, f, e, d, c, b, a = g, f, e, e_new, c, b, a, a_new

        # final digest adds (state starts at IV constants)
        digest = []
        for iv, wd in zip(IV, [a, b, c, d, e, f, g, h]):
            digest.append(chip.add_mod32(ctx, [wd], const=iv))

        # pack: z' = Σ d_i 2^32i, d7 mod 2^28
        d7 = digest[7]
        d7v = d7.value
        m7v = d7v & ((1 << 28) - 1)
        m7 = self._witness_narrow_word(chip, ctx, m7v, 28)
        top = chip.witness_piece(ctx, (d7v >> 28) & 0xF, 4)
        chip.lin_eq(
            ctx,
            [(c2, k) for c2, k in m7.dense_terms()] + [(top.dense, 1 << 28)],
            chip.lin(ctx, d7.dense_terms()),
        )
        out_terms = []
        for i, wd in enumerate(digest[:7]):
            out_terms += [(c2, k * (1 << (32 * i))) for c2, k in wd.dense_terms()]
        out_terms += [(c2, k * (1 << 224)) for c2, k in m7.dense_terms()]
        z_out = chip.lin(ctx, out_terms)
        return [z_out]

    def _witness_narrow_word(self, chip: SpreadChip, ctx, val, nbits: int) -> W32:
        """A word known < 2^nbits: top piece width-narrowed, upper pieces
        pinned to constant zero cells so dense_terms stays a full word."""
        H = chip.H
        mask = (1 << H) - 1
        pieces = []
        for i in range(32 // H):
            lo = i * H
            w = min(H, max(nbits - lo, 0))
            if w == 0:
                zd = chip.mg.assign_constant(ctx, 0)
                pieces.append(SpreadVar(zd, zd, H))
            else:
                pieces.append(chip.witness_piece(ctx, (val >> lo) & mask, w))
        return W32(pieces, H)
