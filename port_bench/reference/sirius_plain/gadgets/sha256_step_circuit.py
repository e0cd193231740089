"""SHA-256 compression step circuit: the port's own copy of
`sirius_tpu/gadgets/sha256_step_circuit.py` (capability analogue of the
reference's `examples/sha256` table16 pipeline), with the host model that
`gadgets/spread_sha256.py` imports.

NOT a port: the reference uses halo2's table16 spread-lookup decomposition;
here the compression function is built bitwise on the universal MainGate
(xor/ch/maj as single quadratic rows over bit cells, mod-2^32 adds via
recompose + bit-decompose), which maps directly onto the row-parallel
evaluation pipeline.

Step semantics (arity 1):
  w[0..8)  = the eight 32-bit words of z_i (little-endian word order)
  w[8..16) = fixed domain words
  state'   = sha256_compress(IV, w)
  z_{i+1}  = sum_{i<7} state'_i 2^(32 i) + (state'_7 mod 2^28) 2^224  (< 2^252)
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields.constants import FieldSpec
from .main_gate import MainGate, RegionCtx

K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]
IV = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]
DOMAIN_WORDS = [0x53495249, 0x55535F54, 0x50555F53, 0x48413235,  # "SIRI US_T PU_S HA25"
                0x36000000, 0x00000001, 0x00000002, 0x00000003]
M32 = 0xFFFFFFFF


def _rotr(x: int, r: int) -> int:
    return ((x >> r) | (x << (32 - r))) & M32


def sha256_compress(state: list[int], w: list[int]) -> list[int]:
    """Host model of one compression (standard FIPS 180-4 round function)."""
    ws = list(w)
    for i in range(16, 64):
        s0 = _rotr(ws[i - 15], 7) ^ _rotr(ws[i - 15], 18) ^ (ws[i - 15] >> 3)
        s1 = _rotr(ws[i - 2], 17) ^ _rotr(ws[i - 2], 19) ^ (ws[i - 2] >> 10)
        ws.append((ws[i - 16] + s0 + ws[i - 7] + s1) & M32)
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + S1 + ch + K[i] + ws[i]) & M32
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (S0 + maj) & M32
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & M32, c, b, a, (t1 + t2) & M32
    return [(x + y) & M32 for x, y in zip(state, [a, b, c, d, e, f, g, h])]


def step_fn(z: int, modulus: int) -> int:
    w = [(z >> (32 * i)) & M32 for i in range(8)] + DOMAIN_WORDS
    s = sha256_compress(IV, w)
    out = sum(s[i] << (32 * i) for i in range(7)) + (s[7] & ((1 << 28) - 1)) * (1 << 224)
    return out % modulus


# --------------------------------------------------------------- circuit

class _Word:
    """32-bit word as little-endian bit cells (+ lazily recomposed value)."""

    def __init__(self, bits):
        assert len(bits) == 32
        self.bits = bits
        self.val_cell = None  # lazily recomposed value (cached on the word:
        # an external id()-keyed cache is unsound, ids get reused after GC)

    def rotr(self, r):
        return _Word(self.bits[r:] + self.bits[:r])

    def shr(self, mg, ctx, r):
        zero = mg.assign_constant(ctx, 0)
        return _Word(self.bits[r:] + [zero] * r)


@dataclass
class Sha256StepCircuit:
    field_spec: FieldSpec
    arity: int = 1

    def instances(self):
        return []

    def configure(self, cs):
        return MainGate.configure(cs, T=5)

    def process_step(self, z_i, k_table_size, spec):
        return [step_fn(z_i[0] % spec.modulus, spec.modulus)]

    # -- bit-op rows ---------------------------------------------------
    def _xor(self, mg, ctx, a, b):
        out = (a.value + b.value - 2 * a.value * b.value) % mg.p
        return mg.apply(ctx, [a, b], q_1=[1, 1], q_m=[mg.p - 2, 0], out_val=out, q_o=mg.p - 1)

    def _xor3w(self, mg, ctx, x, y, z):
        return _Word([self._xor(mg, ctx, self._xor(mg, ctx, a, b), c)
                      for a, b, c in zip(x.bits, y.bits, z.bits)])

    def _ch(self, mg, ctx, e, f, g):
        # ch = g + e*(f - g):  t = e*f ; out = t + g - e*g
        t_val = e.value * f.value % mg.p
        t = mg.apply(ctx, [e, f], q_m=[1, 0], out_val=t_val, q_o=mg.p - 1)
        out = (t.value + g.value - e.value * g.value) % mg.p
        return mg.apply(ctx, [e, g, t, g], q_1=[0, 1, 1, 0], q_m=[mg.p - 1, 0],
                        out_val=out, q_o=mg.p - 1)

    def _maj(self, mg, ctx, a, b, c):
        x = self._xor(mg, ctx, a, b)
        u_val = a.value * b.value % mg.p
        u = mg.apply(ctx, [a, b], q_m=[1, 0], out_val=u_val, q_o=mg.p - 1)
        out = (u.value + c.value * x.value) % mg.p
        return mg.apply(ctx, [c, x, u], q_1=[0, 0, 1], q_m=[1, 0], out_val=out, q_o=mg.p - 1)

    # -- word helpers ----------------------------------------------------
    def _value(self, mg, ctx, word):
        if word.val_cell is None:
            word.val_cell = mg.le_bits_to_num(ctx, word.bits)
        return word.val_cell

    def _add_mod32(self, mg, ctx, terms, const=0):
        """(sum of word-value cells + const) mod 2^32 -> _Word."""
        acc = None
        for t in terms:
            acc = t if acc is None else mg.add(ctx, acc, t)
        if const:
            acc = mg.add_with_const(ctx, acc, const)
        nbits = 32 + max(len(terms).bit_length(), 1) + 1
        bits = mg.le_num_to_bits(ctx, acc, nbits)
        return _Word(bits[:32])

    def synthesize_step(self, config, ctx: RegionCtx, z_i):
        mg = MainGate(config, ctx.asn.p)

        zbits = mg.le_num_to_bits(ctx, z_i[0], self.field_spec.num_bits)
        zbits = zbits + [mg.assign_constant(ctx, 0)] * (256 - len(zbits))
        words = [_Word(zbits[32 * i : 32 * (i + 1)]) for i in range(8)]
        for dw in DOMAIN_WORDS:
            cells = []
            for j in range(32):
                bit = (dw >> j) & 1
                cells.append(mg.assign_constant(ctx, bit))
            words.append(_Word(cells))

        wvals = [self._value(mg, ctx, w) for w in words]

        # message schedule
        for i in range(16, 64):
            wm15, wm2 = words[i - 15], words[i - 2]
            s0 = self._xor3w(mg, ctx, wm15.rotr(7), wm15.rotr(18), wm15.shr(mg, ctx, 3))
            s1 = self._xor3w(mg, ctx, wm2.rotr(17), wm2.rotr(19), wm2.shr(mg, ctx, 10))
            nw = self._add_mod32(
                mg, ctx,
                [wvals[i - 16], self._value(mg, ctx, s0), wvals[i - 7], self._value(mg, ctx, s1)],
            )
            words.append(nw)
            wvals.append(self._value(mg, ctx, nw))

        # initial state as constant bit words
        state = []
        for h0 in IV:
            state.append(_Word([mg.assign_constant(ctx, (h0 >> j) & 1) for j in range(32)]))
        a, b, c, d, e, f, g, h = state

        def val(w):
            return self._value(mg, ctx, w)

        for i in range(64):
            S1 = self._xor3w(mg, ctx, e.rotr(6), e.rotr(11), e.rotr(25))
            ch = _Word([self._ch(mg, ctx, x, y, z) for x, y, z in zip(e.bits, f.bits, g.bits)])
            t1 = self._add_mod32(
                mg, ctx,
                [val(h), self._value(mg, ctx, S1), self._value(mg, ctx, ch), wvals[i]],
                const=K[i],
            )
            S0 = self._xor3w(mg, ctx, a.rotr(2), a.rotr(13), a.rotr(22))
            maj = _Word([self._maj(mg, ctx, x, y, z) for x, y, z in zip(a.bits, b.bits, c.bits)])
            t2 = self._add_mod32(
                mg, ctx, [self._value(mg, ctx, S0), self._value(mg, ctx, maj)]
            )
            e_new = self._add_mod32(mg, ctx, [val(d), self._value(mg, ctx, t1)])
            a_new = self._add_mod32(
                mg, ctx, [self._value(mg, ctx, t1), self._value(mg, ctx, t2)]
            )
            h, g, f, e, d, c, b, a = g, f, e, e_new, c, b, a, a_new

        finals = []
        for s0_word, cur in zip(IV, [a, b, c, d, e, f, g, h]):
            finals.append(self._add_mod32(mg, ctx, [val(cur)], const=s0_word))

        # z' = sum_{i<7} s_i 2^(32 i) + (s_7 mod 2^28) 2^224
        out = self._value(mg, ctx, finals[0])
        for i in range(1, 7):
            v = self._value(mg, ctx, finals[i])
            shifted = mg.mul_by_const(ctx, v, 1 << (32 * i))
            out = mg.add(ctx, out, shifted)
        low28 = mg.le_bits_to_num(ctx, finals[7].bits[:28])
        out = mg.add(ctx, out, mg.mul_by_const(ctx, low28, 1 << 224))
        return [out]
