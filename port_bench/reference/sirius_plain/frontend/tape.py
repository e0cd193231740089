"""Witness tape: trace-once / replay-native circuit synthesis.

The port's own copy of `sirius_tpu/frontend/tape.py`.  The reference
synthesizes witnesses with native Rust closures per step
(`src/table/witness_collector.rs`); running the Python gadget stack on every
fold step is the largest host span of both IVC drivers.  The tape removes
that work:

  1. TRACE: run `synthesize` once per circuit shape with `Tr` handles in
     place of the dynamic input ints.  Every arithmetic op the gadgets
     perform on a traced value is recorded as one opcode in a straight-line
     tape (SSA; slot i = result of op i).  Structure (selectors / fixed /
     copies / row layout) never depends on values, so the trace is valid for
     every subsequent step.
  2. REPLAY: per fold step, the program executes the tape on the new input
     values natively.  This copy keeps only the trace, which the public
     parameters' dry syntheses run (the replay is the prover's).

Trace-time comparisons of traced values (the gadgets' internal sanity
asserts, e.g. the carry identity in `BigUintChip.mult_mod`) evaluate to a
truthy placeholder: they are prover-side self-checks, re-checked end-to-end
by `is_sat` in the tests.
"""

from __future__ import annotations

# opcodes (keep in sync with native/witness_tape.cpp)
CONST = 0  # out = consts[b]
ADD = 1    # out = s[a] + s[b]
SUB = 2    # out = s[a] - s[b]
MUL = 3    # out = s[a] * s[b]
MODC = 4   # out = s[a] mod s[b]          (Python %: result in [0, s[b]))
DIVC = 5   # out = s[a] // s[b]           (floor)
SHR = 6    # out = s[a] >> b               (b immediate, floor)
SHL = 7    # out = s[a] << b               (b immediate)
AND = 8    # out = s[a] & s[b]            (s[a] >= 0)
BIT = 9    # out = (s[a] >> b) & 1         (b immediate)
INV0 = 10  # v = s[a] mod s[b]; out = v^-1 mod s[b] if v != 0 else 0
ISZERO = 11  # out = 1 if s[a] == 0 else 0
POWM = 12  # out = pow(s[a], b, s[c])      (b immediate exponent, c modulus slot)
XOR = 13   # out = s[a] ^ s[b]             (both non-negative)

_MAX_MAG = 1 << 1008  # C++ replay magnitude limit (16 x 64-bit limbs)


class _TruthyPred:
    """Result of comparing traced values: truthy, so trace-time sanity
    asserts pass (they are re-verified by is_sat end-to-end)."""

    __slots__ = ()

    def __bool__(self):
        return True


_PRED = _TruthyPred()


class Tr:
    """A traced value: handle to one tape slot, with the tracer's range
    [lb, ub] of the values it can hold."""

    __slots__ = ("t", "s", "lb", "ub")

    def __init__(self, tape: "TapeBuilder", slot: int, lb: int, ub: int):
        self.t = tape
        self.s = slot
        self.lb = lb
        self.ub = ub

    # -- arithmetic -----------------------------------------------------------
    def __add__(self, o):
        return self.t._bin(ADD, self, o)

    __radd__ = __add__

    def __sub__(self, o):
        return self.t._bin(SUB, self, o)

    def __rsub__(self, o):
        return self.t._bin(SUB, o, self)

    def __mul__(self, o):
        return self.t._bin(MUL, self, o)

    __rmul__ = __mul__

    def __neg__(self):
        return self.t._bin(SUB, 0, self)

    def __mod__(self, m):
        if not isinstance(m, int) or m <= 0:
            raise TypeError("traced %% needs a positive int modulus")
        if 0 <= self.lb and self.ub < m:
            return self  # already reduced: skip the op
        return self.t._emit(MODC, self, self.t.const(m), lb=0, ub=m - 1)

    def __floordiv__(self, m):
        if not isinstance(m, int) or m <= 0:
            raise TypeError("traced // needs a positive int divisor")
        return self.t._emit(DIVC, self, self.t.const(m), lb=self.lb // m, ub=self.ub // m)

    def __divmod__(self, m):
        return self // m, self % m

    def __rshift__(self, k):
        if not isinstance(k, int) or k < 0:
            raise TypeError("traced >> needs a non-negative int")
        if k == 0:
            return self
        return self.t._emit(SHR, self, k, lb=self.lb >> k, ub=self.ub >> k)

    def __lshift__(self, k):
        if not isinstance(k, int) or k < 0:
            raise TypeError("traced << needs a non-negative int")
        if k == 0:
            return self
        return self.t._emit(SHL, self, k, lb=self.lb << k, ub=self.ub << k)

    def __and__(self, m):
        if not isinstance(m, int) or m < 0:
            raise TypeError("traced & needs a non-negative int mask")
        if self.lb < 0:
            raise ValueError("traced & on a possibly-negative value")
        return self.t._emit(AND, self, self.t.const(m), lb=0, ub=min(self.ub, m))

    def __xor__(self, o):
        t = self.t
        if isinstance(o, int):
            if o < 0:
                raise ValueError("traced ^ needs non-negative operands")
            o = t.const(o)
        if self.lb < 0 or o.lb < 0:
            raise ValueError("traced ^ needs non-negative operands")
        ub = (1 << max(self.ub.bit_length(), o.ub.bit_length())) - 1
        return t._emit(XOR, self, o, lb=0, ub=ub)

    __rxor__ = __xor__

    def __pow__(self, e, m=None):
        if m is None:
            # plain power: expand to muls (small static exponents only)
            if not isinstance(e, int) or not (0 <= e <= 16):
                raise TypeError("traced ** needs 0 <= int exponent <= 16")
            out = 1
            for _ in range(e):
                out = out * self
            return out
        if not isinstance(e, int) or not isinstance(m, int):
            raise TypeError("traced pow() needs int exponent and modulus")
        if e == -1:
            # only valid when the value is invertible; Python raises on
            # non-invertible: gadget code guards with inv0()/is_zero()
            return self.t._emit(INV0, self, self.t.const(m), lb=0, ub=m - 1)
        if e < 0:
            raise TypeError("traced pow() exponent must be -1 or >= 0")
        return self.t._emit(POWM, self, e, c=self.t.const(m), lb=0, ub=m - 1)

    # -- comparisons: truthy placeholders --------------------------------------
    def __eq__(self, o):  # noqa: D105
        return _PRED

    def __ne__(self, o):
        return _PRED

    def __lt__(self, o):
        return _PRED

    def __le__(self, o):
        return _PRED

    def __gt__(self, o):
        return _PRED

    def __ge__(self, o):
        return _PRED

    def __hash__(self):
        return object.__hash__(self)

    def __bool__(self):
        raise TypeError(
            "traced value used in control flow: rewrite the site with "
            "tape.inv0/is_zero/bit helpers (structure must not depend on values)"
        )

    def __index__(self):
        raise TypeError("traced value used as an index: structure leak")

    def __repr__(self):
        return f"Tr(slot={self.s})"


class TapeBuilder:
    """Records ops; slot i is the result of op i (CONST ops load interned
    constants; INPUT slots come first, before any op)."""

    def __init__(self):
        self.n_inputs = 0
        self.code: list[int] = []
        self.a: list[int] = []
        self.b: list[int] = []
        self.c: list[int] = []
        self.consts: list[int] = []
        self._const_ix: dict[int, Tr] = {}

    # -- slots ------------------------------------------------------------------
    def input(self) -> Tr:
        if self.code:
            raise ValueError("all inputs must be created before tracing ops")
        s = self.n_inputs
        self.n_inputs += 1
        return Tr(self, s, 0, (1 << 256) - 1)

    def inputs(self, n: int) -> list[Tr]:
        return [self.input() for _ in range(n)]

    def const(self, v: int) -> Tr:
        tr = self._const_ix.get(v)
        if tr is None:
            if not (-_MAX_MAG < v < _MAX_MAG):
                raise OverflowError("tape constant exceeds 1008 bits")
            self.consts.append(v)
            tr = self._emit(CONST, 0, len(self.consts) - 1, lb=v, ub=v)
            self._const_ix[v] = tr
        return tr

    # -- emission -----------------------------------------------------------------
    def _emit(self, code: int, a, b, c=0, *, lb: int, ub: int) -> Tr:
        if not (-_MAX_MAG < lb and ub < _MAX_MAG):
            raise OverflowError(
                f"tape value bound exceeds 1008 bits (op {code}); add a % reduction"
            )
        self.code.append(code)
        self.a.append(a.s if isinstance(a, Tr) else a)
        self.b.append(b.s if isinstance(b, Tr) else b)
        self.c.append(c.s if isinstance(c, Tr) else c)
        return Tr(self, self.n_inputs + len(self.code) - 1, lb, ub)

    def _bin(self, code: int, x, y) -> Tr:
        if isinstance(x, int):
            x = self.const(x)
        if isinstance(y, int):
            y = self.const(y)
        if code == ADD:
            lb, ub = x.lb + y.lb, x.ub + y.ub
        elif code == SUB:
            lb, ub = x.lb - y.ub, x.ub - y.lb
        else:  # MUL
            corners = (x.lb * y.lb, x.lb * y.ub, x.ub * y.lb, x.ub * y.ub)
            lb, ub = min(corners), max(corners)
        return self._emit(code, x, y, lb=lb, ub=ub)


def inv0(x, m: int):
    """x^-1 mod m, or 0 when x == 0 (mod m)."""
    if isinstance(x, Tr):
        return x.t._emit(INV0, x, x.t.const(m), lb=0, ub=m - 1)
    x = x % m
    return pow(x, -1, m) if x else 0


def is_zero(x):
    """1 if x == 0 else 0 (x must be reduced already)."""
    if isinstance(x, Tr):
        return x.t._emit(ISZERO, x, 0, lb=0, ub=1)
    return 1 if x == 0 else 0


def bit(x, i: int):
    """(x >> i) & 1 as one op."""
    if isinstance(x, Tr):
        return x.t._emit(BIT, x, i, lb=0, ub=1)
    return (x >> i) & 1


def is_traced(x) -> bool:
    return isinstance(x, Tr)


def clamp(x, lo: int, hi: int):
    """Tighten the tracer's range info for `x` (no op emitted).

    Sound only where the surrounding constraints already enforce the bound
    for honest witnesses (e.g. a remainder produced by MODC then recomposed
    from range-checked limbs); the native replay still hard-fails if a
    violating value reaches an output slot.
    """
    if isinstance(x, Tr):
        return Tr(x.t, x.s, max(x.lb, lo), min(x.ub, hi))
    assert lo <= x <= hi
    return x
