"""Symbolic gate-polynomial IR (host-side, setup-time).

The port's own copy of `sirius_tpu/poly/expression.py`, with what the port's
paths use (the port imports nothing of the JAX package).

Replaces reference `src/polynomial/expression.rs` (SURVEY.md §2.2).  The
column index space follows the reference convention
(`expression.rs:86-102`):

    [ selectors | fixed | advice | 5 * lookup-vars ]

and after fold-transform / grouping, the paired "incoming" copies of the
foldable variables (advice + lookup vars) live at `index + num_fold_vars`.

Constants are plain Python ints (mod p deferred to evaluation).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Sequence


class QueryType(Enum):
    SELECTOR = "selector"
    FIXED = "fixed"
    ADVICE = "advice"
    LOOKUP = "lookup"


@dataclass(frozen=True)
class QueryIndexContext:
    """Sizes of each column class (reference `expression.rs:39-71`)."""

    num_selectors: int = 0
    num_fixed: int = 0
    num_advice: int = 0
    num_challenges: int = 0
    num_lookups: int = 0

    @property
    def num_fold_vars(self) -> int:
        return self.num_advice + self.num_lookups * 5

    def shift_advice_index(self, index: int) -> int:
        return index + self.num_fold_vars

    def shift_lookup_index(self, index: int) -> int:
        return index + self.num_fold_vars

    def with_challenges(self, n: int) -> "QueryIndexContext":
        return QueryIndexContext(
            self.num_selectors, self.num_fixed, self.num_advice, n, self.num_lookups
        )


@dataclass(frozen=True)
class Query:
    index: int
    rotation: int = 0

    def subtype(self, ctx: QueryIndexContext) -> QueryType:
        i = self.index
        if i < ctx.num_selectors:
            return QueryType.SELECTOR
        i -= ctx.num_selectors
        if i < ctx.num_fixed:
            return QueryType.FIXED
        i -= ctx.num_fixed
        if i < ctx.num_advice:
            return QueryType.ADVICE
        i -= ctx.num_advice
        if i < 5 * ctx.num_lookups:
            return QueryType.LOOKUP
        raise ValueError(f"unknown query index {self.index} in {ctx}")


class Expression:
    """Base AST node with operator overloading."""

    __slots__ = ()

    def __add__(self, other):
        return Sum(self, _lift(other))

    def __radd__(self, other):
        return Sum(_lift(other), self)

    def __sub__(self, other):
        return Sum(self, Neg(_lift(other)))

    def __rsub__(self, other):
        return Sum(_lift(other), Neg(self))

    def __mul__(self, other):
        if isinstance(other, int):
            return Scaled(self, other)
        return Product(self, _lift(other))

    def __rmul__(self, other):
        if isinstance(other, int):
            return Scaled(self, other)
        return Product(_lift(other), self)

    def __neg__(self):
        return Neg(self)

    # -- analysis --------------------------------------------------------------
    def challenge_set(self) -> set[int]:
        out: set[int] = set()

        def walk(e):
            if isinstance(e, Challenge):
                out.add(e.index)
            elif isinstance(e, Neg) or isinstance(e, Scaled):
                walk(e.arg)
            elif isinstance(e, (Sum, Product)):
                walk(e.lhs)
                walk(e.rhs)

        walk(self)
        return out

    def num_challenges(self) -> int:
        return len(self.challenge_set())

    def degree(self, ctx: QueryIndexContext) -> int:
        """Folding degree: advice/lookup queries and challenges count 1
        (reference `expression.rs:431-447`)."""
        memo: dict[int, int] = {}

        def go(e) -> int:
            hit = memo.get(id(e))
            if hit is not None:
                return hit
            if isinstance(e, Poly):
                d = 1 if e.query.subtype(ctx) in (QueryType.ADVICE, QueryType.LOOKUP) else 0
            elif isinstance(e, Challenge):
                d = 1
            elif isinstance(e, (Neg, Scaled)):
                d = go(e.arg)
            elif isinstance(e, Sum):
                d = max(go(e.lhs), go(e.rhs))
            elif isinstance(e, Product):
                d = go(e.lhs) + go(e.rhs)
            else:
                d = 0
            memo[id(e)] = d
            return d

        return go(self)

    def homogeneous(self, ctx: QueryIndexContext) -> "HomogeneousExpression":
        """Equalize monomial degrees with a homogenizing challenge u at index
        `ctx.num_challenges` (reference `expression.rs:356-429`)."""
        u_index = ctx.num_challenges

        def u_pow(d: int) -> Expression:
            e: Expression = Challenge(u_index)
            for _ in range(d - 1):
                e = Product(e, Challenge(u_index))
            return e

        def go(e: Expression) -> tuple[Expression, int]:
            if isinstance(e, Constant):
                return e, 0
            if isinstance(e, Poly):
                d = 1 if e.query.subtype(ctx) in (QueryType.ADVICE, QueryType.LOOKUP) else 0
                return e, d
            if isinstance(e, Challenge):
                return e, 1
            if isinstance(e, Neg):
                a, d = go(e.arg)
                return Neg(a), d
            if isinstance(e, Sum):
                (a, da), (b, db) = go(e.lhs), go(e.rhs)
                if da > db:
                    return Sum(a, Product(b, u_pow(da - db))), da
                if da < db:
                    return Sum(Product(a, u_pow(db - da)), b), db
                return Sum(a, b), da
            if isinstance(e, Product):
                (a, da), (b, db) = go(e.lhs), go(e.rhs)
                return Product(a, b), da + db
            if isinstance(e, Scaled):
                a, d = go(e.arg)
                return Scaled(a, e.scalar), d
            raise TypeError(e)

        expr, degree = go(self)
        return HomogeneousExpression(expr, degree)

    def visualize(self) -> str:
        """Human-readable form; used by snapshot tests
        (reference `expression.rs:260-300` visualize)."""
        if isinstance(self, Constant):
            return f"0x{self.value:x}"
        if isinstance(self, Poly):
            q = self.query
            rot = "" if q.rotation == 0 else f"[{q.rotation:+d}]"
            return f"Z_{q.index}{rot}"
        if isinstance(self, Challenge):
            return f"r_{self.index}"
        if isinstance(self, Neg):
            return f"-{self.arg.visualize()}"
        if isinstance(self, Sum):
            if isinstance(self.rhs, Neg):
                return f"{self.lhs.visualize()} - {self.rhs.arg.visualize()}"
            return f"{self.lhs.visualize()} + {self.rhs.visualize()}"
        if isinstance(self, Product):
            l = self.lhs.visualize()
            r = self.rhs.visualize()
            if isinstance(self.lhs, Sum):
                l = f"({l})"
            if isinstance(self.rhs, Sum):
                r = f"({r})"
            return f"{l} * {r}"
        if isinstance(self, Scaled):
            return f"0x{self.scalar:x} * {self.arg.visualize()}"
        raise TypeError(self)

    def __repr__(self):
        return self.visualize()


def _lift(v) -> Expression:
    if isinstance(v, Expression):
        return v
    if isinstance(v, int):
        return Constant(v)
    raise TypeError(v)


@dataclass(frozen=True, repr=False)
class Constant(Expression):
    value: int


@dataclass(frozen=True, repr=False)
class Poly(Expression):
    query: Query


@dataclass(frozen=True, repr=False)
class Challenge(Expression):
    index: int


@dataclass(frozen=True, repr=False)
class Neg(Expression):
    arg: Expression


@dataclass(frozen=True, repr=False)
class Sum(Expression):
    lhs: Expression
    rhs: Expression


@dataclass(frozen=True, repr=False)
class Product(Expression):
    lhs: Expression
    rhs: Expression


@dataclass(frozen=True, repr=False)
class Scaled(Expression):
    arg: Expression
    scalar: int


@dataclass(frozen=True)
class HomogeneousExpression:
    expr: Expression
    degree: int


def compress_expression(exprs: Sequence[Expression], challenge_index: int) -> Expression:
    """Random-linear-combine gates with Challenge(challenge_index); earlier
    expressions receive higher challenge powers (reference
    `src/plonk/util.rs:35-55` fold order)."""
    if len(exprs) > 1:
        y = Challenge(challenge_index)
        acc: Expression = Constant(0)
        for e in exprs:
            acc = Sum(e, Product(acc, y))
        return acc
    return exprs[0] if exprs else Constant(0)
