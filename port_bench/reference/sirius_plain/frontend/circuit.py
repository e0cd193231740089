"""Circuit frontend: a halo2-free constraint-system builder.

The port's own copy of `sirius_tpu/frontend/circuit.py`, with what the
port's paths use (the port imports nothing of the JAX package).

Replaces the reference's use of halo2's `ConstraintSystem`/`Circuit`/
`Assignment` plus `src/table/` (SURVEY.md §2.3 "Table / CircuitRunner").
Idiomatic Python instead of a halo2 port: columns are handles, gates are
built from frontend query expressions, and synthesis writes into a plain
`Assignment` that records advice/fixed/selectors/copies in one pass.

Index space convention matches the reference (`expression.rs:86-102`):
gates reference columns by global flat index [selectors | fixed | advice].
Instance columns never appear in gates — they bind via copy constraints
(equality) only, exactly like the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Protocol, Sequence

from ..poly.expression import Constant, Expression, Poly, Query


@dataclass(frozen=True)
class Column:
    kind: str  # "advice" | "fixed" | "selector" | "instance"
    index: int


class ConstraintSystemBuilder:
    """Collects columns, gates and lookups during `configure`.

    Gates may be registered before all columns exist; queries are symbolic
    (column handle + rotation) and flattened to the global index space at
    `finalize()`.
    """

    def __init__(self):
        self.num_advice = 0
        self.num_fixed = 0
        self.num_selectors = 0
        self.num_instance = 0
        self.instance_lens: list[int] = []
        # gates as (name, [frontend expr]) where frontend exprs embed Column
        self._gates: list[tuple[str, list[Expression]]] = []
        self._lookups: list[tuple[list[Expression], list[Expression]]] = []

    # -- column allocation ------------------------------------------------------
    def advice_column(self) -> Column:
        c = Column("advice", self.num_advice)
        self.num_advice += 1
        return c

    def fixed_column(self) -> Column:
        c = Column("fixed", self.num_fixed)
        self.num_fixed += 1
        return c

    def selector(self) -> Column:
        c = Column("selector", self.num_selectors)
        self.num_selectors += 1
        return c

    def instance_column(self) -> Column:
        c = Column("instance", self.num_instance)
        self.num_instance += 1
        self.instance_lens.append(0)  # grown by assignments
        return c

    # -- symbolic queries -------------------------------------------------------
    def query(self, col: Column, rotation: int = 0) -> Expression:
        """Query a column inside a gate; returns a Poly over a symbolic index
        resolved at finalize (we encode (kind, idx) in the Query.index as a
        tagged tuple understood only by the frontend)."""
        assert col.kind in ("advice", "fixed", "selector"), "instance not queryable"
        return Poly(Query(_SymbolicIndex(col.kind, col.index), rotation))

    def create_gate(self, name: str, exprs: Sequence[Expression]):
        self._gates.append((name, list(exprs)))

    def lookup(self, inputs: Sequence[Expression], table: Sequence[Expression]):
        """Register a (vector) lookup: inputs ⊂ table, both as frontend
        query expressions."""
        self._lookups.append((list(inputs), list(table)))

    # -- finalize ---------------------------------------------------------------
    def flat_index(self, kind: str, idx: int) -> int:
        if kind == "selector":
            return idx
        if kind == "fixed":
            return self.num_selectors + idx
        if kind == "advice":
            return self.num_selectors + self.num_fixed + idx
        raise ValueError(kind)

    def _flatten(self, e: Expression) -> Expression:
        from ..poly.expression import Challenge, Neg, Product, Scaled, Sum

        if isinstance(e, Poly):
            si = e.query.index
            if isinstance(si, _SymbolicIndex):
                return Poly(Query(self.flat_index(si.kind, si.index), e.query.rotation))
            return e
        if isinstance(e, Neg):
            return Neg(self._flatten(e.arg))
        if isinstance(e, Scaled):
            return Scaled(self._flatten(e.arg), e.scalar)
        if isinstance(e, Sum):
            return Sum(self._flatten(e.lhs), self._flatten(e.rhs))
        if isinstance(e, Product):
            return Product(self._flatten(e.lhs), self._flatten(e.rhs))
        return e

    def flat_gates(self) -> list[Expression]:
        return [self._flatten(e) for _, gexprs in self._gates for e in gexprs]

    def flat_lookups(self) -> list[tuple[list[Expression], list[Expression]]]:
        return [
            ([self._flatten(e) for e in inp], [self._flatten(e) for e in tbl])
            for inp, tbl in self._lookups
        ]


@dataclass(frozen=True)
class _SymbolicIndex:
    kind: str
    index: int

    # behave enough like an int for Query hashing/eq
    def __int__(self):
        raise TypeError("symbolic index must be flattened before use")


class TableOverflow(Exception):
    def __init__(self, k, row):
        super().__init__(
            f"circuit needs row {row} but the table has 2^{k} rows — "
            f"increase k (the step-folding circuits need k >= 17)"
        )


class Assignment:
    """Single-pass synthesis sink: advice/fixed/selectors/copies/instances.

    The reference splits this into `CircuitData` (preprocessing) and
    `WitnessCollector` (advice); we record everything and let the runner
    project what it needs.  Values are python ints mod p.
    """

    def __init__(self, cs: ConstraintSystemBuilder, k: int, p: int, instances: Sequence[Sequence[int]]):
        n = 1 << k
        self.cs = cs
        self.k = k
        self.n = n
        self.p = p
        self.advice = [[0] * n for _ in range(cs.num_advice)]
        self.advice_assigned = [[False] * n for _ in range(cs.num_advice)]
        self.fixed = [[0] * n for _ in range(cs.num_fixed)]
        self.selectors = [[False] * n for _ in range(cs.num_selectors)]
        self.instances = [list(inst) for inst in instances]
        self.copies: list[tuple[Column, int, Column, int]] = []

    def assign_advice(self, col: Column, row: int, value: int):
        assert col.kind == "advice"
        if row >= self.n:
            raise TableOverflow(self.k, row)
        self.advice[col.index][row] = value % self.p
        self.advice_assigned[col.index][row] = True

    def assign_fixed(self, col: Column, row: int, value: int):
        assert col.kind == "fixed"
        from .tape import Tr

        if isinstance(value, Tr):
            raise TypeError("fixed column assigned a traced value: circuit structure must not depend on step inputs")
        self.fixed[col.index][row] = value % self.p

    def enable_selector(self, col: Column, row: int):
        assert col.kind == "selector"
        self.selectors[col.index][row] = True


    def copy(self, left: Column, left_row: int, right: Column, right_row: int):
        """Equality constraint between two cells (advice/instance only)."""
        assert left.kind in ("advice", "instance")
        assert right.kind in ("advice", "instance")
        self.copies.append((left, left_row, right, right_row))


class Circuit(Protocol):
    """User circuit protocol (the halo2 `Circuit` analogue)."""

    def configure(self, cs: ConstraintSystemBuilder): ...

    def synthesize(self, config, asn: Assignment) -> None: ...
