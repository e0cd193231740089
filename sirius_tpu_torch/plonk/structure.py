"""Plonkish structure: the folding IR of a circuit.

Counterpart of `sirius_tpu/plonk/structure.py`.  Host metadata holds Python
ints; the selector and fixed columns are mirrored on a device as (., n, 8)
Montgomery word tensors, built on first use and cached per device, and
under row blocks (`parallel/rows.py`) per mesh and block, with the halo rows
that the structure's rotations reach.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import Optional, Sequence

import numpy as np
import torch

from ..fields.constants import FieldSpec
from ..fields.jfield import WORDS, Field, field_for, ints_to_words
from ..parallel.mesh import Mesh
from ..poly.expression import Expression, Neg, Poly, Product, QueryIndexContext, Scaled, Sum, compress_expression
from ..poly.grouped import GroupedPoly
from .lookup import LookupArguments
from .permutation import PermutationData


@dataclass
class CompressedGates:
    """compressed -> homogeneous -> (lazy) degree-grouped."""

    compressed: Expression
    homogeneous: Expression
    homogeneous_degree: int
    ctx: QueryIndexContext
    _grouped: Optional[GroupedPoly] = None

    @staticmethod
    def new(original: Sequence[Expression], ctx: QueryIndexContext) -> "CompressedGates":
        compressed = compress_expression(list(original), ctx.num_challenges)
        ctx = ctx.with_challenges(compressed.num_challenges())
        hom = compressed.homogeneous(ctx)
        ctx = ctx.with_challenges(hom.expr.num_challenges())
        return CompressedGates(compressed, hom.expr, hom.degree, ctx)

    @property
    def grouped(self) -> GroupedPoly:
        if self._grouped is None:
            self._grouped = GroupedPoly.new(self.homogeneous, self.ctx)
        return self._grouped


@dataclass
class PlonkStructure:
    spec: FieldSpec  # scalar field of the commitment curve
    k: int
    num_io: list[int]
    selectors: np.ndarray  # bool (num_selectors, 2^k)
    fixed_columns: list[list[int]]  # (num_fixed, 2^k) host ints
    num_advice_columns: int
    num_challenges: int
    round_sizes: list[int]
    custom_gates_lookup_compressed: CompressedGates
    gates: list[Expression]
    permutation_data: PermutationData
    lookup_arguments: Optional[LookupArguments]
    # per-device column mirrors and derived check data, built on first use
    cache: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def n(self) -> int:
        return 1 << self.k

    def num_lookups(self) -> int:
        return 0 if self.lookup_arguments is None else len(self.lookup_arguments.lookup_polys)

    def has_vector_lookup(self) -> bool:
        return bool(self.lookup_arguments and self.lookup_arguments.has_vector_lookup)

    def num_fold_vars(self) -> int:
        return self.num_advice_columns + 5 * self.num_lookups()

    def get_degree_for_folding(self) -> int:
        return len(self.custom_gates_lookup_compressed.grouped)

    @property
    def query_index_ctx(self) -> QueryIndexContext:
        return QueryIndexContext(
            num_selectors=self.selectors.shape[0],
            num_fixed=len(self.fixed_columns),
            num_advice=self.num_advice_columns,
            num_challenges=self.num_challenges,
            num_lookups=self.num_lookups(),
        )

    def permutation_matrix(self):
        """COO triplets of P with P @ Z = Z over Z = [instances | advice]."""
        return self.permutation_data.matrix(self.k, self.num_io, self.num_advice_columns)

    @cached_property
    def field(self) -> Field:
        return field_for(self.spec)

    def selectors_on(self, device) -> torch.Tensor:
        """(num_selectors, n, 8) Montgomery 0/1 columns on `device`."""
        key = ("sel", str(torch.device(device)))
        if key not in self.cache:
            out = torch.zeros((self.selectors.shape[0], self.n, WORDS), dtype=torch.int64)
            out[torch.from_numpy(self.selectors)] = torch.tensor(self.field.one_mont_words)
            self.cache[key] = out.to(device)
        return self.cache[key]

    def fixed_on(self, device) -> torch.Tensor:
        """(num_fixed, n, 8) Montgomery fixed columns on `device`."""
        key = ("fixed", str(torch.device(device)))
        if key not in self.cache:
            f = self.field
            flat = [v * (1 << 256) % f.p for col in self.fixed_columns for v in col]
            arr = ints_to_words(flat).reshape(len(self.fixed_columns), self.n, WORDS)
            self.cache[key] = torch.from_numpy(arr).to(device)
        return self.cache[key]

    def halo(self) -> tuple[int, int]:
        """(lo, hi): the most rows any query of the structure reaches before
        (rotation -lo) and after (rotation +hi) its own, over the gates, the
        compressed gate and the lookup expressions."""
        if "halo" not in self.cache:
            exprs = [*self.gates, self.custom_gates_lookup_compressed.compressed,
                     self.custom_gates_lookup_compressed.homogeneous]
            if self.lookup_arguments is not None:
                exprs += [*self.lookup_arguments.lookup_polys, *self.lookup_arguments.table_polys]
            lo = hi = 0
            seen, stack = set(), list(exprs)
            while stack:
                e = stack.pop()
                if id(e) in seen:
                    continue
                seen.add(id(e))
                if isinstance(e, Poly):
                    lo, hi = max(lo, -e.query.rotation), max(hi, e.query.rotation)
                elif isinstance(e, (Neg, Scaled)):
                    stack.append(e.arg)
                elif isinstance(e, (Sum, Product)):
                    stack += [e.lhs, e.rhs]
            self.cache["halo"] = (lo, hi)
        return self.cache["halo"]

    def columns_block(self, mesh: Mesh, d: int, lo: int, hi: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The selector and fixed columns on row block d of `mesh` with `lo`
        and `hi` halo rows, cyclic: (num_selectors, lo + n / D + hi, 8) and
        (num_fixed, .., 8) Montgomery words on the block's device, cut from
        the host mirrors (`selectors_on`, `fixed_on`) once per (mesh, block,
        halo)."""
        key = ("columns_block", mesh, d, lo, hi)
        if key not in self.cache:
            nb = self.n // mesh.size
            rows = torch.arange(d * nb - lo, (d + 1) * nb + hi) % self.n
            dev = mesh.devices[d]
            self.cache[key] = (self.selectors_on("cpu")[:, rows].to(dev), self.fixed_on("cpu")[:, rows].to(dev))
        return self.cache[key]


@dataclass
class PlonkInstance:
    W_commitments: list  # host gold affine points
    instances: list[list[int]]
    challenges: list[int]

    def clone(self) -> "PlonkInstance":
        return PlonkInstance(list(self.W_commitments), [list(i) for i in self.instances], list(self.challenges))


@dataclass
class PlonkWitness:
    """Per-round witnesses: W[i] is a (round_size, 8) Montgomery tensor, the
    column-major concatenation of padded columns."""

    W: list[torch.Tensor]

    @staticmethod
    def zeros(f: Field, round_sizes: Sequence[int], device=None, n: Optional[int] = None) -> "PlonkWitness":
        """Zero rounds on `device`; given the table rows n, as row blocks under
        the row mesh of n (`parallel/rows.zero_round`)."""
        if n is None:
            return PlonkWitness([f.zeros((sz,), device) for sz in round_sizes])
        from ..parallel.rows import zero_round

        return PlonkWitness([zero_round(f, sz, n, device) for sz in round_sizes])


@dataclass
class PlonkTrace:
    u: PlonkInstance
    w: PlonkWitness
