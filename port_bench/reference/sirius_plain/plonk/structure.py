"""Plonkish structure: the folding IR of a circuit.

Counterpart of `sirius_tpu/plonk/structure.py`.  Host metadata holds Python
ints; the selector and fixed columns are mirrored on a device as (., n, 8)
Montgomery word tensors, built on first use and cached per device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import Optional, Sequence

import numpy as np
import torch

from ..fields.constants import FieldSpec
from ..fields.jfield import WORDS, Field, field_for, ints_to_words
from ..poly.expression import Expression, QueryIndexContext, compress_expression
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


@dataclass
class PlonkTrace:
    u: PlonkInstance
    w: PlonkWitness
