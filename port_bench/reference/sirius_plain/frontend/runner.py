"""CircuitRunner: synthesize a circuit into PlonkStructure + witness.

Counterpart of `sirius_tpu/frontend/runner.py`.  Synthesis itself is host
code on Python ints (`frontend/circuit.py`); this module builds the port's
structure from it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..fields.constants import FieldSpec
from ..plonk.lookup import LookupArguments
from ..plonk.permutation import Assembly, PermutationData
from ..plonk.structure import CompressedGates, PlonkStructure
from ..poly.expression import QueryIndexContext
from .circuit import Assignment, Circuit, ConstraintSystemBuilder


@dataclass
class ConstraintSystemMetainfo:
    num_challenges: int
    round_sizes: list[int]
    gates: list
    custom_gates_lookup_compressed: CompressedGates
    lookup_arguments: Optional[LookupArguments]

    @staticmethod
    def build(k: int, cs: ConstraintSystemBuilder) -> "ConstraintSystemMetainfo":
        lookup_args = LookupArguments.compress_from(cs.flat_lookups())
        num_lookups = lookup_args.num_lookups() if lookup_args else 0
        has_vector = bool(lookup_args and lookup_args.has_vector_lookup)
        lookup_offset = cs.num_selectors + cs.num_fixed + cs.num_advice

        gates = cs.flat_gates()
        if lookup_args:
            gates = gates + lookup_args.to_expressions(lookup_offset)

        n = 1 << k
        if has_vector:
            round_sizes = [cs.num_advice * n, 3 * num_lookups * n, 2 * num_lookups * n]
        elif num_lookups > 0:
            round_sizes = [(cs.num_advice + 3 * num_lookups) * n, 2 * num_lookups * n]
        else:
            round_sizes = [cs.num_advice * n]

        ctx = QueryIndexContext(
            num_selectors=cs.num_selectors,
            num_fixed=cs.num_fixed,
            num_advice=cs.num_advice,
            num_lookups=num_lookups,
            num_challenges=2 if has_vector else (1 if num_lookups > 0 else 0),
        )
        compressed = CompressedGates.new(gates, ctx)
        return ConstraintSystemMetainfo(
            num_challenges=compressed.compressed.num_challenges(),
            round_sizes=round_sizes,
            gates=gates,
            custom_gates_lookup_compressed=compressed,
            lookup_arguments=lookup_args,
        )


class CircuitRunner:
    def __init__(self, k: int, spec: FieldSpec, circuit: Circuit, instances: Sequence[Sequence[int]]):
        self.k = k
        self.spec = spec
        self.circuit = circuit
        self.instances = [list(i) for i in instances]
        self.cs = ConstraintSystemBuilder()
        self.config = circuit.configure(self.cs)
        self._asn: Optional[Assignment] = None

    def _synthesize(self) -> Assignment:
        if self._asn is None:
            asn = Assignment(self.cs, self.k, self.spec.modulus, self.instances)
            self.circuit.synthesize(self.config, asn)
            self._asn = asn
        return self._asn

    def collect_plonk_structure(self) -> PlonkStructure:
        asn = self._synthesize()
        meta = ConstraintSystemMetainfo.build(self.k, self.cs)
        cols_in_copies = set()
        for l, _, r, _ in asn.copies:
            cols_in_copies.add((l.kind, l.index))
            cols_in_copies.add((r.kind, r.index))
        assembly = Assembly.new(sorted(cols_in_copies), 1 << self.k)
        for l, lr, r, rr in asn.copies:
            assembly.copy((l.kind, l.index), lr, (r.kind, r.index), rr)
        return PlonkStructure(
            spec=self.spec,
            k=self.k,
            num_io=[len(inst) for inst in self.instances],
            selectors=np.asarray(asn.selectors, dtype=bool).reshape(self.cs.num_selectors, 1 << self.k),
            fixed_columns=[list(c) for c in asn.fixed],
            num_advice_columns=self.cs.num_advice,
            num_challenges=meta.num_challenges,
            round_sizes=meta.round_sizes,
            custom_gates_lookup_compressed=meta.custom_gates_lookup_compressed,
            gates=meta.gates,
            permutation_data=PermutationData.from_assembly(assembly),
            lookup_arguments=meta.lookup_arguments,
        )

