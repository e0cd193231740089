"""Merkle-tree update step circuit: the port's own copy of
`sirius_tpu/gadgets/merkle_step_circuit.py` (reference
`examples/merkle_tree_*`: the `MerkleTreeUpdateCircuit` family used by the
merkle examples/benches).

State: z = [root].  Each step applies one deterministic leaf update to a
depth-D Poseidon Merkle tree and proves the transition:

  - witness the authentication path of the updated leaf
  - recompute the OLD root from (old leaf, path) and constrain it == z_i
  - recompute the NEW root from (new leaf, path)  -> z_{i+1}

The tree itself lives on the host (the prover's database); only the path
is witnessed, exactly like the reference's update-proof flow.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..fields.constants import FieldSpec
from ..ops.poseidon import PoseidonHash
from ..util.ro import default_ro_spec
from .main_gate import MainGate, RegionCtx
from .poseidon_chip import PoseidonChip


def hash2(fspec: FieldSpec, l: int, r: int) -> int:
    """H(l, r): Poseidon sponge over two elements (host mirror of the chip)."""
    ro = PoseidonHash(default_ro_spec(fspec))
    ro.absorb_field(l % fspec.modulus)
    ro.absorb_field(r % fspec.modulus)
    return ro.squeeze(fspec.num_bits) % fspec.modulus


class HostMerkleTree:
    """Dense Poseidon Merkle tree on the host (prover database)."""

    def __init__(self, fspec: FieldSpec, depth: int):
        """Sparse: only touched nodes are stored (the reference tree is
        depth 32, `examples/merkle/merkle_tree_gadget/off_circuit.rs:26` —
        a dense level array would need 2^32 entries)."""
        self.fspec = fspec
        self.depth = depth
        self.defaults = [0]
        for d in range(depth):
            self.defaults.append(hash2(fspec, self.defaults[d], self.defaults[d]))
        self.nodes: dict[tuple[int, int], int] = {}

    def node(self, d: int, i: int) -> int:
        return self.nodes.get((d, i), self.defaults[d])

    @property
    def root(self) -> int:
        return self.node(self.depth, 0)

    def path(self, index: int) -> tuple[list[int], list[int]]:
        """(sibling values, path bits) bottom-up for a leaf index."""
        sibs, bits = [], []
        i = index
        for d in range(self.depth):
            sibs.append(self.node(d, i ^ 1))
            bits.append(i & 1)
            i >>= 1
        return sibs, bits

    def update(self, index: int, value: int) -> None:
        self.nodes[(0, index)] = value % self.fspec.modulus
        i = index
        for d in range(self.depth):
            i >>= 1
            self.nodes[(d + 1, i)] = hash2(
                self.fspec, self.node(d, 2 * i), self.node(d, 2 * i + 1)
            )


@dataclass
class MerkleStepCircuit:
    """`batch` leaf updates per step (reference merkle bench sweeps batch
    1..5, `docs/cyclefold_report.md:205-209`); deterministic schedule keyed
    by step count."""

    field_spec: FieldSpec
    depth: int = 8
    arity: int = 1
    batch: int = 1
    _step: int = 0
    _witness: list = field(default_factory=list)
    tree: HostMerkleTree = None

    def __post_init__(self):
        if self.tree is None:
            self.tree = HostMerkleTree(self.field_spec, self.depth)
        if not self._witness:
            # zero witness so structure dry-runs synthesize with real shapes
            self._witness = [
                {
                    "old_leaf": 0, "new_leaf": 0,
                    "sibs": [0] * self.depth, "bits": [0] * self.depth,
                }
                for _ in range(self.batch)
            ]

    def instances(self):
        return []

    def configure(self, cs):
        return MainGate.configure(cs, T=5)

    # -- schedule ----------------------------------------------------------
    def _next_update(self, step: int, j: int) -> tuple[int, int]:
        index = (step * 7 + j * 13 + 3) % (1 << self.depth)
        value = hash2(self.field_spec, 0xBEEF + step, step * self.batch + j)
        return index, value

    def process_step(self, z_i, k_table_size, spec):
        assert z_i[0] % spec.modulus == self.tree.root % spec.modulus, \
            "host tree out of sync with IVC state"
        witness = []
        for j in range(self.batch):
            index, value = self._next_update(self._step, j)
            old_leaf = self.tree.node(0, index)
            sibs, bits = self.tree.path(index)
            self.tree.update(index, value)
            witness.append(
                {"old_leaf": old_leaf, "new_leaf": value, "sibs": sibs, "bits": bits}
            )
        self._witness = witness
        self._step += 1
        return [self.tree.root]

    # -- taped-synthesis dynamic witness (see ivc/step_circuit.py) ----------
    def dynamic_witness(self) -> list:
        out = []
        for w in self._witness:
            out.extend([w["old_leaf"], w["new_leaf"], *w["sibs"], *w["bits"]])
        return out

    def bind_witness(self, vals) -> None:
        d = self.depth
        per = 2 + 2 * d
        if len(vals) != per * self.batch:
            raise ValueError(f"merkle step takes {per * self.batch} dynamic witness values, got {len(vals)}")
        self._witness = [
            {
                "old_leaf": vals[i * per],
                "new_leaf": vals[i * per + 1],
                "sibs": list(vals[i * per + 2 : i * per + 2 + d]),
                "bits": list(vals[i * per + 2 + d : i * per + 2 + 2 * d]),
            }
            for i in range(self.batch)
        ]

    # -- circuit -----------------------------------------------------------
    def _hash2_chip(self, mg, ctx, l, r):
        chip = PoseidonChip(mg, default_ro_spec(self.field_spec))
        chip.absorb_cell(l)
        chip.absorb_cell(r)
        return chip.squeeze(ctx)

    def synthesize_step(self, config, ctx: RegionCtx, z_i):
        mg = MainGate(config, ctx.asn.p)
        root = z_i[0]
        for w in self._witness:
            old = mg.assign_value(ctx, w["old_leaf"])
            new = mg.assign_value(ctx, w["new_leaf"])
            cur_old, cur_new = old, new
            for sib_v, bit_v in zip(w["sibs"], w["bits"]):
                sib = mg.assign_value(ctx, sib_v)
                bit = mg.assign_value(ctx, bit_v)
                mg.assert_bit(ctx, bit)
                for which in ("old", "new"):
                    cur = cur_old if which == "old" else cur_new
                    left = mg.conditional_select(ctx, bit, sib, cur)
                    right = mg.conditional_select(ctx, bit, cur, sib)
                    out = self._hash2_chip(mg, ctx, left, right)
                    if which == "old":
                        cur_old = out
                    else:
                        cur_new = out
            ctx.constrain_equal(cur_old, root)
            root = cur_new
        return [root]
