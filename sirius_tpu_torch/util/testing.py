"""Test doubles and references.

MockCommitmentKey: a homomorphic but non-binding commitment,
commit(w) = (sum_i w_i) * G, the same double as
`sirius_tpu/util/testing.py`.  Linear like a Pedersen commitment, so every
folding identity holds bit for bit without MSM cost.  Tests only.

reference_msm: the big-integer model MSM (`sirius_tpu/fields/gold.py`), the
reference the MSM kernels are held to.

Lookup circuits, copies of the JAX package's test circuits with their sizes
as constructor arguments (there module constants):
- RangeCircuit (`tests/test_lookup.py:38-64`, K and TABLE): a scalar lookup
  of one advice column in a fixed column row % table (a 2-round SPS);
- VectorRangeCircuit (`tests/test_lookup.py:67-97`): the pairs
  (i, i^2 mod table) in a 2-column table (a 3-round SPS);
- FiboXorLookupCircuit (`tests/fixtures.py:103-166`, XOR_BITS): a
  Fibonacci-XOR chain whose rows (a, b, a ^ b) are looked up in the
  3-column XOR table of xor_bits-bit values (a 3-round SPS); at
  xor_bits = 3 it is `__graft_entry__.py:_XorLookupFixture`.

dryrun_sangria_folds: the Sangria half of the JAX package's multi-device
dry run (`__graft_entry__.py:dryrun_multichip`) on a given key, under
whatever mesh is active.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..curves.jpoint import Curve
from ..fields import gold
from ..parallel.rows import RowBlocks
from .device import resolve


@dataclass
class MockCommitmentKey:
    curve: Curve
    device: torch.device | str | None = None  # None: the CUDA device
    max_len: int = 1 << 40

    def __post_init__(self):
        self.device = resolve(self.device)

    def __len__(self):
        return self.max_len

    def commit_device(self, w_mont):
        """sum(w) G; row blocks (`parallel/rows.py`) sum block by block."""
        f = self.curve.fs
        if isinstance(w_mont, RowBlocks):
            s = sum(f.decode_one(f.sum_reduce(b)) for b in w_mont.blocks) % f.p
        else:
            s = f.decode_one(f.sum_reduce(w_mont)) if w_mont.shape[0] else 0
        return gold.generator(self.curve.spec).mul(s)

    def commit_device_many(self, w_monts):
        return [self.commit_device(w) for w in w_monts]

    def batched_commit_check(self, pairs) -> list[int]:
        """The indices of the (W, C) pairs with commit(W) != C, one by one."""
        return [i for i, (W, C) in enumerate(pairs) if self.commit_device(W) != C]

    def commit(self, v_ints):
        s = sum(v % self.curve.fs.p for v in v_ints) % self.curve.fs.p
        return gold.generator(self.curve.spec).mul(s)


def reference_msm(scalars: list[int], points: list[gold.AffinePoint]) -> gold.AffinePoint:
    """sum_i s_i * P_i on host integers (slow: ~20 ms per 254-bit scalar)."""
    return gold.msm(scalars, points)


class RangeCircuit:
    """Every advice value must lie in the fixed table {0..table-1}, written
    as row % table over all 2^k rows (the copies past the first earn no
    counts)."""

    def __init__(self, values, k: int = 5, table: int = 16):
        self.values, self.k, self.table = list(values), k, table

    def configure(self, cs):
        a = cs.advice_column()
        t = cs.fixed_column()
        inst = cs.instance_column()
        cs.lookup([cs.query(a)], [cs.query(t)])
        s = cs.selector()
        cs.create_gate("noop", [cs.query(s) * (cs.query(a) - cs.query(a))])
        return (a, t, inst)

    def synthesize(self, config, asn):
        a, t, inst = config
        for row in range(1 << self.k):
            asn.assign_fixed(t, row, row % self.table)
        for row, v in enumerate(self.values):
            asn.assign_advice(a, row, v)
        asn.copy(a, 0, inst, 0)

    def instances(self):
        return [[self.values[0], 0]]


class VectorRangeCircuit:
    """The pairs (a, b) = (i, i^2 mod table) must appear in the fixed table
    of pairs (row % table, (row % table)^2 mod table)."""

    def __init__(self, values, k: int = 5, table: int = 16):
        self.values, self.k, self.table = list(values), k, table

    def configure(self, cs):
        a = cs.advice_column()
        b = cs.advice_column()
        t1 = cs.fixed_column()
        t2 = cs.fixed_column()
        inst = cs.instance_column()
        cs.lookup([cs.query(a), cs.query(b)], [cs.query(t1), cs.query(t2)])
        s = cs.selector()
        cs.create_gate("noop", [cs.query(s) * (cs.query(a) - cs.query(a))])
        return (a, b, t1, t2, inst)

    def synthesize(self, config, asn):
        a, b, t1, t2, inst = config
        T = self.table
        for row in range(1 << self.k):
            i = row % T
            asn.assign_fixed(t1, row, i)
            asn.assign_fixed(t2, row, i * i % T)
        for row, v in enumerate(self.values):
            asn.assign_advice(a, row, v % T)
            asn.assign_advice(b, row, (v % T) ** 2 % T)
        asn.copy(a, 0, inst, 0)

    def instances(self):
        return [[self.values[0] % self.table, 0]]


class FiboXorLookupCircuit:
    """Each row proves c = a XOR b with (a, b, c) looked up in a fixed
    3-column table of xor_bits-bit values; the chain gate moves (b, c) to
    the next row's (a, b).  Rows past the table's 4^xor_bits are (0, 0, 0)."""

    def __init__(self, a: int, b: int, num: int, xor_bits: int = 2):
        self.a, self.b, self.num, self.xor_bits = a, b, num, xor_bits

    def configure(self, cs):
        col_a = cs.advice_column()
        col_b = cs.advice_column()
        col_c = cs.advice_column()
        s = cs.selector()
        t_a = cs.fixed_column()
        t_b = cs.fixed_column()
        t_c = cs.fixed_column()
        inst = cs.instance_column()
        sq = cs.query(s)
        cs.lookup([sq * cs.query(col_a), sq * cs.query(col_b), sq * cs.query(col_c)],
                  [cs.query(t_a), cs.query(t_b), cs.query(t_c)])
        a2, b2 = cs.query(col_a, 1), cs.query(col_b, 1)
        cs.create_gate("xor-chain", [sq * (a2 - cs.query(col_b)), sq * (b2 - cs.query(col_c))])
        return (col_a, col_b, col_c, s, t_a, t_b, t_c, inst)

    def _seq(self):
        mask = (1 << self.xor_bits) - 1
        a, b = self.a & mask, self.b & mask
        rows = []
        for _ in range(self.num):
            c = a ^ b
            rows.append((a, b, c))
            a, b = b, c
        return rows

    def synthesize(self, config, asn):
        col_a, col_b, col_c, s, t_a, t_b, t_c, inst = config
        n = 1 << self.xor_bits
        for x in range(n):
            for y in range(n):
                row = x * n + y
                asn.assign_fixed(t_a, row, x)
                asn.assign_fixed(t_b, row, y)
                asn.assign_fixed(t_c, row, x ^ y)
        rows = self._seq()
        for idx, (a, b, c) in enumerate(rows):
            if idx + 1 < len(rows):
                asn.enable_selector(s, idx)
            asn.assign_advice(col_a, idx, a)
            asn.assign_advice(col_b, idx, b)
            asn.assign_advice(col_c, idx, c)
        asn.copy(col_c, len(rows) - 1, inst, 0)

    def instances(self) -> list[list[int]]:
        return [[self._seq()[-1][2], 0]]


def dryrun_sangria_folds(ck) -> tuple[list[str], list, object]:
    """`__graft_entry__.py:dryrun_multichip`'s Sangria folds on the key `ck`
    (there `CommitmentKey.setup(BN256_G1, 9, b"dryrun-mc")`) and its
    device: the XOR chains FiboXorLookupCircuit(1, 2, 9) and (3, 5, 9) at
    3-bit XOR and k = 6 (a 3-round SPS), both traces on one transcript,
    folded one after the other into the zero relaxed accumulator with the
    verifier replaying each fold.  Returns `golden.sangria_acc_digest` after
    each fold, is_sat's errors on the final accumulator and that
    accumulator (row blocks under the row mesh of k, `parallel/rows.py`)."""
    from ..fields.constants import bn256_fq, bn256_fr, bn256_g1
    from ..frontend.runner import CircuitRunner
    from ..nifs.sangria import RelaxedPlonkInstance, RelaxedPlonkTrace, RelaxedPlonkWitness, VanillaFS
    from ..ops.poseidon import PoseidonHash, poseidon_spec
    from ..plonk.sps import run_sps_protocol
    from .golden import sangria_acc_digest

    k, dev = 6, ck.device
    ro = lambda: PoseidonHash(poseidon_spec(bn256_fq, 3, 2, 4, 3))  # noqa: E731
    circuits = [FiboXorLookupCircuit(1, 2, 9, xor_bits=3), FiboXorLookupCircuit(3, 5, 9, xor_bits=3)]
    runners = [CircuitRunner(k, bn256_fr, c, c.instances()) for c in circuits]
    S = runners[0].collect_plonk_structure()
    ro_gen = ro()
    traces = [run_sps_protocol(S, ck, c.instances(), r.collect_witness(), ro_gen)
              for c, r in zip(circuits, runners)]
    pp, vp = VanillaFS.setup_params(gold.identity(bn256_g1), S)
    acc = RelaxedPlonkTrace(
        U=RelaxedPlonkInstance.new(bn256_g1, S.num_challenges, len(S.round_sizes), len(S.num_io) - 1),
        W=RelaxedPlonkWitness.zeros(S.field, S.round_sizes, S.n, dev))
    ro_nark_v, ro_acc_p, ro_acc_v = ro(), ro(), ro()
    digests = []
    for tr in traces:
        new_acc, cross_commits = VanillaFS.prove(ck, pp, ro_acc_p, acc, tr)
        if VanillaFS.verify(vp, bn256_g1, ro_nark_v, ro_acc_v, acc.U, tr.u, cross_commits) != new_acc.U:
            raise AssertionError("prover/verifier accumulator mismatch")
        acc = new_acc
        digests.append(sangria_acc_digest(acc.U))
    return digests, VanillaFS.is_sat(ck, S, acc, [tr.u.instances for tr in traces]), acc
