"""Copy-constraint permutation: union-find cycles -> sparse matrix P, P@Z=Z.

Counterpart of `sirius_tpu/plonk/permutation.py`.  The cycle assembly and
COO matrix are host code on Python ints (the port's own copy of the JAX
package's); the check is a torch gather + row compare: P is a permutation
matrix, so P @ Z == Z <=> Z[idx] == Z.  Z = [instance columns (num_io
lengths) | advice columns (2^k each)], flattened; cells are flat ints
(column_index * n + row).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np
import torch

# Column reference inside the permutation argument: ("instance"|"advice", index)
PermColumn = tuple


@dataclass
class Assembly:
    """Cycle-merging structure (halo2-keygen style union-by-size with
    explicit cycle links; reference `permutation.rs:25-115`)."""

    columns: list[PermColumn]
    n: int
    mapping: list[list[int]]  # flat cells: col_idx * n + row
    aux: list[list[int]]
    sizes: list[list[int]]

    @staticmethod
    def new(columns: Sequence[PermColumn], n: int) -> "Assembly":
        # sort: Fixed < Advice < Instance in the reference ordering; we only
        # allow advice/instance and sort advice-before-instance, by index.
        cols = sorted(columns, key=lambda c: (0 if c[0] == "advice" else 1, c[1]))
        return Assembly(
            columns=list(cols),
            n=n,
            mapping=[list(range(i * n, (i + 1) * n)) for i in range(len(cols))],
            aux=[list(range(i * n, (i + 1) * n)) for i in range(len(cols))],
            sizes=[[1] * n for _ in cols],
        )

    def copy(self, left: PermColumn, left_row: int, right: PermColumn, right_row: int):
        n = self.n
        lc = self.columns.index(left)
        rc = self.columns.index(right)
        left_cycle = self.aux[lc][left_row]
        right_cycle = self.aux[rc][right_row]
        if left_cycle == right_cycle:
            return
        if self.sizes[left_cycle // n][left_cycle % n] < self.sizes[right_cycle // n][right_cycle % n]:
            left_cycle, right_cycle = right_cycle, left_cycle
        self.sizes[left_cycle // n][left_cycle % n] += self.sizes[right_cycle // n][right_cycle % n]
        i = right_cycle
        while True:
            self.aux[i // n][i % n] = left_cycle
            i = self.mapping[i // n][i % n]
            if i == right_cycle:
                break
        self.mapping[lc][left_row], self.mapping[rc][right_row] = (
            self.mapping[rc][right_row],
            self.mapping[lc][left_row],
        )


@dataclass
class PermutationData:
    """Frozen copy graph (reference `permutation.rs:117-146`)."""

    columns: list[PermColumn]
    n: int
    mapping: list[list[int]]

    @staticmethod
    def from_assembly(a: Assembly) -> "PermutationData":
        return PermutationData(list(a.columns), a.n, [list(m) for m in a.mapping])

    def matrix(self, k: int, num_io: Sequence[int], num_advice: int):
        """COO triplets of P (reference `plonk/util.rs:79-152`)."""
        n = self.n
        num_rows = 1 << k
        rows_len = list(num_io) + [num_rows] * num_advice

        def flat_col_offset(col: PermColumn) -> int:
            kind, idx = col
            if kind == "instance":
                return idx
            if kind == "advice":
                return len(num_io) + idx
            raise ValueError(f"fixed column in permutation: {col}")

        # flat Z offsets precomputed per permutation column
        z_col_start = [0]
        for r in rows_len:
            z_col_start.append(z_col_start[-1] + r)
        col_start = [z_col_start[flat_col_offset(c)] for c in self.columns]

        not_in_perm = set(range(len(num_io) + num_advice))
        triplets = []
        for left_idx, mapping_vec in enumerate(self.mapping):
            left_col = self.columns[left_idx]
            not_in_perm.discard(flat_col_offset(left_col))
            inst_rows = num_io[left_col[1]] if left_col[0] == "instance" else None
            left_start = col_start[left_idx]
            for left_row, cell in enumerate(mapping_vec):
                if inst_rows is not None and left_row >= inst_rows:
                    continue
                cyc_col, cyc_row = divmod(cell, n)
                not_in_perm.discard(flat_col_offset(self.columns[cyc_col]))
                triplets.append((left_start + left_row, col_start[cyc_col] + cyc_row, 1))

        for column_offset in not_in_perm:
            col_off = z_col_start[column_offset]
            for row in range(rows_len[column_offset]):
                triplets.append((col_off + row, col_off + row, 1))
        return triplets

    def rm_copy_constraints(self, instance_columns_to_remove: Iterable[int]) -> "PermutationData":
        """Detach given instance columns from all cycles (reference
        `permutation.rs:148-...`): every removed cell becomes a self-cycle and
        is spliced out of its original cycle."""
        n = self.n
        remove = set(instance_columns_to_remove)
        removed_col = [
            c[0] == "instance" and c[1] in remove for c in self.columns
        ]
        mapping = [list(m) for m in self.mapping]

        for ci in range(len(self.columns)):
            if removed_col[ci]:
                continue
            base = ci * n
            for ri in range(len(mapping[ci])):
                # walk past removed cells
                nxt = mapping[ci][ri]
                self_cell = base + ri
                while removed_col[nxt // n] and nxt != self_cell:
                    nxt = self.mapping[nxt // n][nxt % n]
                mapping[ci][ri] = nxt
        for ci in range(len(self.columns)):
            if removed_col[ci]:
                mapping[ci] = list(range(ci * n, (ci + 1) * n))
        return PermutationData(list(self.columns), n, mapping)


def perm_index_vector(triplets: Iterable[tuple[int, int, int]], total: int) -> np.ndarray:
    """COO triplets of P -> idx with (P @ Z)[r] = Z[idx[r]]."""
    idx = np.arange(total, dtype=np.int64)
    for r, c, _v in triplets:
        idx[r] = c
    return idx


def device_perm_mismatches(f, idx, head_ints: Sequence[int], W0_slice: torch.Tensor) -> int:
    """Count of rows with Z[idx] != Z, Z = [encode(head_ints) | W0_slice]
    (both Montgomery, canonical)."""
    dev = W0_slice.device
    head = f.encode([v % f.p for v in head_ints], dev).reshape(len(head_ints), -1)
    Z = torch.cat([head, W0_slice])
    idx_t = torch.as_tensor(idx, dtype=torch.int64, device=dev)
    return int((Z[idx_t] != Z).any(-1).sum())
