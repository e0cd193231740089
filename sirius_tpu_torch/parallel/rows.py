"""A witness round cut by table rows over a mesh: the row-sharded sweeps.

A round of `cols` columns of n table rows is, unsharded, one column-major
(cols * n, 8) Montgomery tensor.  Under an active mesh of D entries, where
D > 1 divides n (so D is a power of two), the SPS places it as D row
blocks (`RowBlocks`): block d holds rows [d * n / D, (d + 1) * n / D) of
every column of the round, column-major within the block, on
`mesh.devices[d]`.  E and the cross terms are rounds of one column.

This is not how the JAX package cuts a round: `sirius_tpu/plonk/sps.py:72-75`
cuts the flat array into D contiguous chunks (whole columns on one device
at 4 shards of a 7-column round), and GSPMD moves rows as the jitted
sweeps need them.  The port has no GSPMD, so it cuts by table rows: a gate
sweep of block d reads only its own block plus the halo rows of its cyclic
neighbours that its rotations reach (`window`), every elementwise op
(the folds) runs block by block with no copy between devices, and a
commitment pairs block d's scalars with the key points of its rows
(`CommitmentKey.row_shards`).

For any other mesh (D does not divide n) a round stays whole on the key's
device, as the JAX package keeps an array whole when its rows do not
divide (`sps.py:72`); the commitments still go through `msm_sharded`.
`row_mesh` names that fallback (`WHOLE_ROUND_FALLBACK`) and logs it once
per (mesh, n).  Without an active mesh nothing here runs: a round is a
plain tensor and every sweep takes the single-device code.
"""

from __future__ import annotations

import logging
from collections import Counter
from typing import Callable, Optional, Sequence

import torch

from ..fields.jfield import WORDS
from .context import get_mesh
from .mesh import Mesh, gather_rows

WHOLE_ROUND_FALLBACK = "whole-round fallback"

log = logging.getLogger(__name__)
_logged: set = set()

# per-block sweeps by device (`plonk/eval.PlonkEvalDomain`): what a mesh ran where
sweeps: Counter = Counter()


def row_mesh(n: int) -> Optional[Mesh]:
    """The active mesh when rounds of n table rows are cut into row blocks
    over it: more than one entry, dividing n.  None without a mesh, for a
    mesh of one entry, and for the whole-round fallback (logged once per
    mesh and n)."""
    mesh = get_mesh()
    if mesh is None or mesh.size == 1:
        return None
    if n % mesh.size:
        if (mesh, n) not in _logged:
            _logged.add((mesh, n))
            log.warning("%s: %d table rows do not divide over %s; each round stays whole on the key's device, its "
                        "commitment still sharded", WHOLE_ROUND_FALLBACK, n, mesh.describe())
        return None
    return mesh


class RowBlocks:
    """A round of `cols` columns of n table rows as the mesh's row blocks:
    `blocks[d]` is the (cols * n / D, 8) column-major block of rows
    [d * n / D, (d + 1) * n / D) on `mesh.devices[d]`."""

    __slots__ = ("mesh", "n", "cols", "blocks")

    def __init__(self, mesh: Mesh, n: int, cols: int, blocks: Sequence[torch.Tensor]):
        if n % mesh.size or len(blocks) != mesh.size:
            raise ValueError(f"{len(blocks)} blocks of {n} rows for {mesh.describe()}")
        self.mesh, self.n, self.cols, self.blocks = mesh, n, cols, list(blocks)

    @property
    def nb(self) -> int:
        """Table rows a block."""
        return self.n // self.mesh.size

    @property
    def devices(self) -> list[torch.device]:
        return [b.device for b in self.blocks]

    def __repr__(self):
        return f"RowBlocks({self.cols} x {self.n} rows on {self.mesh.describe()})"

    @staticmethod
    def shard(mesh: Mesh, x: torch.Tensor, n: int) -> "RowBlocks":
        """A column-major (cols * n, 8) tensor cut by table rows."""
        cols, nb = x.shape[0] // n, n // mesh.size
        if cols * n != x.shape[0]:
            raise ValueError(f"a round of {x.shape[0]} rows is no whole number of {n}-row columns")
        by_col = x.reshape(cols, n, WORDS)
        return RowBlocks(mesh, n, cols, [by_col[:, d * nb : (d + 1) * nb].reshape(-1, WORDS).to(dev)
                                         for d, dev in enumerate(mesh.devices)])

    @staticmethod
    def zeros(field, mesh: Mesh, n: int, cols: int) -> "RowBlocks":
        nb = n // mesh.size
        return RowBlocks(mesh, n, cols, [field.zeros((cols * nb,), dev) for dev in mesh.devices])

    def gather(self, cols: Optional[int] = None, device=None) -> torch.Tensor:
        """The first `cols` columns (all by default) as the unsharded
        column-major tensor on `device` (the mesh's first by default): the
        blocks joined by `gather_rows` along the row axis, word for word the
        round a single device holds."""
        cols = self.cols if cols is None else cols
        nb = self.nb
        parts = [b[: cols * nb].reshape(cols, nb, WORDS) for b in self.blocks]
        out = gather_rows(self.mesh, parts, axis=1).reshape(cols * self.n, WORDS)
        return out if device is None else out.to(device)

    def column(self, slot: int) -> list[torch.Tensor]:
        """Column `slot`: one (n / D, 8) view a block."""
        nb = self.nb
        return [b[slot * nb : (slot + 1) * nb] for b in self.blocks]

    def _rows(self, slot: int, start: int, count: int, device) -> torch.Tensor:
        """Table rows [start, start + count) mod n of column `slot`, copied
        from the blocks that hold them to `device`."""
        nb, parts, pos = self.nb, [], start % self.n
        while count:
            d, off = divmod(pos, nb)
            take = min(count, nb - off)
            parts.append(self.blocks[d][slot * nb + off : slot * nb + off + take].to(device))
            count -= take
            pos = (pos + take) % self.n
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def window(self, slot: int, d: int, lo: int, hi: int) -> torch.Tensor:
        """Block d's rows of column `slot` with `lo` halo rows before and `hi`
        after, cyclic over the n rows: (lo + n / D + hi, 8) on block d's
        device.  Row i + lo + rot of it is table row s_d + i + rot."""
        nb, dev = self.nb, self.blocks[d].device
        parts = [self.blocks[d][slot * nb : (slot + 1) * nb]]
        if lo:
            parts.insert(0, self._rows(slot, d * nb - lo, lo, dev))
        if hi:
            parts.append(self._rows(slot, (d + 1) * nb, hi, dev))
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    @staticmethod
    def cat(parts: Sequence["RowBlocks"]) -> "RowBlocks":
        """Rounds joined column after column (`torch.cat` of the unsharded
        tensors): block by block."""
        first = parts[0]
        return RowBlocks(first.mesh, first.n, sum(p.cols for p in parts),
                         [torch.cat(bs) for bs in zip(*(p.blocks for p in parts))])


def blockwise(fn: Callable, *args):
    """fn applied block by block: each RowBlocks argument gives its block d,
    a plain tensor is first cut like the first RowBlocks argument (its
    table rows), any other argument passes as it is; the result's columns
    follow from the blocks fn returns.  Without a RowBlocks argument, fn(*args)
    itself: no copy and no launch of its own."""
    like = next((a for a in args if isinstance(a, RowBlocks)), None)
    if like is None:
        return fn(*args)
    mesh, n = like.mesh, like.n
    args = [RowBlocks.shard(mesh, a, n) if isinstance(a, torch.Tensor) and a.dim() == 2 and a.shape[0] >= n else a
            for a in args]
    outs = [fn(*(a.blocks[d] if isinstance(a, RowBlocks) else a for a in args)) for d in range(mesh.size)]
    return RowBlocks(mesh, n, outs[0].shape[0] // like.nb, outs)


def place(x: torch.Tensor, n: int):
    """A round of n-row columns as row blocks under the row mesh of n
    (`row_mesh`), else unchanged."""
    mesh = row_mesh(n)
    return x if mesh is None or isinstance(x, RowBlocks) else RowBlocks.shard(mesh, x, n)


def zero_round(field, size: int, n: int, device):
    """A zero round of `size` elements (size / n columns): row blocks under
    the row mesh of n, else one tensor on `device`."""
    mesh = row_mesh(n)
    return field.zeros((size,), device) if mesh is None else RowBlocks.zeros(field, mesh, n, size // n)


def expanded(x, n: int):
    """An evaluator output over all n rows (`PlonkEvalDomain.evaluate`): a
    tensor, a constant's (8,) included, as an (n, 8) view; row blocks, which
    already hold n / D rows a block, as they are."""
    return x if isinstance(x, RowBlocks) else x.expand(n, WORDS)


def blocks_of(x) -> list[torch.Tensor]:
    """A round's blocks: RowBlocks' own, a tensor as its one block."""
    return x.blocks if isinstance(x, RowBlocks) else [x]


def gathered(x, device=None) -> torch.Tensor:
    """A round as one tensor: RowBlocks gathered (to `device`, the mesh's
    first by default), a tensor as it is."""
    return x.gather(device=device) if isinstance(x, RowBlocks) else x


def leading(x, cols: int, n: int) -> torch.Tensor:
    """A round's first `cols` columns of n rows as one tensor: gathered to
    the mesh's first device for row blocks, a view of a tensor."""
    return x.gather(cols) if isinstance(x, RowBlocks) else x[: cols * n]


def home(x) -> torch.device:
    """The device of a round's host-side scalars: a tensor's own, the mesh's
    first for row blocks."""
    return x.mesh.first if isinstance(x, RowBlocks) else x.device


def cat(parts):
    """`torch.cat` of rounds, block by block for row blocks."""
    return RowBlocks.cat(parts) if isinstance(parts[0], RowBlocks) else torch.cat(parts)
