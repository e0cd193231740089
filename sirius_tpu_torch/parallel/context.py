"""The active mesh: opt-in multi-device execution of the protocol paths.

Counterpart of `sirius_tpu/parallel/context.py`.  A process-wide active
mesh switches the protocol paths to their sharded variant without
threading a mesh argument through every protocol call.  Under a mesh of D
entries, where D > 1 divides a circuit's n = 2^k rows:

- sharded, as row blocks (`rows.RowBlocks`: block d holds rows
  [d n / D, (d + 1) n / D) of every column, on `mesh.devices[d]`): every
  SPS round (a replayed witness uploaded and converted block by block),
  the lookup rounds, E and the cross terms; the gate and lookup sweeps
  (each block with the halo rows of its rotations); the ProtoGalaxy pow
  reduce up to each block's subtrees; both folds; the commitments of a
  round (`msm_sharded`, block d's scalars against the key points of its
  rows); the gate and accumulation checks (counts added) and the
  log-derivative sums (block sums added);
- gathered to the mesh's first device: the ProtoGalaxy partial
  polynomials (the tree's upper levels finish there), l and t for one
  `m_count` (m goes back as row blocks), W0's advice columns for the
  permutation checks, the cross terms for their commitment on the key's
  device, and every round a checkpoint or a digest reads.

Where D does not divide n, the rounds stay whole on the key's device
(`rows.WHOLE_ROUND_FALLBACK`, logged once) and only the commitments shard
(`CommitmentKey.commit_device` through `ops/msm.msm_sharded`), as the JAX
package keeps an array whole when its rows do not divide.  The JAX package
places rounds as contiguous chunks of the flat array and lets GSPMD spread
the jitted sweeps (halo exchanges for rotations, psums for reductions);
the port has no GSPMD, so its row blocks and their halos are explicit.
The Poseidon transcript always stays on the host, so absorb and squeeze
order do not depend on the device count.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Optional

from .mesh import Mesh

_ACTIVE_MESH: Optional[Mesh] = None


def get_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


@contextmanager
def mesh_context(mesh: Mesh) -> Iterator[Mesh]:
    """Make `mesh` the active mesh inside the block; the previous one comes
    back when the block is left, by an exception too."""
    prev = get_mesh()
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)
