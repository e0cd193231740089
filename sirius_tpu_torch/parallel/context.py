"""The active mesh: opt-in multi-device execution of the protocol paths.

Counterpart of `sirius_tpu/parallel/context.py`.  A process-wide active
mesh switches the commitments to their sharded variant without threading
a mesh argument through every protocol call: under a mesh of more than one
entry, `CommitmentKey.commit_device` (and `batched_commit_check` through
it) goes through `ops/msm.msm_sharded`, each device running the MSM kernels
on its row block of scalars and key points.

The JAX package also places the SPS witness row-sharded and gives the
Sangria fold and the permutation check explicit GSPMD shardings
(`row_sharding`, `replicated_sharding` there), so that XLA spreads the gate
sweeps and inserts the halo exchanges for rotations.  The port has no GSPMD
and no such functions: what takes their place is explicit row blocks
(`mesh.shard_rows`) where a kernel runs per shard, and the mesh's first
device for everything else.  The sweeps (plain torch) stay on the device
that holds W; sharding them with halo rows for rotations waits for them to
become device programs.  The Poseidon transcript always stays on the host,
so absorb and squeeze order do not depend on the device count.
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
