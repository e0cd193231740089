"""The multi-device layer: a 1-D `rows` mesh of devices (`mesh.py`) and the
process-wide active mesh that switches the commitments to their sharded
variant (`context.py`).  Counterpart of `sirius_tpu/parallel/`."""

from .context import get_mesh, mesh_context, set_mesh
from .mesh import ROWS_AXIS, Mesh, gather_rows, make_mesh, row_blocks, shard_rows

__all__ = ["ROWS_AXIS", "Mesh", "gather_rows", "get_mesh", "make_mesh", "mesh_context", "row_blocks", "set_mesh",
           "shard_rows"]
