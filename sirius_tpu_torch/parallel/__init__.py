"""The multi-device layer: a 1-D `rows` mesh of devices (`mesh.py`), the
process-wide active mesh that switches the protocol paths to their sharded
variant (`context.py`) and the witness rounds cut by table rows over it
(`rows.py`).  Counterpart of `sirius_tpu/parallel/`."""

from .context import get_mesh, mesh_context, set_mesh
from .mesh import ROWS_AXIS, Mesh, gather_rows, make_mesh, row_blocks, shard_rows
from .rows import WHOLE_ROUND_FALLBACK, RowBlocks, row_mesh

__all__ = ["ROWS_AXIS", "WHOLE_ROUND_FALLBACK", "Mesh", "RowBlocks", "gather_rows", "get_mesh", "make_mesh",
           "mesh_context", "row_blocks", "row_mesh", "set_mesh", "shard_rows"]
