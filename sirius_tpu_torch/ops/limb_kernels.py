"""Field and point primitives shared by the hand-written kernels.

Counterpart of `sirius_tpu/ops/limb_kernels.py`.  The `__device__` versions
live in `csrc/field.cuh` (`fe_add`, `fe_sub`, `fe_mul`: 8x32-bit CIOS) and
`csrc/curve.cuh` (`pt_dbl_ilp`, `pt_add_ilp`, `pt_madd`, `pt_madd_wide`, `fe_is_zero`,
`fe_select`).  Their plain torch twins, the reference each kernel is held
against, are the port's field and curve methods, named here after the JAX
functions; the point ones take the `Curve` context first.
"""

from __future__ import annotations

from ..curves.jpoint import Curve
from ..fields.jfield import Field

k_is_zero = Field.is_zero
k_select = Field.select
k_dbl = Curve.dbl  # dbl-2009-l
k_add_complete = Curve.add  # general formula + selects over the exceptional cases
k_madd_incomplete = Curve.add_mixed_fast  # madd-2007-bl: Q affine, not the identity, Q != +-P
