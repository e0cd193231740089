"""B1: batched incomplete mixed addition, CUDA kernel + plain torch twin.

Replaces `sirius_tpu/ops/pallas_madd.py:_madd_kernel` (core
`limb_kernels.py:k_madd_incomplete`).  Kernel: `csrc/madd.cu`, one thread
per point, integer-multiply bound (see the note there).

`madd_batch` takes its plain twin for CPU tensors only; for CUDA tensors it
launches the kernel or raises.  `madd_batch.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from ..curves.jpoint import Curve, Points
from .limb_kernels import k_madd_incomplete


def madd_plain(curve: Curve, P: Points, qx: torch.Tensor, qy: torch.Tensor) -> Points:
    return k_madd_incomplete(curve, P, qx, qy)


def madd_batch(curve: Curve, P: Points, qx: torch.Tensor, qy: torch.Tensor) -> Points:
    """P + Q for (n, 8) Jacobian P (may be the identity) and affine Q
    (not the identity, != +-P)."""
    n = P.x.shape[0]
    for t in (*P, qx, qy):
        if t.shape != (n, 8):
            raise ValueError(f"expected ({n}, 8) operands, got {tuple(t.shape)}")
    if P.x.device.type == "cpu":
        return madd_plain(curve, P, qx, qy)
    from . import _build

    ins = [t.contiguous() for t in (*P, qx, qy)]
    _build.require_cuda(*ins)
    out = [torch.empty_like(ins[0]) for _ in range(3)]
    if n:
        lib = _build.library()
        err = lib.sirius_madd(_build.field_consts(curve.fb), *(t.data_ptr() for t in ins),
                              *(t.data_ptr() for t in out), n, _build.stream_of(ins[0]))
        _build.check(err, "madd")
        madd_batch.launches += 1
    return Points(*out)


madd_batch.launches = 0
