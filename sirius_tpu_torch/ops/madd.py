"""B1: the incomplete mixed addition, CUDA kernels + plain torch twins.

Replaces `sirius_tpu/ops/pallas_madd.py:_madd_kernel` (core
`limb_kernels.py:k_madd_incomplete`) and, in `madd_buckets`, the loop of
`sirius_tpu/ops/msm.py:_bucket_totals_onehot_pallas` around it.  Kernels:
`csrc/madd.cu` (design and bounds noted there).

  madd_batch    (n, 8) Jacobian P + affine Q, a lane per point on the
                wide product (rows 16-byte aligned: an unaligned operand
                is copied)
  madd_buckets  msm_many's bucket stage in one launch: (t, n) scalars over
                n points in G groups -> the (t, W, B, G) bucket table, lane
                (t, w, g) adding group g's points into the buckets its
                c-bit digits select, in step order

Each wrapper takes its plain twin for CPU tensors only; for CUDA tensors it
launches its kernel or raises.  `<wrapper>.launches` counts kernel launches
(`madd_buckets` also by curve name in `madd_buckets.curves`).
"""

from __future__ import annotations

import torch

from ..curves.jpoint import Curve, Points
from ..fields.jfield import WORDS
from .limb_kernels import k_madd_incomplete

SCALAR_BITS = 32 * WORDS
MADD_KERNELS = ("madd", "madd_buckets")


def extract_digits(scalars_std: torch.Tensor, c: int) -> torch.Tensor:
    """(..., n, 8) words -> (..., W, n) c-bit windows, W = ceil(256 / c)."""
    W = (SCALAR_BITS + c - 1) // c
    mask = (1 << c) - 1
    out = []
    for w in range(W):
        word, off = divmod(w * c, 32)
        d = scalars_std[..., word] >> off
        if off + c > 32 and word + 1 < WORDS:
            d = d | (scalars_std[..., word + 1] << (32 - off))
        out.append(d & mask)
    return torch.stack(out, -2)


def madd_plain(curve: Curve, P: Points, qx: torch.Tensor, qy: torch.Tensor) -> Points:
    return k_madd_incomplete(curve.limbs, P, qx, qy)


def madd_buckets_plain(curve: Curve, scalars_std: torch.Tensor, px: torch.Tensor, py: torch.Tensor, G: int,
                       c: int) -> Points:
    """The bucket table as the JAX package builds it (`sirius_tpu/ops/msm.py`
    `_bucket_totals_onehot_pallas`): per step, each lane's bucket selected by
    a one-hot multiply-and-sum over the (t, W, G, B) table, one batched madd,
    and a masked write-back; returned as (t, W, B, G, 8)."""
    curve = curve.limbs
    t, n = scalars_std.shape[:2]
    dev = scalars_std.device
    B, g = (1 << c) - 1, n // G
    digits = extract_digits(scalars_std, c)  # (t, W, n)
    W = digits.shape[1]
    dg = digits.reshape(t, W, G, g)
    pxg, pyg = px.reshape(G, g, WORDS), py.reshape(G, g, WORDS)
    vs = torch.arange(1, B + 1, device=dev)
    table = curve.identity((t, W, G, B), dev)
    lanes = t * W * G
    for step in range(g):
        oh = (dg[..., step, None] == vs).unsqueeze(-1)  # (t, W, G, B, 1); none for dead digits
        cur = Points(*((tc * oh).sum(3).reshape(lanes, WORDS) for tc in table))
        qx = pxg[:, step].expand(t, W, G, WORDS).reshape(lanes, WORDS)
        qy = pyg[:, step].expand(t, W, G, WORDS).reshape(lanes, WORDS)
        new = madd_plain(curve, cur, qx, qy)
        table = Points(*(torch.where(oh, nc.reshape(t, W, G, 1, WORDS), tc) for tc, nc in zip(table, new)))
    return Points(*(tc.permute(0, 1, 3, 2, 4).contiguous() for tc in table))


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
    ins = [t.clone() if t.data_ptr() % 16 else t for t in ins]  # the kernel moves rows in 16-byte loads
    out = [torch.empty_like(ins[0]) for _ in range(3)]
    if n:
        _build.launch("madd", ins[0], _build.field_consts(curve.fb), *(t.data_ptr() for t in ins),
                      *(t.data_ptr() for t in out), n)
        madd_batch.launches += 1
    return Points(*out)


def madd_buckets(curve: Curve, scalars_std: torch.Tensor, px: torch.Tensor, py: torch.Tensor, G: int,
                 c: int) -> Points:
    """(t, n, 8) standard-form scalars over the affine points (px, py) (n, 8),
    cut into G groups of n / G -> the (t, W, B, G, 8) Jacobian bucket table
    of c-bit windows (W = ceil(256 / c), B = 2^c - 1, bucket v at index
    v - 1): entry (t, w, v, g) sums group g's points whose digit w of
    scalar t is v, added in point order.  The points must be distinct (the
    commitment-key contract of the incomplete add)."""
    if scalars_std.dim() != 3 or scalars_std.shape[2] != WORDS:
        raise ValueError(f"expected (t, n, {WORDS}) scalars, got {tuple(scalars_std.shape)}")
    t, n = scalars_std.shape[:2]
    for a in (px, py):
        if a.shape != (n, WORDS):
            raise ValueError(f"expected ({n}, {WORDS}) point coordinates, got {tuple(a.shape)}")
    if G < 1 or n % G or not 1 <= c <= 5:
        raise ValueError(f"madd_buckets needs G dividing n = {n} (G = {G}) and 1 <= c <= 5 (c = {c})")
    if scalars_std.device.type == "cpu":
        return madd_buckets_plain(curve, scalars_std, px, py, G, c)
    from . import _build

    ins = [a.contiguous() for a in (scalars_std, px, py)]
    _build.require_cuda(*ins)
    _build.require_aligned(*ins[1:])
    W, B = (SCALAR_BITS + c - 1) // c, (1 << c) - 1
    out = [torch.empty((t, W, B, G, WORDS), dtype=torch.int64, device=px.device) for _ in range(3)]
    if t:
        _build.launch("madd_buckets", px, _build.field_consts(curve.fb), *(a.data_ptr() for a in ins),
                      *(a.data_ptr() for a in out), t, n, W, G, c)
        madd_buckets.launches += 1
        madd_buckets.curves[curve.spec.name] = madd_buckets.curves.get(curve.spec.name, 0) + 1
    return Points(*out)


def madd_kernel_attrs(name: str) -> dict[str, int]:
    """Registers and local (spill) bytes per thread, static shared bytes per
    block, of kernel `name` (one of MADD_KERNELS) as the loaded library was
    built."""
    import ctypes

    from . import _build

    out = (ctypes.c_longlong * 3)()
    _build.check(_build.library().sirius_madd_attrs(MADD_KERNELS.index(name), out), "madd_attrs")
    return {"numRegs": int(out[0]), "localSizeBytes": int(out[1]), "sharedSizeBytes": int(out[2])}


madd_batch.launches = 0
madd_buckets.launches = 0
madd_buckets.curves = {}
