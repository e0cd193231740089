"""B2 + B3 + S1: the Pippenger MSM kernels, CUDA wrappers + plain torch twins.

Replaces `sirius_tpu/ops/pallas_msm.py:_msm_table_kernel` (B2),
`sirius_tpu/ops/pallas_msm.py:_merge_kernel` with the XLA finish of
`_finish_jit` (B3) and `scripts/msm_lab2.py:_merge_call_variant` (S1, B3's
merge with a rolled CIOS product).  Kernels: `csrc/msm.cu` (design and
bounds noted there).

  msm_accumulate     (B2)  chunks of bucket-sorted entries -> Jacobian partials
  msm_reduce         (B3)  partials of each segment -> one Jacobian point each
  msm_combine        (B3)  (t, W, B) bucket sums -> t Jacobian MSM results
  msm_reduce_rolled  (S1)  msm_reduce with the rolled product: the same
                           function, word for word; on no path of the library

Each wrapper takes its plain twin for CPU tensors only; for CUDA tensors it
launches its kernel or raises.  `<wrapper>.launches` counts kernel launches.
Points are (., 8) int64 Montgomery words; `entries` holds
`point_index * 2 + negated`.
"""

from __future__ import annotations

import torch

from ..curves.jpoint import Curve, Points


def _points_on(n: int, like: torch.Tensor) -> list[torch.Tensor]:
    return [torch.empty((n, 8), dtype=torch.int64, device=like.device) for _ in range(3)]


def _check_rows(*tensors: torch.Tensor) -> None:
    """(n, 8) word tensors of one length."""
    n = tensors[0].shape[0]
    for t in tensors:
        if t.dim() != 2 or t.shape != (n, 8):
            raise ValueError(f"expected ({n}, 8) point coordinates, got {tuple(t.shape)}")


# -- plain twins -------------------------------------------------------------------


def msm_accumulate_plain(curve: Curve, entries, chunk_start, chunk_len, px, py) -> Points:
    f = curve.fb
    n_chunks = chunk_start.shape[0]
    acc = curve.identity((n_chunks,), px.device)
    if n_chunks == 0:
        return acc
    last = entries.shape[0] - 1
    for k in range(int(chunk_len.max())):
        e = entries[(chunk_start + k).clamp(max=last)]
        idx = e >> 1
        qy = py[idx]
        qy = f.select((e & 1).bool(), f.neg(qy), qy)
        new = curve.add_mixed_fast(acc, px[idx], qy)
        acc = curve.select(k < chunk_len, new, acc)
    return acc


def msm_reduce_plain(curve: Curve, seg_off, partials: Points) -> Points:
    n_seg = seg_off.shape[0] - 1
    counts = seg_off[1:] - seg_off[:-1]
    width = int(counts.max()) if n_seg else 0
    if width == 0:
        return curve.identity((n_seg,), partials.x.device)
    width = 1 << (width - 1).bit_length()  # pad to a power of two for the tree
    cols = torch.arange(width, device=seg_off.device)
    idx = (seg_off[:-1, None] + cols).clamp(max=partials.x.shape[0] - 1)
    live = cols < counts[:, None]
    ident = curve.identity((n_seg, width), partials.x.device)
    table = curve.select(live, Points(*(c[idx] for c in partials)), ident)
    return curve.sum_reduce(table, axis=1)


def msm_combine_plain(curve: Curve, buckets: Points, c: int) -> Points:
    """sum_w 2^(c w) sum_v v B[:, w, v-1] for (t, W, B) buckets; the window
    sums by two log-depth suffix scans (element 0 of the second is
    sum_v v B_v), then Horner over windows."""
    t, W, B = buckets.x.shape[:3]
    dev = buckets.x.device

    def suffix_scan(P: Points) -> Points:
        s = 1
        while s < B:
            ident = curve.identity((t, W, s), dev)
            nxt = Points(*(torch.cat([a[:, :, s:], i], 2) for a, i in zip(P, ident)))
            P = curve.add(P, nxt)
            s *= 2
        return P

    tot = suffix_scan(suffix_scan(buckets))
    tot = Points(*(a[:, :, 0] for a in tot))  # (t, W)
    acc = Points(*(a[:, W - 1] for a in tot))
    for w in range(W - 2, -1, -1):
        for _ in range(c):
            acc = curve.dbl(acc)
        acc = curve.add(acc, Points(*(a[:, w] for a in tot)))
    return acc


# -- kernel wrappers ---------------------------------------------------------------


def msm_accumulate(curve: Curve, entries, chunk_start, chunk_len, px, py) -> Points:
    _check_rows(px, py)
    if chunk_start.shape != chunk_len.shape or entries.dim() != 1:
        raise ValueError("entries, chunk_start and chunk_len must be 1-D, the chunk arrays of one length")
    if px.device.type == "cpu":
        return msm_accumulate_plain(curve, entries, chunk_start, chunk_len, px, py)
    from . import _build

    ins = [t.contiguous() for t in (entries, chunk_start, chunk_len, px, py)]
    _build.require_cuda(*ins)
    n_chunks = chunk_start.shape[0]
    out = _points_on(n_chunks, px)
    if n_chunks:
        err = _build.library().sirius_msm_accumulate(
            _build.field_consts(curve.fb), *(t.data_ptr() for t in ins),
            *(t.data_ptr() for t in out), n_chunks, _build.stream_of(px))
        _build.check(err, "msm_accumulate")
        msm_accumulate.launches += 1
    return Points(*out)


def _reduce(curve: Curve, seg_off, partials: Points, entry: str) -> Points | None:
    """Launch the reduce kernel `entry` (None for CPU tensors: the caller
    takes the plain twin)."""
    _check_rows(*partials)
    if seg_off.dim() != 1 or seg_off.shape[0] < 1:
        raise ValueError("seg_off must be 1-D with n_segments + 1 offsets")
    if partials.x.device.type == "cpu":
        return None
    from . import _build

    ins = [t.contiguous() for t in (seg_off, *partials)]
    _build.require_cuda(*ins)
    n_seg = seg_off.shape[0] - 1
    out = _points_on(n_seg, partials.x)
    if n_seg:
        err = getattr(_build.library(), entry)(
            _build.field_consts(curve.fb), *(t.data_ptr() for t in ins),
            *(t.data_ptr() for t in out), n_seg, _build.stream_of(partials.x))
        _build.check(err, entry)
    return Points(*out)


def msm_reduce(curve: Curve, seg_off, partials: Points) -> Points:
    out = _reduce(curve, seg_off, partials, "sirius_msm_reduce")
    if out is None:
        return msm_reduce_plain(curve, seg_off, partials)
    if seg_off.shape[0] > 1:
        msm_reduce.launches += 1
    return out


# S1 computes msm_reduce's function: its plain twin is msm_reduce's
msm_reduce_rolled_plain = msm_reduce_plain


def msm_reduce_rolled(curve: Curve, seg_off, partials: Points) -> Points:
    """S1: msm_reduce through the rolled-product kernel."""
    out = _reduce(curve, seg_off, partials, "sirius_msm_reduce_rolled")
    if out is None:
        return msm_reduce_rolled_plain(curve, seg_off, partials)
    if seg_off.shape[0] > 1:
        msm_reduce_rolled.launches += 1
    return out


def reduce_kernel_attrs(rolled: bool) -> dict[str, int]:
    """Registers and local (spill) bytes per thread of the msm_reduce kernel
    (rolled: S1's) as the loaded library was built."""
    import ctypes

    from . import _build

    out = (ctypes.c_longlong * 2)()
    _build.check(_build.library().sirius_msm_reduce_attrs(int(rolled), out), "msm_reduce_attrs")
    return {"numRegs": int(out[0]), "localSizeBytes": int(out[1])}


def msm_combine(curve: Curve, buckets: Points, c: int) -> Points:
    """(t, W, B, 8) bucket sums (bucket v at index v-1) -> (t, 8) Jacobian."""
    if any(b.dim() != 4 or b.shape[-1] != 8 or b.shape != buckets.x.shape for b in buckets):
        raise ValueError("buckets must be three (t, W, B, 8) tensors")
    if buckets.x.device.type == "cpu":
        return msm_combine_plain(curve, buckets, c)
    from . import _build

    t, W, B = buckets.x.shape[:3]
    if not 1 <= W <= 1024:
        raise ValueError(f"window count {W} outside 1..1024")
    ins = [a.contiguous() for a in buckets]
    _build.require_cuda(*ins)
    totals = _points_on(t * W, ins[0])
    out = _points_on(t, ins[0])
    if t:
        err = _build.library().sirius_msm_combine(
            _build.field_consts(curve.fb), *(a.data_ptr() for a in ins),
            *(a.data_ptr() for a in totals), *(a.data_ptr() for a in out),
            t, W, B, c, _build.stream_of(ins[0]))
        _build.check(err, "msm_combine")
        msm_combine.launches += 1
    return Points(*out)


msm_accumulate.launches = 0
msm_reduce.launches = 0
msm_reduce_rolled.launches = 0
msm_combine.launches = 0
