"""B2 + B3: the Pippenger MSM stages, as the plain torch twins of the program's CUDA kernels.

Replaces `sirius_tpu/ops/pallas_msm.py:_msm_table_kernel` (B2),
`sirius_tpu/ops/pallas_msm.py:_merge_kernel` with the XLA finish of
`_finish_jit` (B3) and `scripts/msm_lab2.py:_merge_call_variant` (S1, B3's
merge with a rolled CIOS product).  Kernels: `csrc/msm.cu` (design and
bounds noted there).

  msm_accumulate     (B2)  chunks of bucket-sorted entries -> Jacobian partials
  msm_reduce         (B3)  partials of each segment (at most 32) -> one
                           Jacobian point each, by a pairwise tree: word for
                           word the plain twin's
  msm_combine        (B3)  (t, W, B) bucket sums -> t Jacobian MSM results:
                           window sums, then Horner over the windows

In this frozen copy every entry point runs its plain torch twin, on any device."""

from __future__ import annotations

import torch

from ..curves.jpoint import Curve, Points

WINDOW_THREADS = 128  # csrc/msm.cu: the most bucket segments of one window


def _cat(parts, dim: int) -> Points:
    return Points(*(torch.cat(cs, dim) for cs in zip(*parts)))


def _dbl_n(curve: Curve, P: Points, n: int) -> Points:
    for _ in range(n):
        P = curve.dbl(P)
    return P


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


def suffix_window_sums(curve: Curve, buckets: Points) -> Points:
    """(t, W, B) buckets -> (t, W) totals sum_v v B[:, w, v-1] by two log-depth
    suffix scans (element 0 of the second is sum_v v B_v)."""
    t, W, B = buckets.x.shape[:3]
    dev = buckets.x.device

    def suffix_scan(P: Points) -> Points:
        s = 1
        while s < B:
            nxt = _cat([Points(*(a[:, :, s:] for a in P)), curve.identity((t, W, s), dev)], 2)
            P = curve.add(P, nxt)
            s *= 2
        return P

    return Points(*(a[:, :, 0] for a in suffix_scan(suffix_scan(buckets))))


def msm_horner_plain(curve: Curve, totals: Points, c: int, K: int) -> Points:
    """sum_w 2^(c w) T[:, w] for (t, W) totals as msm_combine's Horner kernel
    runs it: groups of K windows (the lowest holding the r left over, padded
    at its top with identities here), each by Horner, then Horner over the
    groups (c K doublings between groups, c r before the lowest).  K = 1 is
    the plain Horner over windows."""
    t, W = totals.x.shape[:2]
    G = -(-W // K)
    r = W - (G - 1) * K
    low = Points(*(a[:, :r] for a in totals))
    T = _cat([low, curve.identity((t, K - r), totals.x.device), Points(*(a[:, r:] for a in totals))], 1)
    T = Points(*(a.reshape(t, G, K, a.shape[-1]) for a in T))
    grp = Points(*(a[:, :, K - 1] for a in T))
    for i in range(K - 2, -1, -1):
        grp = curve.add(_dbl_n(curve, grp, c), Points(*(a[:, :, i] for a in T)))
    acc = Points(*(a[:, G - 1] for a in grp))
    for g in range(G - 2, 0, -1):
        acc = curve.add(_dbl_n(curve, acc, c * K), Points(*(a[:, g] for a in grp)))
    if G > 1:
        acc = curve.add(_dbl_n(curve, acc, c * r), Points(*(a[:, 0] for a in grp)))
    return acc


def msm_combine_plain(curve: Curve, buckets: Points, c: int) -> Points:
    """sum_w 2^(c w) sum_v v B[:, w, v-1] for (t, W, B) buckets: the window
    sums by two log-depth suffix scans, then Horner over windows."""
    return msm_horner_plain(curve, suffix_window_sums(curve, buckets), c, 1)


# -- the reference's entry points: the plain twins on every device -----------------


def msm_accumulate(curve: Curve, entries, chunk_start, chunk_len, px, py) -> Points:
    _check_rows(px, py)
    return msm_accumulate_plain(curve, entries, chunk_start, chunk_len, px, py)


def msm_reduce(curve: Curve, seg_off, partials: Points) -> Points:
    """One point per segment [seg_off[s], seg_off[s+1]) (the identity for an
    empty one)."""
    _check_rows(*partials)
    return msm_reduce_plain(curve, seg_off, partials)


def msm_combine(curve: Curve, buckets: Points, c: int) -> Points:
    """(t, W, B, 8) bucket sums (bucket v at index v-1) -> (t, 8) Jacobian."""
    return msm_combine_plain(curve, buckets, c)
