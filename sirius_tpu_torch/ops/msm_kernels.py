"""B2 + B3 + S1: the Pippenger MSM kernels, CUDA wrappers + plain torch twins.

Replaces `sirius_tpu/ops/pallas_msm.py:_msm_table_kernel` (B2),
`sirius_tpu/ops/pallas_msm.py:_merge_kernel` with the XLA finish of
`_finish_jit` (B3) and `scripts/msm_lab2.py:_merge_call_variant` (S1, B3's
merge with a rolled CIOS product).  Kernels: `csrc/msm.cu` (design and
bounds noted there).

  msm_accumulate     (B2)  chunks of bucket-sorted entries -> Jacobian partials
  msm_reduce         (B3)  partials of each segment (at most 32) -> one
                           Jacobian point each, by a pairwise tree: word for
                           word the plain twin's
  msm_window_sums    (B3)  (t, W, B) bucket sums -> (t, W) window totals
                           sum_v v B_v, from segments of L buckets
  msm_combine        (B3)  (t, W, B) bucket sums -> t Jacobian MSM results:
                           msm_window_sums, then the grouped Horner kernel
  msm_reduce_rolled  (S1)  msm_reduce's function (equal in affine form) for
                           segments of any length, on the rolled product:
                           pairwise trees over pieces of at most ROLLED_SPAN
                           partials, one launch more per factor of
                           ROLLED_SPAN in the longest segment
                           (`rolled_passes`); on no path of the library

Each wrapper takes its plain twin for CPU tensors only; for CUDA tensors it
launches its kernel or raises.  `<wrapper>.launches` counts kernel launches
(`msm_accumulate` also by (curve, points, chunks) in `msm_accumulate.shapes`;
`msm_combine` counts its Horner launches, by (t, W, B) shape also in
`msm_combine.shapes`; its window sums count on `msm_window_sums`;
`msm_reduce` and `msm_combine` also by curve name in `<wrapper>.curves`).  Points
are (., 8) int64 Montgomery words; `entries` holds `point_index * 2 +
negated`.
"""

from __future__ import annotations

import math

import torch

from ..curves.jpoint import Curve, Points

REDUCE_MAX_SEG = 32  # csrc/msm.cu: the longest segment msm_reduce's tree takes
ROLLED_SPAN = 256  # csrc/msm.cu: S1's longest piece (and the piece starts one block takes)
WINDOW_THREADS = 128  # csrc/msm.cu: the most bucket segments of one window
MSM_KERNELS = ("msm_accumulate", "msm_reduce", "msm_reduce_rolled", "msm_window_sums", "msm_horner",
               "msm_bucket_count", "msm_bucket_scatter")


def _points_on(n: int, like: torch.Tensor) -> list[torch.Tensor]:
    return [torch.empty((n, 8), dtype=torch.int64, device=like.device) for _ in range(3)]


def _cat(parts, dim: int) -> Points:
    return Points(*(torch.cat(cs, dim) for cs in zip(*parts)))


def _dbl_n(curve: Curve, P: Points, n: int) -> Points:
    for _ in range(n):
        P = curve.dbl(P)
    return P


def window_log2(B: int) -> int:
    """log2 L of the bucket segments msm_window_sums takes for B buckets:
    the least L with at most WINDOW_THREADS segments."""
    log2L = 0
    while -(-B >> log2L) > WINDOW_THREADS:
        log2L += 1
    return log2L


def horner_group_size(W: int) -> int:
    """K windows per Horner group: ceil(sqrt(W)) keeps the chain's adds,
    (K - 1) + (ceil(W / K) - 1), near their least."""
    return math.isqrt(W - 1) + 1 if W > 1 else 1


def _check_rows(*tensors: torch.Tensor) -> None:
    """(n, 8) word tensors of one length."""
    n = tensors[0].shape[0]
    for t in tensors:
        if t.dim() != 2 or t.shape != (n, 8):
            raise ValueError(f"expected ({n}, 8) point coordinates, got {tuple(t.shape)}")


# -- plain twins -------------------------------------------------------------------


def msm_accumulate_plain(curve: Curve, entries, chunk_start, chunk_len, px, py) -> Points:
    curve = curve.limbs
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
    curve = curve.limbs
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


def msm_window_sums_plain(curve: Curve, buckets: Points, L: int) -> Points:
    """The same totals as msm_window_sums computes them, from segments of L
    (a power of two) buckets, the last ragged: segment s walks its buckets
    top-down for R_s and T_s = sum (v - sL) B_v; then sum_v v B_v =
    sum_s (T_s + L P_s), P_s = sum_{s' >= s} R_s' (P_0's term dropped)."""
    curve = curve.limbs
    t, W, B = buckets.x.shape[:3]
    dev = buckets.x.device
    if L < 1 or L & (L - 1):
        raise ValueError(f"segment length {L} is not a power of two")
    S = -(-B // L)
    if S * L > B:  # the ragged top: identities add nothing
        buckets = _cat([buckets, curve.identity((t, W, S * L - B), dev)], 2)
    seg = Points(*(a.reshape(t, W, S, L, a.shape[-1]) for a in buckets))
    run = tot = curve.identity((t, W, S), dev)
    for k in range(L - 1, -1, -1):
        run = curve.add(run, Points(*(a[:, :, :, k] for a in seg)))
        tot = curve.add(tot, run)
    h = 1
    while h < S:
        run = curve.add(run, _cat([Points(*(a[:, :, h:] for a in run)), curve.identity((t, W, h), dev)], 2))
        h *= 2
    weighted = curve.add(tot, _dbl_n(curve, run, L.bit_length() - 1))
    X = curve.select((torch.arange(S, device=dev) >= 1).expand(t, W, S), weighted, tot)
    return curve.sum_reduce(X, axis=2)


def msm_horner_plain(curve: Curve, totals: Points, c: int, K: int) -> Points:
    """sum_w 2^(c w) T[:, w] for (t, W) totals as msm_combine's Horner kernel
    runs it: groups of K windows (the lowest holding the r left over, padded
    at its top with identities here), each by Horner, then Horner over the
    groups (c K doublings between groups, c r before the lowest).  K = 1 is
    the plain Horner over windows."""
    curve = curve.limbs
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
    return msm_horner_plain(curve, suffix_window_sums(curve.limbs, buckets), c, 1)


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
    _build.require_aligned(*ins[3:])
    n_chunks = chunk_start.shape[0]
    out = _points_on(n_chunks, px)
    if n_chunks:
        _build.launch("msm_accumulate", px, _build.field_consts(curve.fb), *(t.data_ptr() for t in ins),
                      *(t.data_ptr() for t in out), n_chunks)
        msm_accumulate.launches += 1
        shape = (curve.spec.name, px.shape[0], n_chunks)
        msm_accumulate.shapes[shape] = msm_accumulate.shapes.get(shape, 0) + 1
    return Points(*out)


def _reduce_args(curve: Curve, seg_off, partials: Points) -> list[torch.Tensor] | None:
    """The kernel operands of a reduce (None for CPU tensors: the caller
    takes the plain twin)."""
    _check_rows(*partials)
    if seg_off.dim() != 1 or seg_off.shape[0] < 1:
        raise ValueError("seg_off must be 1-D with n_segments + 1 offsets")
    if partials.x.device.type == "cpu":
        return None
    from . import _build

    ins = [t.contiguous() for t in (seg_off, *partials)]
    _build.require_cuda(*ins)
    return ins


def msm_reduce(curve: Curve, seg_off, partials: Points) -> Points:
    """One point per segment [seg_off[s], seg_off[s+1]) of at most
    REDUCE_MAX_SEG partials (the identity for an empty one)."""
    ins = _reduce_args(curve, seg_off, partials)
    if ins is None:
        return msm_reduce_plain(curve, seg_off, partials)
    from . import _build

    n_seg = seg_off.shape[0] - 1
    out = _points_on(n_seg, partials.x)
    if n_seg:
        if int((seg_off[1:] - seg_off[:-1]).max()) > REDUCE_MAX_SEG:
            raise ValueError(f"msm_reduce takes segments of at most {REDUCE_MAX_SEG} partials")
        _build.launch("msm_reduce", partials.x, _build.field_consts(curve.fb), *(t.data_ptr() for t in ins),
                      *(t.data_ptr() for t in out), n_seg, partials.x.shape[0])
        msm_reduce.launches += 1
        msm_reduce.curves[curve.spec.name] = msm_reduce.curves.get(curve.spec.name, 0) + 1
    return Points(*out)


# S1 computes msm_reduce's function: its plain twin is msm_reduce's
msm_reduce_rolled_plain = msm_reduce_plain


def rolled_piece_offsets(seg_off: torch.Tensor) -> torch.Tensor:
    """Segment s's first output row of an S1 launch: the kernel cuts each
    segment into pieces of at most ROLLED_SPAN partials from its start and
    writes one row per piece, the pieces of segment s at rows [off[s],
    off[s+1]) in order; an empty segment is one piece (the identity)."""
    counts = ((seg_off[1:] - seg_off[:-1] + ROLLED_SPAN - 1) // ROLLED_SPAN).clamp(min=1)
    return torch.cat([seg_off.new_zeros(1), torch.cumsum(counts, 0)])


def rolled_passes(seg_off: torch.Tensor, longest: int) -> list[torch.Tensor | None]:
    """The `piece_off` of each S1 launch for segments of at most `longest`
    partials: launch i reads the rows of launch i - 1 (the partials first)
    with seg_off the piece_off before it, and the last launch, None, leaves
    one row per segment."""
    plan: list[torch.Tensor | None] = []
    while longest > ROLLED_SPAN:
        seg_off = rolled_piece_offsets(seg_off)
        plan.append(seg_off)
        longest = -(-longest // ROLLED_SPAN)
    return plan + [None]


def msm_reduce_rolled(curve: Curve, seg_off, partials: Points) -> Points:
    """S1: one point per segment [seg_off[s], seg_off[s+1]) of any length
    (the identity for an empty one), as msm_reduce in affine form.  The
    plan of launches reads the longest segment on the host (one sync) and,
    for more than one launch, their row counts (one more)."""
    ins = _reduce_args(curve, seg_off, partials)
    if ins is None:
        return msm_reduce_rolled_plain(curve, seg_off, partials)
    from . import _build

    off, pts = ins[0], ins[1:]
    n_seg = off.shape[0] - 1
    if not n_seg:
        return Points(*_points_on(0, pts[0]))
    plan = rolled_passes(off, int((off[1:] - off[:-1]).max()))
    rows = torch.stack([po[-1] for po in plan[:-1]]).tolist() if len(plan) > 1 else []
    for piece_off, n_rows in zip(plan, [*rows, n_seg]):
        out = _points_on(n_rows, pts[0])
        _build.launch("msm_reduce_rolled", pts[0], _build.field_consts(curve.fb), off.data_ptr(),
                      None if piece_off is None else piece_off.data_ptr(), *(t.data_ptr() for t in pts),
                      *(t.data_ptr() for t in out), n_seg, pts[0].shape[0])
        msm_reduce_rolled.launches += 1
        off, pts = piece_off, out
    return Points(*pts)


def msm_kernel_attrs(name: str) -> dict[str, int]:
    """Registers and local (spill) bytes per thread, static shared bytes per
    block, of the MSM kernel `name` (one of MSM_KERNELS) as the loaded
    library was built."""
    import ctypes

    from . import _build

    out = (ctypes.c_longlong * 3)()
    _build.check(_build.library().sirius_msm_attrs(MSM_KERNELS.index(name), out), "msm_attrs")
    return {"numRegs": int(out[0]), "localSizeBytes": int(out[1]), "sharedSizeBytes": int(out[2])}


def _check_buckets(buckets: Points) -> None:
    if any(b.dim() != 4 or b.shape[-1] != 8 or b.shape != buckets.x.shape for b in buckets):
        raise ValueError("buckets must be three (t, W, B, 8) tensors")


def msm_window_sums(curve: Curve, buckets: Points) -> Points:
    """(t, W, B, 8) bucket sums (bucket v at index v-1) -> (t, W, 8) Jacobian
    window totals sum_v v B_v, from segments of 2^window_log2(B) buckets."""
    _check_buckets(buckets)
    t, W, B = buckets.x.shape[:3]
    log2L = window_log2(B)
    if buckets.x.device.type == "cpu":
        return msm_window_sums_plain(curve, buckets, 1 << log2L)
    from . import _build

    ins = [a.contiguous() for a in buckets]
    _build.require_cuda(*ins)
    out = _points_on(t * W, ins[0])
    if t * W:
        _build.launch("msm_window_sums", ins[0], _build.field_consts(curve.fb), *(a.data_ptr() for a in ins),
                      *(a.data_ptr() for a in out), t * W, B, log2L)
        msm_window_sums.launches += 1
    return Points(*(a.reshape(t, W, 8) for a in out))


def msm_combine(curve: Curve, buckets: Points, c: int) -> Points:
    """(t, W, B, 8) bucket sums (bucket v at index v-1) -> (t, 8) Jacobian."""
    _check_buckets(buckets)
    if buckets.x.device.type == "cpu":
        return msm_combine_plain(curve, buckets, c)
    from . import _build

    t, W, B = buckets.x.shape[:3]
    K = horner_group_size(W)
    if not 1 <= W <= 512:
        raise ValueError(f"window count {W} outside 1..512")
    totals = msm_window_sums(curve, buckets)
    out = _points_on(t, totals.x)
    if t:
        _build.launch("msm_horner", totals.x, _build.field_consts(curve.fb), *(a.data_ptr() for a in totals),
                      *(a.data_ptr() for a in out), t, W, c, K)
        msm_combine.launches += 1
        msm_combine.shapes[(t, W, B)] = msm_combine.shapes.get((t, W, B), 0) + 1
        msm_combine.curves[curve.spec.name] = msm_combine.curves.get(curve.spec.name, 0) + 1
    return Points(*out)


msm_accumulate.launches = 0
msm_accumulate.shapes = {}
msm_reduce.launches = 0
msm_reduce.curves = {}
msm_reduce_rolled.launches = 0
msm_window_sums.launches = 0
msm_combine.launches = 0
msm_combine.shapes = {}
msm_combine.curves = {}
