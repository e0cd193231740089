"""Multi-scalar multiplication over commitment-key points.

Counterpart of `sirius_tpu/ops/msm.py`.  Three entry points, all on the
commitment-key contract (points affine with z = 1, distinct, not the
identity: a bucket value colliding with an incoming point would be a
discrete-log relation between key generators):

  best_msm   one MSM: signed c-bit digits, B2's bucket sort
             (`bucket_plan`), then B2 `msm_accumulate` -> B3 `msm_reduce`
             (levels of fan-in 32) -> B3 `msm_combine`
  msm_many   t MSMs over shared points: the bucket table of
             `sirius_tpu/ops/msm.py:_bucket_totals_onehot_pallas` (4-bit
             unsigned windows, G groups) in one B1 `madd_buckets` launch,
             then B3 `msm_reduce` over the groups and `msm_combine`
  msm_sharded  one MSM cut by rows over a mesh (`parallel/`): best_msm's
             pipeline on every shard's device, the shards' points added
             on the host

Scalars are (n, 8) standard-form words; results are host affine points.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..curves.jpoint import Curve, Points
from ..fields import gold
from ..fields.jfield import WORDS
from ..parallel.mesh import Mesh, shard_rows
from .madd import SCALAR_BITS, extract_digits, madd_buckets
from .msm_kernels import msm_accumulate, msm_combine, msm_reduce

CHUNK = 32  # points walked by one msm_accumulate thread (csrc/msm.cu CHUNK)
SORT_TILE = 2048  # points of one window per bucket-sort warp (csrc/msm.cu)
FAN_IN = 32  # partials summed by one msm_reduce thread per level
MANY_WINDOW_BITS = 4  # msm_many: unsigned window width
MANY_GROUPS = 256  # msm_many: point groups walked in parallel (madd lanes per window)


def _extract_digits_signed(scalars_std: torch.Tensor, c: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Signed windows: (W+1, n) magnitudes in [0, 2^(c-1)] and a negation
    mask with scalar = sum_w sign_w * mag_w * 2^(c w) (the last window is the
    final carry, never negative)."""
    d = extract_digits(scalars_std, c)
    half, full = 1 << (c - 1), 1 << c
    mags, negs = [], []
    carry = torch.zeros_like(d[0])
    for w in range(d.shape[0]):
        v = d[w] + carry
        neg = v > half
        mags.append(torch.where(neg, full - v, v))
        negs.append(neg)
        carry = neg.long()
    mags.append(carry)
    negs.append(torch.zeros_like(negs[0]))
    return torch.stack(mags), torch.stack(negs)


def signed_window_bits(n: int) -> int:
    """Signed window width for an n-point MSM: more windows (cheaper bucket
    sums) for small n, fewer (fewer accumulation adds) for large n."""
    return min(10, max(4, n.bit_length() - 6))


@dataclass
class BucketPlan:
    """Inputs of the B2/B3 kernels for one MSM: live digits sorted into
    (window, bucket) segments, each cut into chunks of at most CHUNK."""

    c: int
    W: int
    B: int
    entries: torch.Tensor  # point index * 2 + negated, bucket-sorted
    chunk_start: torch.Tensor
    chunk_len: torch.Tensor
    seg_off: torch.Tensor  # chunks of segment s: seg_off[s] .. seg_off[s+1]


def bucket_plan_plain(scalars_std: torch.Tensor, c: int | None = None) -> BucketPlan:
    """The plan in torch: signed digits, a stable `torch.sort` of the live
    (window, point) digits by bucket, then the chunks of every segment."""
    n = scalars_std.shape[0]
    dev = scalars_std.device
    c = c or signed_window_bits(n)
    B = 1 << (c - 1)
    mags, negs = _extract_digits_signed(scalars_std, c)  # (W, n)
    W = mags.shape[0]
    live = mags > 0
    seg = (torch.arange(W, device=dev)[:, None] * B + mags - 1)[live]
    entries = (torch.arange(n, device=dev) * 2 + negs.long()).expand(W, n)[live]
    seg, order = torch.sort(seg, stable=True)
    entries = entries[order].contiguous()

    counts = torch.bincount(seg, minlength=W * B)
    seg_start = torch.cumsum(counts, 0) - counts
    nch = (counts + CHUNK - 1) // CHUNK
    seg_off = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(nch, 0)])
    chunk_seg = torch.repeat_interleave(torch.arange(W * B, device=dev), nch)
    chunk_j = torch.arange(chunk_seg.shape[0], device=dev) - seg_off[chunk_seg]
    chunk_start = seg_start[chunk_seg] + chunk_j * CHUNK
    chunk_len = torch.minimum(counts[chunk_seg] - chunk_j * CHUNK, torch.full_like(chunk_j, CHUNK))
    return BucketPlan(c, W, B, entries, chunk_start, chunk_len, seg_off)


def bucket_plan(scalars_std: torch.Tensor, c: int | None = None) -> BucketPlan:
    """B2's inputs for (n, 8) standard-form scalars in signed c-bit windows
    (by default `signed_window_bits(n)`).  On CUDA tensors the
    counting sort of `csrc/msm.cu` (signed digits and per-tile bucket counts,
    an exclusive scan in torch, a stable scatter, the chunks): the same
    arrays as `bucket_plan_plain`, which CPU tensors take.
    `bucket_plan.launches` counts the sorts run on the card (by the number of
    scalars in `bucket_plan.shapes`)."""
    if scalars_std.device.type == "cpu":
        return bucket_plan_plain(scalars_std, c)
    from . import _build

    S = scalars_std.contiguous()
    _build.require_cuda(S)
    n, dev = S.shape[0], S.device
    c = c or signed_window_bits(n)
    B = 1 << (c - 1)
    W = -(-SCALAR_BITS // c) + 1
    ntiles = -(-n // SORT_TILE)
    digits = torch.empty((W, n), dtype=torch.int16, device=dev)
    counts = torch.empty((W * B, ntiles), dtype=torch.int32, device=dev)
    _build.launch("msm_bucket_count", S, S.data_ptr(), digits.data_ptr(), counts.data_ptr(), n, c, ntiles)
    flat = counts.reshape(-1).to(torch.int64)
    offs = torch.cumsum(flat, 0) - flat  # where each (bucket, tile) run starts
    seg_count = counts.sum(1, dtype=torch.int64)
    seg_start = torch.cumsum(seg_count, 0) - seg_count
    nch = (seg_count + CHUNK - 1) // CHUNK
    seg_off = torch.cat([seg_count.new_zeros(1), torch.cumsum(nch, 0)])
    n_entries, n_chunks = torch.stack([seg_count.sum(), seg_off[-1]]).tolist()
    entries = torch.empty(n_entries, dtype=torch.int64, device=dev)
    chunk_start = torch.empty(n_chunks, dtype=torch.int64, device=dev)
    chunk_len = torch.empty(n_chunks, dtype=torch.int64, device=dev)
    _build.launch("msm_bucket_scatter", S, digits.data_ptr(), offs.data_ptr(), entries.data_ptr(),
                  seg_off.data_ptr(), seg_start.data_ptr(), seg_count.data_ptr(), chunk_start.data_ptr(),
                  chunk_len.data_ptr(), n, c, ntiles, n_chunks)
    bucket_plan.launches += 1
    bucket_plan.shapes[n] = bucket_plan.shapes.get(n, 0) + 1
    return BucketPlan(c, W, B, entries, chunk_start, chunk_len, seg_off)


def split_segments(seg_off: torch.Tensor, fan_in: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Cut every segment into sub-segments of at most `fan_in` partials (an
    empty segment keeps one empty sub-segment).  Returns (sub_off, owner
    offsets): sub-segment offsets into the partials, and for each segment
    the range of its sub-segments."""
    counts = seg_off[1:] - seg_off[:-1]
    nsub = torch.clamp((counts + fan_in - 1) // fan_in, min=1)
    ends = torch.cumsum(nsub, 0)
    owner = torch.repeat_interleave(torch.arange(counts.shape[0], device=seg_off.device), nsub)
    sub_j = torch.arange(owner.shape[0], device=seg_off.device) - (ends - nsub)[owner]
    sub_start = seg_off[owner] + sub_j * fan_in
    sub_off = torch.cat([sub_start, seg_off[-1:]])
    return sub_off, torch.cat([ends.new_zeros(1), ends])


def reduce_segments(curve: Curve, seg_off: torch.Tensor, partials: Points) -> Points:
    """One point per segment: B3 `msm_reduce` levels of fan-in <= FAN_IN, so
    a skewed segment (the top windows hold few buckets) spreads over many
    threads instead of one long serial sum."""
    while int((seg_off[1:] - seg_off[:-1]).max()) > FAN_IN:
        sub_off, seg_off = split_segments(seg_off, FAN_IN)
        partials = msm_reduce(curve, sub_off, partials)
    return msm_reduce(curve, seg_off, partials)


def best_msm(curve: Curve, scalars_std: torch.Tensor, points: Points) -> gold.AffinePoint:
    """sum_i s_i * P_i through B2 + B3 (every curve)."""
    if scalars_std.shape[0] == 0:
        return gold.identity(curve.spec)
    plan = bucket_plan(scalars_std)
    partials = msm_accumulate(curve, plan.entries, plan.chunk_start, plan.chunk_len,
                              points.x.contiguous(), points.y.contiguous())
    buckets = reduce_segments(curve, plan.seg_off, partials)
    out = msm_combine(curve, Points(*(b.reshape(1, plan.W, plan.B, WORDS) for b in buckets)), plan.c)
    return curve.decode(out)[0]


def shard_points(mesh: Mesh, points: Points) -> list[Points]:
    """A batch of points cut into the mesh's row blocks (`shard_rows`)."""
    return [Points(*cs) for cs in zip(*(shard_rows(mesh, c) for c in points))]


def msm_sharded(curve: Curve, scalars_std: torch.Tensor | list[torch.Tensor], points: Points | list[Points],
                mesh: Mesh) -> gold.AffinePoint:
    """sum_i s_i * P_i with scalars and points cut by rows over `mesh`
    (`sirius_tpu/ops/msm.py:msm_sharded`): `points` is the (>= n) key
    prefix, or its shards already placed (`CommitmentKey.shards`).  The
    scalars may come as their shards already placed, one a mesh entry
    (a round's row blocks), with the points' shards that pair with them
    (`CommitmentKey.row_shards`).  Every
    shard runs best_msm's pipeline on its own device, in one window width
    (that of the longest shard) so that a device's shards stack into one
    `msm_combine` launch; the per-shard points are added on the host (EC
    addition is no psum).  The shards are uneven row blocks and are never
    padded: an identity point would break the kernels' distinct-key-point
    contract, so an empty shard contributes the identity and launches
    nothing.  The stages run across the devices in turn (every plan, every
    accumulate, every reduce, every combine), so the accumulates of real
    cards overlap while the host reads the plans and reduce levels of each."""
    if isinstance(scalars_std, torch.Tensor):
        n = scalars_std.shape[0]
        scalar_shards = shard_rows(mesh, scalars_std)
        if isinstance(points, Points):
            points = shard_points(mesh, Points(*(c[:n] for c in points)))
    else:
        scalar_shards = scalars_std
        n = sum(S.shape[0] for S in scalar_shards)
    if len(points) != mesh.size or len(scalar_shards) != mesh.size:
        raise ValueError(f"{len(scalar_shards)} scalar and {len(points)} point shards for a mesh of {mesh.size}")
    c = signed_window_bits(-(-n // mesh.size))
    live = [(S, P) for S, P in zip(scalar_shards, points) if S.shape[0]]
    for S, P in live:
        if P.x.shape[0] != S.shape[0] or P.x.device != S.device:
            raise ValueError(f"a shard of {S.shape[0]} scalars on {S.device} against {P.x.shape[0]} points on "
                             f"{P.x.device}")
    plans = [bucket_plan(S, c) for S, _ in live]
    partials = [msm_accumulate(curve, plan.entries, plan.chunk_start, plan.chunk_len, P.x.contiguous(),
                               P.y.contiguous()) for plan, (_, P) in zip(plans, live)]
    buckets = [reduce_segments(curve, plan.seg_off, part) for plan, part in zip(plans, partials)]
    by_device: dict[torch.device, list[Points]] = {}
    for b in buckets:
        by_device.setdefault(b.x.device, []).append(b)
    W, B = (plans[0].W, plans[0].B) if plans else (0, 0)
    outs = [msm_combine(curve, Points(*(torch.stack(cs).reshape(len(bs), W, B, WORDS) for cs in zip(*bs))), c)
            for bs in by_device.values()]
    acc = gold.identity(curve.spec)
    for out in outs:
        for p in curve.decode(out):
            acc = acc.add(p)
    return acc


def msm_many(curve: Curve, scalars_std_batch: torch.Tensor, points: Points) -> list[gold.AffinePoint]:
    """t MSMs over shared points: (t, n, 8) scalars -> t affine points."""
    t, n = scalars_std_batch.shape[:2]
    if t == 0:
        return []
    dev = scalars_std_batch.device
    c = MANY_WINDOW_BITS
    B = (1 << c) - 1
    G = min(MANY_GROUPS, 1 << max(n.bit_length() - 1, 0))
    px, py = points.x[:n], points.y[:n]
    pad = (-n) % G
    if pad:  # zero scalars are dead digits: the padded points never accumulate
        scalars_std_batch = torch.cat([scalars_std_batch, scalars_std_batch.new_zeros((t, pad, WORDS))], 1)
        px = torch.cat([px, px[:1].expand(pad, WORDS)])
        py = torch.cat([py, py[:1].expand(pad, WORDS)])
        n += pad
    table = madd_buckets(curve, scalars_std_batch, px.contiguous(), py.contiguous(), G, c)  # (t, W, B, G)
    W = table.x.shape[1]
    # the group partials of every (t, w, b) are contiguous segments of G
    segs = Points(*(tc.reshape(-1, WORDS) for tc in table))
    seg_off = torch.arange(0, t * W * B * G + 1, G, device=dev)
    buckets = reduce_segments(curve, seg_off, segs)
    out = msm_combine(curve, Points(*(b.reshape(t, W, B, WORDS) for b in buckets)), c)
    return curve.decode(out)


bucket_plan.launches = 0
bucket_plan.shapes = {}
