"""Multi-scalar multiplication over commitment-key points.

Counterpart of `sirius_tpu/ops/msm.py`, on the
commitment-key contract (points affine with z = 1, distinct, not the
identity: a bucket value colliding with an incoming point would be a
discrete-log relation between key generators):

  best_msm   one MSM: signed c-bit digits, B2's bucket sort
             (`bucket_plan`), then B2 `msm_accumulate` -> B3 `msm_reduce`
             (levels of fan-in 32) -> B3 `msm_combine`, each stage
             its plain torch twin (`ops/msm_kernels.py`)

Scalars are (n, 8) standard-form words; results are host affine points.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..curves.jpoint import Curve, Points
from ..fields import gold
from ..fields.jfield import WORDS
from .msm_kernels import msm_accumulate, msm_combine, msm_reduce

CHUNK = 32  # points walked by one msm_accumulate thread (csrc/msm.cu CHUNK)
FAN_IN = 32  # partials summed by one msm_reduce thread per level
SCALAR_BITS = 32 * WORDS


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
    (by default `signed_window_bits(n)`)."""
    return bucket_plan_plain(scalars_std, c)


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
