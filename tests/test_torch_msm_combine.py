"""The schedule of B3's combine kernels (`csrc/msm.cu`), in plain torch on
the CPU, where the kernels cannot run: the segmented window sums
(`msm_window_sums_plain`, segments of L buckets) against the suffix-scan
form and big-integer sums, and the grouped Horner (`msm_horner_plain`,
groups of K windows) against the plain Horner and big-integer sums.  The
buckets hold an all-identity window, equal buckets (the complete add's
doubling branch) and a bucket beside its negation (an add that gives the
identity)."""

from functools import lru_cache

import numpy as np
import pytest
import torch

from sirius_tpu_torch.curves.jpoint import BN256_G1, GRUMPKIN, Points
from sirius_tpu_torch.fields import gold
from sirius_tpu_torch.ops import msm_kernels as mk

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers


@lru_cache(maxsize=None)
def _buckets(curve, t, W, B):
    """(t, W, B) Jacobian bucket sums (z != 1) and their host affine points:
    window 1 of MSM 0 all identities; in window 0 of MSM 0 buckets 2 and 3
    equal and bucket B - 1 the negation of bucket B."""
    rng = np.random.default_rng(t * 1000 + W * 10 + B)
    G = gold.generator(curve.spec)
    host = [[[G.mul(int(rng.integers(1, 1 << 30))) for _ in range(B)] for _ in range(W)] for _ in range(t)]
    if W > 1:
        host[0][1] = [gold.identity(curve.spec)] * B
    if B > 3:
        host[0][0][2] = host[0][0][1]
        host[0][0][B - 2] = host[0][0][B - 1].neg()
    flat = [p for msm in host for win in msm for p in win]
    J = curve.dbl(curve.encode(flat, "cpu"))  # Jacobian z != 1: the doubled points
    return Points(*(a.reshape(t, W, B, 8) for a in J)), [[[p.double() for p in win] for win in msm] for msm in host]


def _window_totals(host):
    """sum_v v B_v per window, big-integer."""
    out = []
    for msm in host:
        for win in msm:
            acc = win[0].mul(0)
            for v, p in enumerate(win, 1):
                acc = acc.add(p.mul(v))
            out.append(acc)
    return out


def _flat(P):
    return Points(*(a.reshape(-1, 8) for a in P))


@pytest.mark.parametrize("curve,t,W,B,L", [
    (GRUMPKIN, 2, 2, 15, 1), (GRUMPKIN, 2, 2, 15, 4), (GRUMPKIN, 2, 2, 15, 16),
    (BN256_G1, 1, 2, 8, 1), (BN256_G1, 1, 2, 8, 4), (BN256_G1, 1, 2, 8, 8),
], ids=["B15_L1", "B15_L4_ragged", "B15_L16_one_segment", "B8_L1", "B8_L4", "B8_L8"])
def test_segmented_window_sums(curve, t, W, B, L):
    buckets, host = _buckets(curve, t, W, B)
    got = curve.decode(_flat(mk.msm_window_sums_plain(curve, buckets, L)))
    assert got == curve.decode(_flat(mk.suffix_window_sums(curve, buckets)))
    assert got == _window_totals(host)


def test_window_segment_length_is_a_power_of_two():
    buckets, _ = _buckets(GRUMPKIN, 1, 1, 3)
    with pytest.raises(ValueError, match="power of two"):
        mk.msm_window_sums_plain(GRUMPKIN, buckets, 3)


@pytest.mark.parametrize("W,K", [(5, 1), (5, 2), (5, 3), (5, 5), (7, 3)], ids=["K1", "K2", "K3", "KW", "W7_K3"])
def test_grouped_horner(W, K):
    """sum_w 2^(c w) T_w at c = 3 by groups of K windows (the lowest ragged
    when K does not divide W)."""
    c = 3
    buckets, host = _buckets(BN256_G1, 2, W, 1)
    totals = Points(*(a[:, :, 0] for a in buckets))
    got = BN256_G1.decode(mk.msm_horner_plain(BN256_G1, totals, c, K))
    want = []
    for msm in host:
        acc = msm[0][0].mul(0)
        for w, win in enumerate(msm):
            acc = acc.add(win[0].mul(1 << (c * w)))
        want.append(acc)
    assert got == want


def test_kernel_schedule_sizes():
    """The segment and group sizes the wrappers give the kernels: B = 512 ->
    L = 4 (128 segments), B = 15 -> L = 1; W = 27 -> K = 6, W = 64 -> K = 8."""
    assert [mk.window_log2(B) for B in (15, 128, 129, 512)] == [0, 0, 1, 2]
    assert [mk.horner_group_size(W) for W in (1, 2, 27, 64, 512)] == [1, 2, 6, 8, 23]
