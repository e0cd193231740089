"""S1, `scripts/msm_lab2.py:_merge_call_variant`: B3's group merge with the
rolled CIOS product (`limb_kernels.KF(fb, roll_mul=True)`).  Its kernel body
(`msm_lab2.py:36-59`: halve the groups to 32, then a 5-step roll tail) runs
here in jnp on (16, 64, 8) limb-first tables of curve points, with
identities, equal pairs (the doubling case) and inverse pairs; the port's
`msm_reduce_rolled` (its plain twin, on the CPU) must give the same points
in affine form, one per lane.  The CUDA kernel against msm_reduce and its
twin is in `test_torch_gpu.py`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sirius_tpu.curves.jpoint import BN256_G1 as J_BN256_G1
from sirius_tpu.curves.jpoint import GRUMPKIN as J_GRUMPKIN
from sirius_tpu.ops import limb_kernels as lk
from sirius_tpu_torch.curves.jpoint import BN256_G1, GRUMPKIN, Points
from sirius_tpu_torch.fields import gold
from sirius_tpu_torch.ops import msm_kernels as mk
from sirius_tpu_torch.util.interop import limbs_to_words, words_to_limbs

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers

GROUPS, LANES, TAIL = 64, 8, 32


def _s1_body(f, cur):
    """`msm_lab2.py:36-59` on a (16, GROUPS, LANES) table: the halving levels
    down to TAIL groups, then the roll tail (its fori_loop as a loop)."""
    n_grp = GROUPS
    while n_grp > TAIL:
        h = n_grp // 2
        cur = tuple(lk.k_add_complete(f, tuple(a[:, :h] for a in cur), tuple(a[:, h:n_grp] for a in cur)))
        n_grp = h
    for i in range(TAIL.bit_length() - 1):
        shift = TAIL >> (i + 1)
        cur = tuple(lk.k_add_complete(f, cur, tuple(jnp.roll(a, -shift, axis=1) for a in cur)))
    return tuple(a[:, :1] for a in cur)


def _partials(curve, seed):
    """LANES segments of GROUPS Jacobian points (z != 1), lane-major: lane l
    holds group g at row l * GROUPS + g."""
    rng = np.random.default_rng(seed)
    G = gold.generator(curve.spec)
    pts = [G.mul(int(rng.integers(1, 1 << 40))) for _ in range(LANES * GROUPS)]
    for lane in range(LANES):
        base = lane * GROUPS
        pts[base + 40] = pts[base + 8]  # added at the first halving: the doubling case
        pts[base + 41] = pts[base + 9].neg()  # an inverse pair: the identity
    J = curve.dbl(curve.encode(pts, "cpu"))
    J = Points(*(c.clone() for c in J))
    ident = curve.identity((LANES,), "cpu")
    rows = torch.arange(LANES) * GROUPS + 3
    for c, i in zip(J, ident):
        c[rows] = i  # an identity operand in every lane
    return J


@pytest.mark.parametrize("curve,jcurve", [(BN256_G1, J_BN256_G1), (GRUMPKIN, J_GRUMPKIN)],
                         ids=["bn256_g1", "grumpkin"])
def test_rolled_reduce_twin_matches_s1_body(curve, jcurve):
    J = _partials(curve, 17)
    table = tuple(jnp.asarray(words_to_limbs(c).reshape(LANES, GROUPS, 16).transpose(2, 1, 0)) for c in J)
    want = _s1_body(lk.KF(jcurve.fb, roll_mul=True), table)
    want = Points(*(torch.from_numpy(limbs_to_words(np.asarray(a)[:, 0].T)) for a in want))

    seg_off = torch.arange(0, LANES * GROUPS + 1, GROUPS)
    before = mk.msm_reduce_rolled.launches
    got = mk.msm_reduce_rolled(curve, seg_off, J)
    assert mk.msm_reduce_rolled.launches == before  # CPU tensors: the plain twin, no launch
    assert curve.decode(got) == curve.decode(want)
    assert curve.decode(got) == curve.decode(mk.msm_reduce(curve, seg_off, J))


SPAN = mk.ROLLED_SPAN


@pytest.mark.parametrize("length", [0, 1, 2, 31, 32, 33, SPAN - 1, SPAN, SPAN + 1, 5000, 70000])
def test_rolled_plan_covers_each_segment_once_in_order(length):
    """The launches msm_reduce_rolled plans (`rolled_passes`): in every
    launch each segment is cut into pieces of at most ROLLED_SPAN partials
    from its start (an empty segment one empty piece), its pieces take the
    rows [piece_off[s], piece_off[s+1]) of the launch's output in order, so
    they cover its partials exactly once, in order; the next launch reads
    those rows as its partials; the last leaves one row per segment, and
    the launches number one more per factor of ROLLED_SPAN in the longest
    segment."""
    lens = [3, length, 0, length, 1]
    seg_off = torch.tensor([0, *np.cumsum(lens)], dtype=torch.int64)
    plan = mk.rolled_passes(seg_off, max(lens))
    longest, launches = max(lens), 1
    while longest > SPAN:
        longest, launches = -(-longest // SPAN), launches + 1
    assert len(plan) == launches and plan[-1] is None
    off = seg_off
    for piece_off in plan:
        rows = 0
        for s in range(len(lens)):
            a, b = int(off[s]), int(off[s + 1])
            pieces = [(p, min(p + SPAN, b)) for p in range(a, b, SPAN)] or [(a, a)]
            assert [i for p, e in pieces for i in range(p, e)] == list(range(a, b))
            if piece_off is None:
                assert len(pieces) == 1
            else:
                assert (int(piece_off[s]), int(piece_off[s + 1])) == (rows, rows + len(pieces))
            rows += len(pieces)
        off = piece_off
