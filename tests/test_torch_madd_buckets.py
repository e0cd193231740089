"""msm_many's bucket stage (B1 `madd_buckets`) and B2's partials on the CPU.

- `madd_buckets_plain` (the twin of the one-launch bucket walk) against
  the per-step loop msm_many ran before it (one-hot select, batched madd,
  masked write-back), word for word, and against big-integer bucket sums;
- `msm_many` through it against the JAX package's `msm_many` on its XLA
  route (one-hot bucket loop with the mixed add; `use_pallas` is false off
  the TPU), in affine form;
- `msm_accumulate_plain`'s partials at a skewed digit distribution: their
  words pinned by a digest and each partial equal to the big-integer sum of
  its chunk.
The kernels themselves are held against these twins on a GPU in
`test_torch_gpu.py`.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sirius_tpu.curves.jpoint import GRUMPKIN as J_GRUMPKIN
from sirius_tpu.curves.jpoint import Points as JPoints
from sirius_tpu.ops.msm import msm_many as jax_msm_many
from sirius_tpu_torch.curves.hash_to_curve import hash_bytes_to_point
from sirius_tpu_torch.curves.jpoint import BN256_G1, GRUMPKIN, Points
from sirius_tpu_torch.fields import gold
from sirius_tpu_torch.ops import msm_kernels as mk
from sirius_tpu_torch.ops.commitment import CommitmentKey
from sirius_tpu_torch.ops.madd import extract_digits, madd_buckets, madd_buckets_plain, madd_plain
from sirius_tpu_torch.ops.msm import bucket_plan, msm_many
from sirius_tpu_torch.util.interop import affine_from, limbs_to_words, words_to_limbs

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers

CURVES = [BN256_G1, GRUMPKIN]
IDS = ["bn256_g1", "grumpkin"]


def _scalars(rng, shape):
    """(limbs, words) of 252-bit scalars (bench.py's draw)."""
    limbs = rng.integers(0, 1 << 16, size=(*shape, 16), dtype=np.uint32)
    limbs[..., 15] &= 0x0FFF
    return limbs, torch.from_numpy(limbs_to_words(limbs))


def _per_step_loop(curve, scalars, px, py, G, c):
    """msm_many's bucket stage as it ran before madd_buckets: per step, the
    one-hot multiply-and-sum over the (t, W, G, B) table, one batched madd
    and a masked torch.where write-back."""
    t, n = scalars.shape[:2]
    B, g = (1 << c) - 1, n // G
    digits = extract_digits(scalars, c)
    W = digits.shape[1]
    dg = digits.reshape(t, W, G, g)
    pxg, pyg = px.reshape(G, g, 8), py.reshape(G, g, 8)
    vs = torch.arange(1, B + 1)
    table = curve.identity((t, W, G, B), "cpu")
    lanes = t * W * G
    for step in range(g):
        oh = (dg[..., step, None] == vs).unsqueeze(-1)
        cur = Points(*((tc * oh).sum(3).reshape(lanes, 8) for tc in table))
        qx = pxg[:, step].expand(t, W, G, 8).reshape(lanes, 8)
        qy = pyg[:, step].expand(t, W, G, 8).reshape(lanes, 8)
        new = madd_plain(curve, cur, qx, qy)
        table = Points(*(torch.where(oh, nc.reshape(t, W, G, 1, 8), tc) for tc, nc in zip(table, new)))
    return table


def _bucket_case(curve, seed, t=2, n=64):
    ck = CommitmentKey.setup(curve, 6, b"torch-madd-buckets", use_cache=False, device="cpu")
    rng = np.random.default_rng(seed)
    limbs, S = _scalars(rng, (t, n))
    S[0, 3] = 0  # a zero scalar: every digit dead
    S[-1, 5] = S[-1, 6]  # a repeated scalar: the same bucket twice in a row of steps
    return ck, S


@pytest.mark.parametrize("curve", CURVES, ids=IDS)
def test_madd_buckets_plain_equals_the_per_step_loop(curve):
    """t = 2, n = 64 in G = 8 groups of 8 steps, 4-bit windows: word for
    word the (t, W, G, B) table of the loop, in the (t, W, B, G) layout."""
    ck, S = _bucket_case(curve, 11)
    px, py = ck.points.x, ck.points.y
    want = _per_step_loop(curve, S, px, py, 8, 4)
    got = madd_buckets_plain(curve, S, px, py, 8, 4)
    assert got.x.shape == (2, 64, 15, 8, 8)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_.permute(0, 1, 3, 2, 4))


@pytest.mark.parametrize("c,G", [(4, 8), (3, 16), (5, 4)], ids=["c4_G8", "c3_G16", "c5_G4"])
def test_madd_buckets_plain_against_big_integer_bucket_sums(c, G):
    """Bucket (t, w, v, g) is the sum of group g's points whose window w of
    scalar t is v (the identity where there is none), for windows that do
    and do not divide 32 bits."""
    curve = GRUMPKIN
    ck, S = _bucket_case(curve, 12 + c)
    t, n = S.shape[:2]
    host = ck.host_points()
    got = madd_buckets(curve, S, ck.points.x, ck.points.y, G, c)  # CPU: the plain twin
    W, B = got.x.shape[1:3]
    dec = curve.decode(got)
    digits = extract_digits(S, c).numpy()  # (t, W, n)
    gs = n // G
    want = [gold.identity(curve.spec)] * (t * W * B * G)
    for ti in range(t):
        for w in range(W):
            for g in range(G):
                for k in range(g * gs, (g + 1) * gs):
                    v = int(digits[ti, w, k])
                    if v:
                        i = ((ti * W + w) * B + v - 1) * G + g
                        want[i] = want[i].add(host[k])
    assert dec == want


def test_madd_buckets_wrapper_checks_and_counts_no_cpu_launch():
    ck, S = _bucket_case(GRUMPKIN, 13, t=1, n=16)
    px, py = ck.points.x[:16], ck.points.y[:16]
    before = madd_buckets.launches
    madd_buckets(GRUMPKIN, S, px, py, 4, 4)
    assert madd_buckets.launches == before  # CPU tensors: the twin, no launch
    with pytest.raises(ValueError):
        madd_buckets(GRUMPKIN, S, px, py, 3, 4)  # G does not divide n
    with pytest.raises(ValueError):
        madd_buckets(GRUMPKIN, S, px, py, 4, 6)  # 63 buckets: more than the kernel's mask
    with pytest.raises(ValueError):
        madd_buckets(GRUMPKIN, S, px[:8], py, 4, 4)


def test_msm_many_matches_jax_msm_many_xla_route():
    """t = 2 MSMs over 4096 grumpkin key points (the JAX package's msm_many
    takes its one-hot bucket route from n = 4096; 64 groups there, 256
    here) against the JAX package's, in affine form.  The key's points come
    from the host map (`CommitmentKey.setup`'s below 4096 points: the device
    map gives the same points, slower on a CPU)."""
    n, t = 4096, 2
    stream = hashlib.shake_256(b"torch-madd-buckets").digest(64 * n)
    pts = GRUMPKIN.encode([hash_bytes_to_point(GRUMPKIN.spec, stream[64 * i : 64 * (i + 1)]) for i in range(n)], "cpu")
    limbs, S = _scalars(np.random.default_rng(14), (t, n))
    limbs[1, :7] = 0
    S[1, :7] = 0
    got = msm_many(GRUMPKIN, S, pts)
    jpts = JPoints(*(jnp.asarray(words_to_limbs(c)) for c in pts))
    want = jax_msm_many(J_GRUMPKIN, jnp.asarray(limbs), jpts, window_bits=4, group_count=64, assume_distinct=True)
    assert got == [affine_from(w) for w in want]


# sha256 over the partials' words (x, y, z) of the skewed case below
SKEWED_PARTIALS_SHA256 = "1b9bfaf8bfeeebd72faad040b4719fc2826cdcebabb6360542a8bf2da9f620a7"


def _skewed_plan():
    """n = 300 scalars, skewed: 160 copies of one scalar (long segments cut
    into chunks of 32), 40 zeros, 60 small (a few live windows), 40
    full-width."""
    rng = np.random.default_rng(15)
    _, S = _scalars(rng, (300,))
    S[:160] = S[0]
    S[160:200] = 0
    S[200:260, 1:] = 0
    return S, bucket_plan(S)


def test_msm_accumulate_plain_partials_unchanged_at_skewed_digits():
    curve = BN256_G1
    ck = CommitmentKey.setup(curve, 9, b"torch-madd-buckets", use_cache=False, device="cpu")
    S, plan = _skewed_plan()
    px, py = ck.points.x[:300], ck.points.y[:300]
    parts = mk.msm_accumulate_plain(curve, plan.entries, plan.chunk_start, plan.chunk_len, px, py)
    assert int(plan.chunk_len.max()) == 32 and int(plan.chunk_len.min()) >= 1
    digest = hashlib.sha256(b"".join(c.numpy().tobytes() for c in parts)).hexdigest()
    assert digest == SKEWED_PARTIALS_SHA256
    host = ck.host_points()
    dec = curve.decode(parts)
    for i, (s, ln) in enumerate(zip(plan.chunk_start.tolist(), plan.chunk_len.tolist())):
        acc = gold.identity(curve.spec)
        for e in plan.entries[s : s + ln].tolist():
            pt = host[e >> 1]
            acc = acc.add(pt.neg() if e & 1 else pt)
        assert dec[i] == acc
