"""The CUDA kernels against their plain torch twins on an NVIDIA GPU.

Needs a card (marker `gpu`; skipped elsewhere) and imports no jax, so it
also runs where only torch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from sirius_tpu_torch.curves.jpoint import BN256_G1, GRUMPKIN, Points
from sirius_tpu_torch.fields import gold
from sirius_tpu_torch.fields.constants import bn256_fr
from sirius_tpu_torch.fields.jfield import FQ, FR, ints_to_words
from sirius_tpu_torch.ops import field_kernels as fk
from sirius_tpu_torch.ops import microbench as mb
from sirius_tpu_torch.ops import msm_kernels as mk
from sirius_tpu_torch.ops import ntt_kernels
from sirius_tpu_torch.ops.commitment import CommitmentKey
from sirius_tpu_torch.ops.madd import madd_batch, madd_plain
from sirius_tpu_torch.ops.msm import best_msm, bucket_plan, msm_many
from sirius_tpu_torch.ops.ntt import NTT, _bit_reverse_indices
from sirius_tpu_torch.util.interop import limbs_to_words

CURVES = [BN256_G1, GRUMPKIN]
IDS = ["bn256_g1", "grumpkin"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda")


def _key(curve, device):
    return CommitmentKey.setup(curve, 10, b"torch-gpu-test", use_cache=False, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("curve", CURVES, ids=IDS)
def test_madd_kernel_bit_exact(cuda_device, curve):
    ck = _key(curve, cuda_device)
    n = 512
    P = Points(*(c.clone() for c in curve.dbl(Points(*(c[n:] for c in ck.points)))))
    for c, i in zip(P, curve.identity((8,), cuda_device)):
        c[:8] = i
    qx, qy = ck.points.x[:n].contiguous(), ck.points.y[:n].contiguous()
    before = madd_batch.launches
    got = madd_batch(curve, P, qx, qy)
    assert madd_batch.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, madd_plain(curve, P, qx, qy)))


@pytest.mark.gpu
@pytest.mark.parametrize("curve", CURVES, ids=IDS)
def test_msm_kernels_match_twins_and_gold(cuda_device, curve):
    ck = _key(curve, cuda_device)
    n = 1024
    q = curve.spec.scalar.modulus
    rng = np.random.default_rng(3)
    # every 64th scalar full-width, the rest 60-bit: the gold model is slow
    ints = [int.from_bytes(rng.bytes(32), "little") % q >> (0 if i % 64 == 0 else 194) for i in range(n)]
    ints[:3] = [0, q - 1, q - 1]
    S = torch.from_numpy(ints_to_words(ints)).to(cuda_device)
    plan = bucket_plan(S)
    args = (curve, plan.entries, plan.chunk_start, plan.chunk_len, ck.points.x, ck.points.y)
    parts = mk.msm_accumulate(*args)
    assert all(torch.equal(a, b) for a, b in zip(parts, mk.msm_accumulate_plain(*args)))
    buckets = mk.msm_reduce(curve, plan.seg_off, parts)
    assert curve.decode(buckets) == curve.decode(mk.msm_reduce_plain(curve, plan.seg_off, parts))
    shaped = Points(*(b.reshape(1, plan.W, plan.B, 8) for b in buckets))
    out = mk.msm_combine(curve, shaped, plan.c)
    assert curve.decode(out) == curve.decode(mk.msm_combine_plain(curve, shaped, plan.c))
    want = gold.msm(ints, ck.host_points())
    assert curve.decode(out)[0] == want
    assert best_msm(curve, S, ck.points) == want
    assert msm_many(curve, S[None], ck.points) == [want]


@pytest.mark.gpu
def test_col_ntt_kernel_bit_exact(cuda_device):
    """B4 at (size 1024, R 64) against its plain twin, both directions."""
    size, R = 1024, 64
    rng = np.random.default_rng(4)
    a = FR.random((size, R), rng, cuda_device)
    rev = torch.from_numpy(_bit_reverse_indices(10)).to(cuda_device)
    ctx = NTT(FR, 20, cuda_device)  # its pass-1 tables are of order 1024
    for table in (ctx.inner[False], ctx.inner[True]):
        before = ntt_kernels.col_ntt.launches
        got = ntt_kernels.col_ntt(FR, a, rev, table)
        assert ntt_kernels.col_ntt.launches == before + 1
        assert torch.equal(got, ntt_kernels.col_ntt_plain(FR, a, rev, table))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [21, 23], ids=["size2048", "size4096"])
def test_col_ntt_kernel_above_48kb_shared_memory(cuda_device, k):
    """B4 at the pass-1 column sizes of k = 21 and 23 (64 KB and 128 KB
    columns: dynamic shared memory above 48 KB) against its plain twin."""
    ctx = NTT(FR, k, cuda_device)
    a = FR.random((ctx.n1, 8), np.random.default_rng(k), cuda_device)
    for table in (ctx.inner[False], ctx.inner[True]):
        before = ntt_kernels.col_ntt.launches
        got = ntt_kernels.col_ntt(FR, a, ctx.rev_n1, table)
        assert ntt_kernels.col_ntt.launches == before + 1
        assert torch.equal(got, ntt_kernels.col_ntt_plain(FR, a, ctx.rev_n1, table))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [20, 21, 24], ids=["1024x1024", "2048x1024", "4096x4096"])
def test_col_ntt_epilogue_bit_exact(cuda_device, k):
    """B4's epilogue variant (pass 1 times the mid twiddle, transposed) at the
    four-step's first-pass shapes of k = 20, 21 (odd k: n1 = 2 n2) and 24,
    both directions, word for word its twin (the ladder, mul_rows_plain,
    transpose)."""
    ctx = NTT(FR, k, cuda_device)
    M = FR.random((ctx.n1, ctx.n2), np.random.default_rng(k), cuda_device)
    for inverse in (False, True):
        T = ctx.mid_twiddle(inverse)
        before = (ntt_kernels.col_ntt.launches, ntt_kernels.col_ntt.mid_launches)
        got = ntt_kernels.col_ntt(FR, M, ctx.rev_n1, ctx.inner[inverse], T)
        assert (ntt_kernels.col_ntt.launches, ntt_kernels.col_ntt.mid_launches) == (before[0] + 1, before[1] + 1)
        assert got.shape == (ctx.n2, ctx.n1, 8)
        assert torch.equal(got, ntt_kernels.col_ntt_plain(FR, M, ctx.rev_n1, ctx.inner[inverse], T))
        del got


@pytest.mark.gpu
@pytest.mark.parametrize("rep", [1, 4], ids=["rep1", "rep4"])
def test_mul_rows_k1_bit_exact_every_product(cuda_device, rep):
    """mul_rows at K = 1 (the NTT's product) at 2^20 rows, b of n / rep rows
    (no modulo) and of 3 rows (the coset powers' wrap), on every product:
    word for word its twin."""
    n = 1 << 20
    rng = np.random.default_rng(rep)
    a = FR.random((n,), rng, cuda_device)
    for nb in (n // rep, 3):
        b = FR.random((nb,), rng, cuda_device)
        want = fk.mul_rows_plain(FR, a, b, 1, rep)
        for product in fk.PRODUCTS:
            before = fk.mul_rows.launches
            assert torch.equal(fk.mul_rows(FR, a, b, 1, rep, product=product), want), (nb, product)
            assert fk.mul_rows.launches == before + 1
    assert fk.mul_rows_kernel_attrs()["numRegs"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("rep", [1, 4], ids=["rep1", "rep4"])
def test_mul_rows_k3_bit_exact_every_product(cuda_device, rep):
    """mul_rows at K = 3 (one chain a thread) on a ragged row count, b of
    n / rep rows and of 3 rows, on every product: word for word its twin."""
    n = 4000
    rng = np.random.default_rng(10 + rep)
    a = FR.random((n,), rng, cuda_device)
    for nb in (n // rep, 3):
        b = FR.random((nb,), rng, cuda_device)
        want = fk.mul_rows_plain(FR, a, b, 3, rep)
        for product in fk.PRODUCTS:
            assert torch.equal(fk.mul_rows(FR, a, b, 3, rep, product=product), want), (nb, product)


@pytest.mark.gpu
def test_ntt_k20_is_two_col_ntt_launches(cuda_device):
    """The 2^20 forward and inverse transforms (mid twiddles built first) are
    two B4 launches each, the first its epilogue variant, and no mul_rows;
    the coset transforms add one mul_rows each; round trips are exact."""
    ctx = NTT(FR, 20, cuda_device)
    ctx.mid_twiddle(False)
    ctx.mid_twiddle(True)
    a = FR.random((1 << 20,), np.random.default_rng(20), cuda_device)
    counts = lambda: (ntt_kernels.col_ntt.launches, ntt_kernels.col_ntt.mid_launches, fk.mul_rows.launches)  # noqa: E731
    before = counts()
    out = ctx.fft(a)
    assert counts() == (before[0] + 2, before[1] + 1, before[2])
    back = ctx.ifft(out)
    assert counts() == (before[0] + 4, before[1] + 2, before[2])
    assert torch.equal(back, a)
    assert torch.equal(ctx.coset_ifft(ctx.coset_fft(a)), a)
    assert counts() == (before[0] + 8, before[1] + 4, before[2] + 2)
    attrs = [ntt_kernels.col_ntt_kernel_attrs(name) for name in ntt_kernels.KERNELS]
    assert all(x["numRegs"] > 0 for x in attrs)


@pytest.mark.gpu
def test_ntt_k21_round_trip_and_direct_sums(cuda_device):
    """The 2^21 transform (n1 = 2048) against direct sums at a few points."""
    k = 21
    xs = [int(x) for x in np.random.default_rng(21).integers(0, 2**62, size=1 << k)]
    ctx = NTT(FR, k, cuda_device)
    a = FR.encode(xs, cuda_device)
    out = ctx.fft(a)
    assert torch.equal(ctx.ifft(out), a)
    p, w = FR.p, gold.omega_for_k(bn256_fr, k)
    for j in (1, 654321):
        wj, cur, acc = pow(w, j, p), 1, 0
        for v in xs:
            acc += v * cur
            cur = cur * wj % p
        assert FR.decode(out[j : j + 1]) == [acc % p]


@pytest.mark.gpu
def test_ntt_refuses_columns_beyond_the_kernel(cuda_device):
    """B4 refuses a column above MAX_SIZE; k = 24 (columns of 4096) runs on
    B4 columns directly, k = 25 (8192) through nested four-steps."""
    assert NTT(FR, 24, cuda_device).n1 == ntt_kernels.MAX_SIZE
    size = 2 * ntt_kernels.MAX_SIZE
    a = FR.zeros((size, 1), cuda_device)
    rev = torch.arange(size, device=cuda_device)
    with pytest.raises(ValueError, match="does not fit"):
        ntt_kernels.col_ntt(FR, a, rev, FR.zeros((size // 2,), cuda_device))
    ctx = NTT(FR, 25, cuda_device)
    assert ctx.inner is None and ctx.outer is not None


@pytest.mark.gpu
def test_ntt_k25_round_trip_and_direct_sums(cuda_device):
    """The 2^25 transform (pass-1 columns of 8192 as nested 128 x 64
    four-steps; 2 GB per tensor) on standard-form words: the round trip is
    exact and two values equal the direct sums."""
    k = 25
    xs = np.random.default_rng(25).integers(0, 2**62, size=1 << k, dtype=np.int64)
    words = np.zeros((1 << k, 8), dtype=np.int64)
    words[:, 0], words[:, 1] = xs & 0xFFFFFFFF, xs >> 32
    a = torch.from_numpy(words).to(cuda_device)
    ctx = NTT(FR, k, cuda_device)
    before = ntt_kernels.col_ntt.launches
    out = ctx.fft(a)
    assert ntt_kernels.col_ntt.launches == before + 3  # two nested passes, then pass 2 on B4
    assert torch.equal(ctx.ifft(out), a)
    p, w = FR.p, gold.omega_for_k(bn256_fr, k)
    vals = xs.tolist()
    for j in (1, 23456789):
        wj, acc = pow(w, j, p), 0
        for v in reversed(vals):  # Horner: sum_i x_i wj^i
            acc = (acc * wj + v) % p
        got = sum(int(word) << (32 * i) for i, word in enumerate(out[j].tolist()))
        assert got == acc


@pytest.mark.gpu
def test_msm_reduce_rolled_matches_reduce_at_the_primary_commit_shape(cuda_device):
    """S1 on the level-0 partials of a 917,504-point bn256 commit (7 advice
    columns x 2^17 rows): equal to B3 msm_reduce in affine form (S1 walks
    each segment serially, msm_reduce sums it by a tree), and msm_reduce
    word for word equal to the plain twin (the same halving order)."""
    from sirius_tpu_torch.ops.msm import FAN_IN, split_segments

    n = 7 << 17
    rng = np.random.default_rng(7)
    limbs = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.uint32)
    limbs[:, 15] &= 0x0FFF
    S = torch.from_numpy(limbs_to_words(limbs)).to(cuda_device)
    plan = bucket_plan(S)
    ck = CommitmentKey.setup(BN256_G1, 14, b"torch-gpu-test", use_cache=False, device=cuda_device)
    n_parts = int(plan.seg_off[-1])
    reps = -(-n_parts // len(ck))
    parts = BN256_G1.dbl(Points(*(c.repeat(reps, 1)[:n_parts].contiguous() for c in ck.points)))
    sub_off, _ = split_segments(plan.seg_off, FAN_IN)
    before = (mk.msm_reduce.launches, mk.msm_reduce_rolled.launches)
    got = mk.msm_reduce_rolled(BN256_G1, sub_off, parts)
    ref = mk.msm_reduce(BN256_G1, sub_off, parts)
    assert (mk.msm_reduce.launches, mk.msm_reduce_rolled.launches) == (before[0] + 1, before[1] + 1)
    assert BN256_G1.decode(got) == BN256_G1.decode(ref)
    assert all(torch.equal(a, b) for a, b in zip(ref, mk.msm_reduce_plain(BN256_G1, sub_off, parts)))
    attrs = [mk.msm_kernel_attrs(name) for name in mk.MSM_KERNELS]
    assert all(a["numRegs"] > 0 for a in attrs)


def _tiled_key(curve, device, n):
    """(px, py) of n rows: a 2^14 key tiled (the memory of an n-point key;
    repeated values run the same formulas, so kernel and twin still agree
    word for word)."""
    ck = CommitmentKey.setup(curve, 14, b"torch-gpu-test", use_cache=False, device=device)
    reps = -(-n // len(ck))
    return tuple(c.repeat(reps, 1)[:n].contiguous() for c in (ck.points.x, ck.points.y))


def _random_scalars(device, shape, seed):
    limbs = np.random.default_rng(seed).integers(0, 1 << 16, size=(*shape, 16), dtype=np.uint32)
    limbs[..., 15] &= 0x0FFF
    return torch.from_numpy(limbs_to_words(limbs)).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("curve,n", [(GRUMPKIN, 7 << 14), (BN256_G1, 7 << 17)], ids=["support_W", "primary_W"])
def test_bucket_sort_and_accumulate_bit_exact_at_the_ivc_shapes(cuda_device, curve, n):
    """B2 at the IVC path's two W-commit shapes (114,688 grumpkin and
    917,504 bn256 scalars, c = 10), a third of the scalars repeated (long
    segments): the counting sort equals bucket_plan_plain, the accumulate
    equals its twin word for word."""
    from sirius_tpu_torch.ops.msm import bucket_plan_plain

    S = _random_scalars(cuda_device, (n,), n)
    S[: n // 3] = S[0]
    S[n // 3 : n // 3 + 100] = 0
    px, py = _tiled_key(curve, cuda_device, n)
    before = (bucket_plan.launches, mk.msm_accumulate.launches)
    plan = bucket_plan(S)
    want = bucket_plan_plain(S)
    for k in ("entries", "chunk_start", "chunk_len", "seg_off"):
        assert torch.equal(getattr(plan, k), getattr(want, k)), k
    args = (curve, plan.entries, plan.chunk_start, plan.chunk_len, px, py)
    got = mk.msm_accumulate(*args)
    assert (bucket_plan.launches, mk.msm_accumulate.launches) == (before[0] + 1, before[1] + 1)
    assert all(torch.equal(a, b) for a, b in zip(got, mk.msm_accumulate_plain(*args)))


@pytest.mark.gpu
def test_madd_buckets_bit_exact_at_msm_many_shape(cuda_device):
    """B1's bucket walk at the support cross terms' (t = 5, 2^14 points,
    256 groups, 4-bit windows), with zero and repeated scalars: word for
    word its twin (the per-step loop), and msm_many through it equals
    best_msm with one launch."""
    from sirius_tpu_torch.ops.madd import madd_buckets, madd_buckets_plain, madd_kernel_attrs

    t, n = 5, 1 << 14
    ck = CommitmentKey.setup(GRUMPKIN, 14, b"torch-gpu-test", use_cache=False, device=cuda_device)
    S = _random_scalars(cuda_device, (t, n), 5)
    S[0, :300] = 0
    S[1, 100:400] = S[1, 99]
    px, py = ck.points.x.contiguous(), ck.points.y.contiguous()
    before = madd_buckets.launches
    got = madd_buckets(GRUMPKIN, S, px, py, 256, 4)
    assert madd_buckets.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, madd_buckets_plain(GRUMPKIN, S, px, py, 256, 4)))
    before = (madd_buckets.launches, madd_batch.launches)
    assert msm_many(GRUMPKIN, S[:2], ck.points) == [best_msm(GRUMPKIN, S[i], ck.points) for i in range(2)]
    assert (madd_buckets.launches, madd_batch.launches) == (before[0] + 1, before[1])
    assert madd_kernel_attrs("madd_buckets")["numRegs"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("field", [FR, FQ], ids=["bn256_fr", "bn256_fq"])
def test_cc_product_bit_exact(cuda_device, field):
    """The carry-chain products (B1's, B2's and B4's, and its rolled form,
    B3's) against the plain product, beside the C++ ones, on 2^17 random
    elements and on the edge values 0, 1, p - 1 and R mod p (every pair),
    K = 1 and 4."""
    rng = np.random.default_rng(17)
    a = field.random((1 << 17,), rng, cuda_device)
    b = field.random((1 << 17,), rng, cuda_device)
    edge = torch.from_numpy(ints_to_words([0, 1, field.p - 1, (1 << 256) % field.p])).to(cuda_device)
    a[:16] = edge.repeat_interleave(4, 0)
    b[:16] = edge.repeat(4, 1)
    for K in (1, 4):
        want = fk.mul_rows_plain(field, a, b, K)
        for product in fk.PRODUCTS:
            assert torch.equal(fk.mul_rows(field, a, b, K, product=product), want), product


@pytest.mark.gpu
@pytest.mark.parametrize("field", [FR, FQ], ids=["bn256_fr", "bn256_fq"])
def test_wide_product_bit_exact(cuda_device, field):
    """The wide product (B1's batched madd) against fe_mul's words (the
    unrolled product) and the plain product on 2^16 random elements and the
    edge values 0, 1, p - 1 and R mod p (every pair), K = 1, 3 and 8, and
    S2's instance on it built with no spill."""
    rng = np.random.default_rng(18)
    a = field.random((1 << 16,), rng, cuda_device)
    b = field.random((1 << 16,), rng, cuda_device)
    edge = torch.from_numpy(ints_to_words([0, 1, field.p - 1, (1 << 256) % field.p])).to(cuda_device)
    a[:16] = edge.repeat_interleave(4, 0)
    b[:16] = edge.repeat(4, 1)
    for K in (1, 3, 8):
        want = fk.mul_rows_plain(field, a, b, K)
        got = fk.mul_rows(field, a, b, K, product="wide")
        assert torch.equal(got, want), K
        assert torch.equal(got, fk.mul_rows(field, a, b, K, product="unrolled")), K
    assert fk.mul_rows_kernel_attrs("wide")["localSizeBytes"] == 0


def _madd_operands(curve, device, n, seed):
    """n Jacobian P (doubled points of a 2^10 key, z != 1; rows 0-63 and the
    last the identity) and affine Q of the same key at other indices."""
    ck = _key(curve, device)
    rng = np.random.default_rng(seed)
    i = torch.from_numpy(rng.integers(0, len(ck), size=n)).to(device)
    j = (i + torch.from_numpy(rng.integers(1, len(ck), size=n)).to(device)) % len(ck)
    P = Points(*(c[j].contiguous() for c in curve.dbl(ck.points)))
    for c, e in zip(P, curve.identity((1,), device)):
        c[:64] = e
        c[-1] = e[0]
    return P, ck.points.x[i].contiguous(), ck.points.y[i].contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [81920, 81920 + 77], ids=["81920", "ragged"])
@pytest.mark.parametrize("curve", CURVES, ids=IDS)
def test_madd_batch_bit_exact_at_the_timed_shape(cuda_device, curve, n):
    """B1's batched madd at the timed 81,920 lanes and at a ragged n (a last
    block partly idle), identity rows included: one launch, word for word
    madd_plain."""
    from sirius_tpu_torch.ops.madd import madd_kernel_attrs

    P, qx, qy = _madd_operands(curve, cuda_device, n, n)
    before = madd_batch.launches
    got = madd_batch(curve, P, qx, qy)
    assert madd_batch.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, madd_plain(curve, P, qx, qy)))
    assert madd_kernel_attrs("madd")["numRegs"] > 0


@pytest.mark.gpu
def test_madd_batch_copies_an_unaligned_operand(cuda_device):
    """An operand whose rows start 8 bytes off 16-byte alignment (a view one
    word into its storage) is copied, not refused and not read unaligned:
    the result equals the twin's."""
    P, qx, qy = _madd_operands(GRUMPKIN, cuda_device, 1000, 3)
    store = torch.empty(1000 * 8 + 1, dtype=torch.int64, device=cuda_device)
    off = store[1:].view(1000, 8)
    off.copy_(qx)
    assert off.data_ptr() % 16 == 8
    want = madd_plain(GRUMPKIN, P, qx, qy)
    before = madd_batch.launches
    got = madd_batch(GRUMPKIN, Points(P.x, P.y, P.z), off, qy)
    assert madd_batch.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _jacobian_points(curve, device, n, seed):
    """n Jacobian points (z != 1) of a 2^10 key, doubled, cycled."""
    ck = _key(curve, device)
    pts = curve.dbl(Points(*(c.contiguous() for c in ck.points)))
    idx = torch.from_numpy(np.random.default_rng(seed).integers(0, len(ck), size=n)).to(device)
    return Points(*(c[idx].contiguous() for c in pts))


@pytest.mark.gpu
def test_msm_reduce_tree_segment_lengths(cuda_device):
    """B3's tree reduce on segments of 0, 1, 2, 31 and 32 partials, with an
    equal pair (the doubling branch), an inverse pair and an identity
    partial: word for word its twin; a segment of 33 is refused."""
    curve = BN256_G1
    lens = [0, 1, 2, 31, 32, 5, 0, 32, 17, 31, 2, 1] * 40 + [0, 0]
    n = sum(lens)
    parts = _jacobian_points(curve, cuda_device, n, 5)
    # the 31-segment holds rows 3..33, the 32-segment rows 34..65; the first
    # tree level adds offset i + 16 onto offset i
    for c in parts:
        c[19] = c[3]  # an equal pair: the doubling branch
    neg = curve.neg(Points(*(c[34:35] for c in parts)))
    ident = curve.identity((1,), cuda_device)
    for c, v, z in zip(parts, neg, ident):
        c[50] = v[0]  # an inverse pair: the identity
        c[40] = z[0]  # an identity partial
    seg_off = torch.tensor([0, *np.cumsum(lens)], dtype=torch.int64, device=cuda_device)
    before = mk.msm_reduce.launches
    got = mk.msm_reduce(curve, seg_off, parts)
    assert mk.msm_reduce.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, mk.msm_reduce_plain(curve, seg_off, parts)))
    assert curve.decode(got) == curve.decode(mk.msm_reduce_rolled(curve, seg_off, parts))
    with pytest.raises(ValueError, match="at most 32"):
        mk.msm_reduce(curve, torch.tensor([0, 33], device=cuda_device), parts)


@pytest.mark.gpu
@pytest.mark.parametrize("curve", CURVES, ids=IDS)
def test_msm_reduce_rolled_segment_lengths(cuda_device, curve):
    """S1 on segments of 0, 1, 2, 31, 32, 33, span - 1, span, span + 1 and
    5,000 partials (the last in 20 pieces: two launches), with an equal
    pair, an inverse pair and an identity partial: in affine form the plain
    twin's, and msm_reduce's on the segments msm_reduce takes (at most 32)."""
    span = mk.ROLLED_SPAN
    lens = [0, 1, 2, 31, 32, 33, span - 1, span, span + 1, 5000, 3]
    n = sum(lens)
    parts = _jacobian_points(curve, cuda_device, n, 8)
    # the 31-segment holds rows 3..33: its first level adds row 4 onto row 3
    for c in parts:
        c[4] = c[3]  # an equal pair: the doubling branch
    neg = curve.neg(Points(*(c[40:41] for c in parts)))
    ident = curve.identity((1,), cuda_device)
    for c, v, z in zip(parts, neg, ident):
        c[41] = v[0]  # an inverse pair (rows 40, 41 of the 32-segment): the identity
        c[50] = z[0]  # an identity partial
    seg_off = torch.tensor([0, *np.cumsum(lens)], dtype=torch.int64, device=cuda_device)
    before = mk.msm_reduce_rolled.launches
    got = mk.msm_reduce_rolled(curve, seg_off, parts)
    assert mk.msm_reduce_rolled.launches == before + 2
    assert curve.decode(got) == curve.decode(mk.msm_reduce_rolled_plain(curve, seg_off, parts))
    short = seg_off[:6]  # lengths 0, 1, 2, 31, 32
    assert curve.decode(mk.msm_reduce_rolled(curve, short, parts)) == curve.decode(mk.msm_reduce(curve, short, parts))


@pytest.mark.gpu
@pytest.mark.parametrize("curve,t,W,B,c", [(BN256_G1, 2, 27, 512, 10), (GRUMPKIN, 5, 64, 15, 4),
                                           (BN256_G1, 2, 5, 300, 9)],
                         ids=["best_msm_c10", "msm_many_c4", "ragged_B300"])
def test_msm_combine_kernels_match_twins(cuda_device, curve, t, W, B, c):
    """B3's window sums and Horner at both shapes of the IVC path (best_msm's
    (1, 27, 512) with t = 2, msm_many's (5, 64, 15)) and at B = 300 (the
    last bucket segment ragged), in affine form against the twins; window 1
    of MSM 0 all identities; in window 2 equal buckets and a bucket beside
    its negation."""
    bk = _jacobian_points(curve, cuda_device, t * W * B, W)
    bk = Points(*(a.reshape(t, W, B, 8).clone() for a in bk))
    ident = curve.identity((B,), cuda_device)
    for a, v in zip(bk, ident):
        a[0, 1] = v
    neg = curve.neg(Points(*(a[0, 2, B - 1] for a in bk)))
    for a, v in zip(bk, neg):
        a[0, 2, 1] = a[0, 2, 2]  # equal buckets: an add takes the doubling branch
        a[0, 2, B - 2] = v  # B_(B-1) = -B_B: the top running sum passes through the identity
    before = (mk.msm_window_sums.launches, mk.msm_combine.launches)
    tot = mk.msm_window_sums(curve, bk)
    want = mk.suffix_window_sums(curve, bk)
    flat = lambda P: Points(*(a.reshape(-1, 8) for a in P))  # noqa: E731
    assert curve.decode(flat(tot)) == curve.decode(flat(want))
    L = 1 << mk.window_log2(B)
    assert curve.decode(flat(mk.msm_window_sums_plain(curve, bk, L))) == curve.decode(flat(want))
    out = mk.msm_combine(curve, bk, c)
    assert (mk.msm_window_sums.launches, mk.msm_combine.launches) == (before[0] + 2, before[1] + 1)
    assert curve.decode(out) == curve.decode(mk.msm_combine_plain(curve, bk, c))


@pytest.mark.gpu
def test_protogalaxy_prove_on_the_card_equals_the_cpu(cuda_device):
    """ProtoGalaxy new + prove (L = 1) on fibo traces at k = 4 with a real
    key: the card's accumulator and proof equal the CPU run of the port."""
    from sirius_tpu_torch.fields.constants import bn256_g1
    from sirius_tpu_torch.frontend.runner import CircuitRunner
    from sirius_tpu_torch.nifs.protogalaxy import AccumulatorInstance, ProtoGalaxy
    from sirius_tpu_torch.ops.poseidon import PoseidonHash, poseidon_spec
    from sirius_tpu_torch.plonk.sps import run_sps_protocol
    from sirius_tpu_torch.util.golden import pg_acc_digest

    from fixtures import FiboCircuit

    p = bn256_fr.modulus

    def run(device):
        ck = CommitmentKey.setup(BN256_G1, 7, b"pg-test", use_cache=False, device=device)
        circuits = [FiboCircuit(1, 1, 10), FiboCircuit(2, 3, 10)]
        S = CircuitRunner(4, bn256_fr, circuits[0], circuits[0].instances(p)).collect_plonk_structure()
        ro = lambda: PoseidonHash(poseidon_spec(bn256_fr, 3, 2, 4, 3))  # noqa: E731
        traces = [run_sps_protocol(S, ck, c.instances(p), CircuitRunner(4, bn256_fr, c, c.instances(p))
                                   .collect_witness(), ro()) for c in circuits]
        pp, _ = ProtoGalaxy.setup_params(gold.identity(bn256_g1), S)
        acc = ProtoGalaxy.new_accumulator(pp, ro(), traces[0], bn256_g1)
        new_acc, proof = ProtoGalaxy.prove(ck, pp, ro(), acc, traces[1:])
        assert ProtoGalaxy.is_sat(ck, S, new_acc) == []
        return (pg_acc_digest(AccumulatorInstance.from_acc(new_acc)), proof.poly_F.coeffs, proof.poly_K.coeffs,
                [w.cpu() for w in new_acc.trace.w.W])

    card, cpu = run(cuda_device), run("cpu")
    assert card[:3] == cpu[:3]
    assert all(torch.equal(a, b) for a, b in zip(card[3], cpu[3]))


RING_OPS = ["add", "sub", "neg", "double", "mul", "square"]


def _ring_operands(field, seed: int, device) -> dict:
    """Operands on `device` of each broadcast form the ring ops' call sites
    use, by name: (a, b), the same values for a seed on every device; b is
    unused by the one-operand ops."""
    rng = np.random.default_rng(seed)
    rows, other = (field.random((4099,), rng, "cpu").to(device) for _ in range(2))  # ragged
    s, t = (field.random((), rng, "cpu").to(device) for _ in range(2))  # (8,) scalars
    nodes = field.random((2048, 3), rng, "cpu").to(device)  # a level of the pow tree: (N / 2, h + 1, 8) nodes
    P = field.random((4096, 3), rng, "cpu").to(device)
    return {"rows_rows": (rows, other), "rows_scalar": (rows, s), "scalar_rows": (s, rows),
            "nodes_scalar": (nodes, s), "scalar_scalar": (s, t),
            "strided_rows": (P[0::2, 0], P[1::2, 2]),  # a column of a wider table, every other row: row stride 6
            "strided_nodes": (P[1::2], s),  # P[1::2] of the pow tree's nodes: no one row stride
            "empty": (rows[:0], s)}


def _kernels_launched(fn, *args):
    """fn(*args) and the kernels it launched on the card (torch.profiler's
    CUDA events, not copies to or from the host or fills)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn(*args)
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    return out, [e.name() for e in events if e.device_type() == torch.autograd.DeviceType.CUDA
                 and not e.name().startswith(("Memcpy", "Memset"))]


@pytest.mark.gpu
@pytest.mark.parametrize("op", RING_OPS)
@pytest.mark.parametrize("field", [FR, FQ], ids=["bn256_fr", "bn256_fq"])
def test_field_ring_op_on_the_card_is_one_launch_equal_to_the_cpu(cuda_device, field, op):
    """`Field.add`, `sub`, `neg`, `double`, `mul` and `square` on CUDA
    tensors, at every broadcast form of the call sites (strided views and an
    empty batch included), equal the same op on CPU copies word for word.
    Each is one kernel on the card, counted by `ring_op.launches`, by the
    library's count under "ring_op" (apart from the wrappers' own counts,
    which do not move) and by the profiler: none for the empty batch, and a
    copy before it only where an operand's rows have no one row stride."""
    from sirius_tpu_torch.ops import _build

    on_cpu = _ring_operands(field, len(op), "cpu")
    for form, (a, b) in _ring_operands(field, len(op), cuda_device).items():
        args = (a, b) if op in ("add", "sub", "mul") else (a,)
        counts = lambda: (sum(fk.ring_op.launches.values()),  # noqa: E731
                          _build.device_launches[("ring_op", str(a.device))], sum(_build.device_launches.values()),
                          fk.addsub_rows.launches + fk.mul_rows.launches)
        before = counts()
        got, kernels = _kernels_launched(getattr(field, op), *args)
        after = counts()
        want = getattr(field, op)(*on_cpu[form][: len(args)])
        assert got.is_cuda and torch.equal(got.cpu(), want), form
        launches = 0 if form == "empty" else 1
        assert after == (before[0] + launches, before[1] + launches, before[2] + launches, before[3]), form
        ring = [k for k in kernels if "addsub_rows_kernel" in k or "mul_rows_kernel" in k]
        assert len(ring) == launches, (form, kernels)
        assert len(kernels) == launches + (form == "strided_nodes"), (form, kernels)


@pytest.mark.gpu
def test_compute_K_on_the_card_equals_the_cpu_one_launch_a_ring_op(cuda_device, monkeypatch):
    """`compute_K` (the fold's G sweep, pow tree and witness fold) on fibo
    traces at k = 10 with a real key: the card's K coefficients equal the
    CPU run of the port, and every ring op it makes on the card is one
    kernel launch."""
    from sirius_tpu_torch.fields.constants import bn256_g1
    from sirius_tpu_torch.frontend.runner import CircuitRunner
    from sirius_tpu_torch.nifs import protogalaxy as pg
    from sirius_tpu_torch.ops.poseidon import PoseidonHash, poseidon_spec
    from sirius_tpu_torch.plonk.sps import run_sps_protocol

    from fixtures import FiboCircuit

    p, k = bn256_fr.modulus, 10
    ring_ops = []
    ring_op = fk.ring_op

    def counted(field, op, a, b):
        out = ring_op(field, op, a, b)
        ring_ops.append(out.numel() > 0)
        return out

    monkeypatch.setattr(fk, "ring_op", counted)

    def run(device):
        ck = CommitmentKey.setup(BN256_G1, 11, b"pg-K-test", use_cache=False, device=device)
        circuits = [FiboCircuit(1, 1, 900), FiboCircuit(2, 3, 900)]
        S = CircuitRunner(k, bn256_fr, circuits[0], circuits[0].instances(p)).collect_plonk_structure()
        ro = lambda: PoseidonHash(poseidon_spec(bn256_fr, 3, 2, 4, 3))  # noqa: E731
        traces = [run_sps_protocol(S, ck, c.instances(p), CircuitRunner(k, bn256_fr, c, c.instances(p))
                                   .collect_witness(), ro()) for c in circuits]
        pp, _ = pg.ProtoGalaxy.setup_params(gold.identity(bn256_g1), S)
        acc = pg.ProtoGalaxy.new_accumulator(pp, ro(), traces[0], bn256_g1)
        ctx = pg.PolyContext(S, 1)
        betas = pg.betas_stroke_of(acc.betas, 5, 7, p)
        ring_ops.clear()
        before = sum(ring_op.launches.values())
        K = pg.compute_K(ctx, 11, betas, acc.trace, traces[1:]).coeffs
        return K, sum(ring_op.launches.values()) - before, sum(ring_ops)

    card, cpu = run(cuda_device), run("cpu")
    assert card[0] == cpu[0]
    assert card[2] > 0 and card[1] == card[2]  # one launch a ring op, none off the card
    assert cpu[1] == 0


@pytest.mark.gpu
def test_ntt_k12_matches_gold(cuda_device):
    xs = [int(x) for x in np.random.default_rng(12).integers(0, 2**62, size=1 << 12)]
    ctx = NTT(FR, 12, cuda_device)
    a = FR.encode(xs, cuda_device)
    before = ntt_kernels.col_ntt.launches
    out = ctx.fft(a)
    assert ntt_kernels.col_ntt.launches == before + 2  # the two four-step passes
    assert FR.decode(out) == gold.fft(xs, bn256_fr)
    assert FR.decode(ctx.ifft(out)) == xs
    assert FR.decode(ctx.coset_ifft(ctx.coset_fft(a))) == xs


@pytest.mark.gpu
@pytest.mark.parametrize("field", [FR, FQ], ids=["bn256_fr", "bn256_fq"])
def test_mul_chain_kernel_bit_exact(cuda_device, field):
    rng = np.random.default_rng(2)
    a = field.random((4096,), rng, cuda_device)
    for nb in (4096, 3):
        b = field.random((nb,), rng, cuda_device)
        before = fk.mul_rows.launches
        got = mb.mul_chain(field, a, b, K=8)
        assert fk.mul_rows.launches == before + 1
        assert torch.equal(got, mb.mul_chain_plain(field, a, b, K=8))


@pytest.mark.gpu
def test_raw_u32_and_probe_kernels_match_twins(cuda_device):
    a = torch.from_numpy(np.random.default_rng(3).integers(0, 1 << 32, size=1 << 16, dtype=np.int64)).to(cuda_device)
    a32 = mb.words_of(a)
    for op in ("mul", "add"):
        assert torch.equal(mb.raw_u32(a32, op), mb.raw_u32_plain(a32, op))
    x = a[:1024].reshape(8, 128)
    assert torch.equal(mb.probe_add_one(x), mb.probe_add_one_plain(x))


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["mul", "add"])
def test_raw_u32_kernel_bit_exact_at_a_ragged_length(cuda_device, op):
    """S3 on 2^22 + 3 words (3 past the last group of 4), 0, 1 and
    0xFFFFFFFF among them, at the timed 64 reps (the straight-line chain)
    and the long run's 4096 (its loop), and on a view 4 bytes off 16-byte
    alignment: word for word its twin."""
    rng = np.random.default_rng(4)
    u = rng.integers(0, 1 << 32, size=(1 << 22) + 4, dtype=np.int64)
    u[:3] = [0, 1, 0xFFFFFFFF]
    u[-3:] = [0xFFFFFFFF, 1, 0]
    words = mb.words_of(torch.from_numpy(u).to(cuda_device))
    a = words[:-1]
    for reps in (64, 4096):
        before = mb.raw_u32.launches
        got = mb.raw_u32(a, op, reps)
        assert mb.raw_u32.launches == before + 1 and got.dtype == torch.int32
        assert torch.equal(got, mb.raw_u32_plain(a, op, reps))
    off = words[1:]  # 4 bytes past the allocation's start
    assert torch.equal(mb.raw_u32(off, op), mb.raw_u32_plain(off, op))


def _sangria_k16_digests(device, primary_sc=None):
    """pp digest coordinates and both accumulators' digests after new and
    after one fold_step of the k = 16 Sangria IVC on the mock keys."""
    from sirius_tpu_torch.ivc.sangria_ivc import IVC, PublicParams
    from sirius_tpu_torch.ivc.step_circuit import TrivialStepCircuit
    from sirius_tpu_torch.util.golden import sangria_acc_digest
    from sirius_tpu_torch.util.testing import MockCommitmentKey

    pp = PublicParams(primary_sc or TrivialStepCircuit(1), TrivialStepCircuit(1), 16, 16,
                      MockCommitmentKey(BN256_G1, device), MockCommitmentKey(GRUMPKIN, device))
    ivc = IVC(pp, [0x11], [0x22])
    accs = lambda: (sangria_acc_digest(ivc.primary_relaxed.U), sangria_acc_digest(ivc.secondary_relaxed.U))  # noqa: E731
    new = accs()
    ivc.fold_step()
    assert ivc.verify() == []
    return pp.digest_coords(1), pp.digest_coords(2), new, accs(), list(ivc.primary_z_i)


@pytest.mark.gpu
def test_sangria_ivc_k16_on_the_card_equals_the_frozen_jax_digests(cuda_device):
    """The trivial step on both sides at k = 16 on the mock keys, on the
    card: pp digests and both accumulators after new and one fold_step equal
    the JAX package's run frozen in `util/golden.py`."""
    from sirius_tpu_torch.util import golden

    d1, d2, new, step, _ = _sangria_k16_digests(cuda_device)
    assert (d1, d2) == (golden.SANGRIA_IVC_K16_PP_DIGEST_1, golden.SANGRIA_IVC_K16_PP_DIGEST_2)
    assert new == golden.SANGRIA_IVC_K16_NEW and step == golden.SANGRIA_IVC_K16_STEP


@pytest.mark.gpu
def test_sangria_ivc_poseidon_step_on_the_card_equals_the_cpu(cuda_device):
    """The Poseidon step circuit on the primary (6 cross terms, 1 challenge)
    at k = 16 on the mock keys: the card's run equals the port's CPU run."""
    from sirius_tpu_torch.gadgets.poseidon_step_circuit import PoseidonStepCircuit

    card = _sangria_k16_digests(cuda_device, PoseidonStepCircuit(bn256_fr))
    assert card == _sangria_k16_digests("cpu", PoseidonStepCircuit(bn256_fr))


@pytest.mark.gpu
def test_msm_many_at_the_sangria_cross_terms_shape_bn256(cuda_device):
    """msm_many at a Sangria step's cross terms on bn256 (t = 5, 2^17
    points: 512 points a lane at 256 groups) equals best_msm, in one
    madd_buckets launch."""
    from sirius_tpu_torch.ops.madd import madd_buckets

    t, n = 5, 1 << 17
    ck = CommitmentKey.setup(BN256_G1, 17, b"torch-gpu-test", use_cache=False, device=cuda_device)
    S = _random_scalars(cuda_device, (t, n), 17)
    S[0, : n // 2] = 0
    S[3, 1000:9000] = S[3, 999]
    before = (madd_buckets.launches, madd_batch.launches)
    got = msm_many(BN256_G1, S, ck.points)
    assert (madd_buckets.launches, madd_batch.launches) == (before[0] + 1, before[1])
    assert got == [best_msm(BN256_G1, S[i], ck.points) for i in range(t)]


def _m_count_inputs(name, device):
    """(l, t) Montgomery words for the multiplicity count's cases."""
    rng = np.random.default_rng(29)
    if name == "n1":
        return FR.encode([9], device), FR.encode([9], device)
    if name == "range_table_2^17":  # the range circuit's column: a byte table repeated 512 times
        n = 1 << 17
        t = [row % 256 for row in range(n)]
        l = [int(v) for v in rng.integers(0, 300, size=n)]  # misses above 255
        return FR.encode(l, device), FR.encode(t, device)
    n = {"dups_and_misses_4096": 4096, "ragged_5000": 5000}[name]
    t = [int(v) for v in rng.integers(0, n // 16, size=n)]
    l = [int(v) for v in rng.integers(0, n // 12, size=n)]
    return FR.encode(l, device), FR.encode(t, device)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["dups_and_misses_4096", "ragged_5000", "n1", "range_table_2^17"])
def test_m_count_kernel_equals_the_plain_version(cuda_device, name):
    from sirius_tpu_torch.ops import lookup_kernels
    from sirius_tpu_torch.ops.lookup_kernels import m_count_plain

    l, t = _m_count_inputs(name, cuda_device)
    before = lookup_kernels.m_count.launches
    got = lookup_kernels.m_count(l, t)
    assert lookup_kernels.m_count.launches == before + 1
    want = m_count_plain(l, t)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(want.cpu(), m_count_plain(l.cpu(), t.cpu()))
    assert int(got.sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("vector", [False, True], ids=["range_2_rounds", "vector_3_rounds"])
def test_lookup_sps_on_the_card_equals_the_cpu(cuda_device, vector):
    """The 2- and 3-round SPS of the lookup test circuits at K = 5 with a
    real key: the card's trace (words, commitments, challenges) equals the
    CPU's and the JAX package's frozen digest, and is_sat is clean."""
    from sirius_tpu_torch.fields.constants import bn256_fq
    from sirius_tpu_torch.frontend.runner import CircuitRunner
    from sirius_tpu_torch.ops import lookup_kernels
    from sirius_tpu_torch.ops.poseidon import PoseidonHash, poseidon_spec
    from sirius_tpu_torch.plonk import satisfy
    from sirius_tpu_torch.plonk.sps import run_sps_protocol
    from sirius_tpu_torch.util import golden
    from sirius_tpu_torch.util.testing import RangeCircuit, VectorRangeCircuit

    c = VectorRangeCircuit([2, 3, 5, 7, 11]) if vector else RangeCircuit([3, 7, 15, 0, 1, 1, 5])
    frozen = golden.LOOKUP_VECTOR_K5_TRACE if vector else golden.LOOKUP_RANGE_K5_TRACE
    ro = lambda: PoseidonHash(poseidon_spec(bn256_fq, 3, 2, 4, 3))  # noqa: E731

    def run(device):
        ck = CommitmentKey.setup(BN256_G1, 9, b"lookup-test", use_cache=False, device=device)
        runner = CircuitRunner(5, bn256_fr, c, c.instances())
        S = runner.collect_plonk_structure()
        tr = run_sps_protocol(S, ck, c.instances(), runner.collect_witness(), ro())
        satisfy.is_sat(S, ck, ro(), tr.u, tr.w)
        return tr

    before = lookup_kernels.m_count.launches
    card = run(cuda_device)
    assert lookup_kernels.m_count.launches == before + 1
    cpu = run("cpu")
    assert (card.u.W_commitments, card.u.challenges) == (cpu.u.W_commitments, cpu.u.challenges)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(card.w.W, cpu.w.W))
    assert golden.plonk_trace_digest([w.cpu().numpy() for w in card.w.W], card.u) == frozen


@pytest.mark.gpu
def test_chunked_device_setup_peaks_under_2_gb_at_2_20(cuda_device, monkeypatch):
    """The bn256 2^20 key mapped in chunks of DEVICE_SETUP_CHUNK points
    peaks under 2 GB of device memory, and equals one map of the whole
    stream (DEVICE_SETUP_CHUNK raised to 2^20: the setup before it mapped in
    chunks), which peaks far higher.  Prints both peaks (pytest -s)."""
    from sirius_tpu_torch.ops import commitment as tcommit

    chunked, whole = tcommit.DEVICE_SETUP_CHUNK, 1 << 20
    points, peaks = {}, {}
    for chunk in (chunked, whole):
        monkeypatch.setattr(tcommit, "DEVICE_SETUP_CHUNK", chunk)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        key = CommitmentKey.setup(BN256_G1, 20, b"bench-primary", use_cache=False, device=cuda_device).points
        torch.cuda.synchronize()
        peaks[chunk] = torch.cuda.max_memory_allocated()
        points[chunk] = [c.cpu() for c in key]
        del key
        print(f"bn256 2^20 setup, chunks of {chunk} points: peak device memory {peaks[chunk]} B "
              f"({torch.cuda.get_device_name(0)})")
    assert all(torch.equal(a, b) for a, b in zip(*points.values()))
    assert peaks[chunked] < 2 * 10**9 < peaks[whole]


def _sangria_run(device, primary_sc, k, z0):
    """pp digest coordinates and both accumulators' digests after new and
    after one fold_step of a Sangria IVC (`primary_sc` against
    `TrivialStepCircuit(1)`, k on both curves, mock keys), z after the step;
    verify() is clean."""
    from sirius_tpu_torch.ivc.sangria_ivc import IVC, PublicParams
    from sirius_tpu_torch.ivc.step_circuit import TrivialStepCircuit
    from sirius_tpu_torch.util.golden import sangria_acc_digest
    from sirius_tpu_torch.util.testing import MockCommitmentKey

    pp = PublicParams(primary_sc, TrivialStepCircuit(1), k, k, MockCommitmentKey(BN256_G1, device),
                      MockCommitmentKey(GRUMPKIN, device))
    ivc = IVC(pp, z0, [0])
    accs = lambda: (sangria_acc_digest(ivc.primary_relaxed.U), sangria_acc_digest(ivc.secondary_relaxed.U))  # noqa: E731
    new = accs()
    ivc.fold_step()
    assert ivc.verify() == []
    return pp.digest_coords(1), pp.digest_coords(2), new, accs(), list(ivc.primary_z_i)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["xor_3_rounds", "range_2_rounds"])
def test_sangria_ivc_lookup_steps_on_the_card_equal_the_frozen_jax_digests(cuda_device, name):
    """`XorStepCircuit` (z0 = [5]) and `RangeCheckStepCircuit` (z0 = [7]) as
    the primary at k = 17 on the mock keys, on the card: pp digests, both
    accumulators after new and one fold_step, and z equal the JAX package's
    runs frozen in `util/golden.py`."""
    from sirius_tpu_torch.gadgets.range_step_circuit import RangeCheckStepCircuit
    from sirius_tpu_torch.gadgets.xor_step_circuit import XorStepCircuit
    from sirius_tpu_torch.util import golden

    sc, z0, tag = ((XorStepCircuit(bn256_fr), [5], "XOR") if name.startswith("xor")
                   else (RangeCheckStepCircuit(bn256_fr), [7], "RANGE"))
    d1, d2, new, step, z = _sangria_run(cuda_device, sc, 17, z0)
    frozen = lambda what: getattr(golden, f"SANGRIA_IVC_{tag}_K17_{what}")  # noqa: E731
    assert (d1, d2) == (frozen("PP_DIGEST_1"), frozen("PP_DIGEST_2"))
    assert new == frozen("NEW") and step == frozen("STEP") and z == [frozen("Z")]


@pytest.mark.gpu
def test_cyclefold_sha256_production_on_the_card_equals_the_frozen_jax_digests(cuda_device):
    """The table16-class SHA-256 step at its production size
    (`SpreadSha256StepCircuit`, H = 16, 64 rounds) through Cyclefold at
    k = 18 on the mock keys, on the card, z0 = [0x0123456789ABCDEF]: the pp
    digest and, after new and after one next, z and the ProtoGalaxy and
    support accumulators' and the pending trace's digests equal the JAX
    package's run frozen in `util/golden.py`; verify() is clean."""
    from sirius_tpu_torch.gadgets.spread_sha256 import SpreadSha256StepCircuit
    from sirius_tpu_torch.ivc.cyclefold_ivc import CyclefoldIVC, CyclefoldPublicParams
    from sirius_tpu_torch.util import golden
    from sirius_tpu_torch.util.testing import MockCommitmentKey

    def digests(ivc):
        return golden.cyclefold_digests(ivc, [w.cpu().numpy() for w in ivc.primary_trace.w.W])

    pp = CyclefoldPublicParams(SpreadSha256StepCircuit(bn256_fr, half_bits=16, rounds=64), 18,
                               MockCommitmentKey(BN256_G1, cuda_device), MockCommitmentKey(GRUMPKIN, cuda_device))
    assert pp.digest_hex() == golden.CYCLEFOLD_SHA256_K18_PP
    ivc = CyclefoldIVC(pp, [0x0123456789ABCDEF])
    assert ivc.z_i == [golden.CYCLEFOLD_SHA256_K18_Z[0]] and digests(ivc) == golden.CYCLEFOLD_SHA256_K18_NEW
    ivc.next()
    assert ivc.z_i == [golden.CYCLEFOLD_SHA256_K18_Z[1]] and digests(ivc) == golden.CYCLEFOLD_SHA256_K18_NEXT
    assert ivc.verify() == []


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sha256_k17", "merkle_depth3_k16", "power_degree7_k17"])
def test_sangria_ivc_step_circuits_on_the_card(cuda_device, name):
    """One Sangria fold_step on the mock keys, on the card, verify() == []:
    the main-gate SHA-256 step at k = 17 (tests/test_sangria_ivc.py::
    test_sangria_ivc_sha256_step), the Merkle step (depth 3) at k = 16
    (test_sangria_ivc_merkle_step) and the degree-7 power gate, the largest
    degree of the gate-scaling sweep, at k = 17; z after the step equals the
    host step function's."""
    from sirius_tpu_torch.gadgets.merkle_step_circuit import MerkleStepCircuit
    from sirius_tpu_torch.gadgets.power_step_circuit import PowerStepCircuit
    from sirius_tpu_torch.gadgets.sha256_step_circuit import Sha256StepCircuit, step_fn

    p = bn256_fr.modulus
    if name.startswith("sha256"):
        sc, k, z0 = Sha256StepCircuit(bn256_fr), 17, [0xABCDEF]
        want = step_fn(step_fn(z0[0], p), p)
    elif name.startswith("merkle"):
        sc, k = MerkleStepCircuit(bn256_fr, depth=3), 16
        z0 = [sc.tree.root]
        host = MerkleStepCircuit(bn256_fr, depth=3)
        want = host.process_step(host.process_step(z0, k, bn256_fr), k, bn256_fr)[0]
    else:
        sc, k, z0 = PowerStepCircuit(bn256_fr, degree=7), 17, [3]
        want = (pow((pow(3, 7, p) + 1) % p, 7, p) + 1) % p
    *_, z = _sangria_run(cuda_device, sc, k, z0)
    assert z == [want]


@pytest.mark.gpu
def test_cyclefold_power_step_degree_7_on_the_card(cuda_device):
    """One Cyclefold next of the degree-7 power gate (the gate-scaling
    sweep's largest degree) at k = 17 on the mock keys, on the card:
    verify() == [] and z equal to the host step function's."""
    from sirius_tpu_torch.gadgets.power_step_circuit import PowerStepCircuit
    from sirius_tpu_torch.ivc.cyclefold_ivc import CyclefoldIVC, CyclefoldPublicParams
    from sirius_tpu_torch.util.testing import MockCommitmentKey

    p = bn256_fr.modulus
    pp = CyclefoldPublicParams(PowerStepCircuit(bn256_fr, degree=7), 17, MockCommitmentKey(BN256_G1, cuda_device),
                               MockCommitmentKey(GRUMPKIN, cuda_device))
    assert pp.max_gate_degree == 7  # the power gate, its selector not counted
    ivc = CyclefoldIVC(pp, [3])
    ivc.next()
    assert ivc.z_i == [(pow((pow(3, 7, p) + 1) % p, 7, p) + 1) % p]
    assert ivc.verify() == []


@pytest.mark.gpu
def test_cyclefold_checkpoint_round_trip_of_cuda_tensors(cuda_device, tmp_path):
    """The trivial Cyclefold IVC at k = 17 on the mock keys, on the card:
    checkpoint, resume onto the card (every W round, the support W and E the
    same words), one next on the resumed IVC equal to the JAX package's
    uninterrupted new -> next (`golden.CYCLEFOLD_TRIVIAL_K17_NEXT`), verify()
    == []."""
    from sirius_tpu_torch.ivc.cyclefold_ivc import CyclefoldIVC, CyclefoldPublicParams
    from sirius_tpu_torch.ivc.step_circuit import TrivialStepCircuit
    from sirius_tpu_torch.util import golden
    from sirius_tpu_torch.util.testing import MockCommitmentKey

    pp = CyclefoldPublicParams(TrivialStepCircuit(arity=1), 17, MockCommitmentKey(BN256_G1, cuda_device),
                               MockCommitmentKey(GRUMPKIN, cuda_device))
    ivc = CyclefoldIVC(pp, [0x11])
    path = str(tmp_path / "ckpt")
    ivc.checkpoint(path)
    resumed = CyclefoldIVC.resume(pp, path)

    def tensors(v):
        return [*v.self_acc.trace.w.W, *v.primary_trace.w.W, *v.support_acc.W.W, v.support_acc.W.E]

    assert all(b.device.type == "cuda" and torch.equal(a, b) for a, b in zip(tensors(ivc), tensors(resumed)))
    resumed.next()
    assert golden.cyclefold_digests(resumed, [w.cpu().numpy() for w in resumed.primary_trace.w.W]) == \
        golden.CYCLEFOLD_TRIVIAL_K17_NEXT
    assert resumed.verify() == []


@pytest.mark.gpu
def test_instances_example_on_the_card_equals_the_frozen_jax_digests(cuda_device):
    """examples/instances.py's step (its own public instance column) through
    the port's example `run` at K = 16 on the mock keys, on the card: pp,
    new, one fold_step and verify against `golden.SANGRIA_INSTANCES_K16_*`,
    `sc_instances_hash_acc` included."""
    from sirius_tpu_torch.examples import instances
    from sirius_tpu_torch.util import golden
    from sirius_tpu_torch.util.testing import MockCommitmentKey

    keys = (MockCommitmentKey(BN256_G1, cuda_device), MockCommitmentKey(GRUMPKIN, cuda_device), "mock")
    ivc, t = instances.run(instances.parser().parse_args(["--fold-steps", "0"]), keys=keys)
    assert t["errors"] == []
    assert (ivc.pp.digest_coords(1), ivc.pp.digest_coords(2)) == (golden.SANGRIA_INSTANCES_K16_PP_DIGEST_1,
                                                                  golden.SANGRIA_INSTANCES_K16_PP_DIGEST_2)
    assert golden.sangria_ivc_digest(ivc) == golden.SANGRIA_INSTANCES_K16_NEW_STATE
    ivc.fold_step()
    assert golden.sangria_ivc_digest(ivc) == golden.SANGRIA_INSTANCES_K16_STEP_STATE
    assert ivc.primary_relaxed.U.sc_instances_hash_acc == golden.SANGRIA_INSTANCES_K16_SC_HASH
    assert ivc.primary_z_i == [golden.SANGRIA_INSTANCES_K16_Z]
    assert ivc.verify() == []


@pytest.mark.gpu
def test_to_mont_words_is_one_mul_rows_launch_equal_to_encode(cuda_device):
    """`Field.to_mont_words` on packed standard-form words (int32 holding
    the u32 bits) on the card: one mul_rows launch (K = 1, b = R^2 broadcast),
    the words of `Field.encode`."""
    rng = np.random.default_rng(14)
    for f in (FR, FQ):
        xs = [0, 1, f.p - 1, *(int.from_bytes(rng.bytes(32), "little") % f.p for _ in range(4093))]
        words = torch.from_numpy(ints_to_words(xs).astype(np.uint32).view(np.int32)).to(cuda_device)
        before, shapes = fk.mul_rows.launches, dict(fk.mul_rows.shapes)
        got = f.to_mont_words(words)
        assert fk.mul_rows.launches == before + 1
        assert fk.mul_rows.shapes[(len(xs), 1)] == shapes.get((len(xs), 1), 0) + 1
        assert torch.equal(got, f.encode(xs, cuda_device))


@pytest.mark.gpu
def test_cyclefold_next_on_the_card_replays_the_direct_witness(cuda_device, monkeypatch):
    """The trivial Cyclefold IVC at k = 17 on the mock keys, on the card: the
    next's SFC witness, a native replay of the pp's tape, equals direct
    synthesis word for word, its W round on the card equals the host
    encoding of those columns, and the digests after new and next equal the
    JAX package's (`golden.CYCLEFOLD_TRIVIAL_K17_*`)."""
    from sirius_tpu_torch.ivc.cyclefold_ivc import CyclefoldIVC, CyclefoldPublicParams
    from sirius_tpu_torch.ivc.step_circuit import TrivialStepCircuit
    from sirius_tpu_torch.util import golden
    from sirius_tpu_torch.util.testing import MockCommitmentKey

    def digests(v):
        return golden.cyclefold_digests(v, [w.cpu().numpy() for w in v.primary_trace.w.W])

    pp = CyclefoldPublicParams(TrivialStepCircuit(arity=1), 17, MockCommitmentKey(BN256_G1, cuda_device),
                               MockCommitmentKey(GRUMPKIN, cuda_device))
    assert pp.digest_hex() == golden.CYCLEFOLD_TRIVIAL_K17_PP
    ivc = CyclefoldIVC(pp, [0x11])
    assert digests(ivc) == golden.CYCLEFOLD_TRIVIAL_K17_NEW
    calls = []
    replay = CyclefoldIVC._sfc_witness

    def recording(self, inputs, marker_of_z):
        out = replay(self, inputs, marker_of_z)
        calls.append((inputs, out))
        return out

    monkeypatch.setattr(CyclefoldIVC, "_sfc_witness", recording)
    ivc.next()
    assert digests(ivc) == golden.CYCLEFOLD_TRIVIAL_K17_NEXT
    (inputs, (W, _, x1)), = calls
    direct = ivc._sfc_witness_direct(inputs, inputs.self_incoming.instances[0][1], x1)
    assert len(W) == len(direct)
    assert all(np.array_equal(c, ints_to_words(d).astype(np.uint32)) for c, d in zip(W.cols, direct))
    flat = [v for col in direct for v in col]
    assert torch.equal(ivc.primary_trace.w.W[0], FR.encode(flat, cuda_device))
    assert ivc.verify() == []


# -- the multi-device path (parallel/, msm_sharded, fft_sharded) -------------------------------------------------

CYCLEFOLD_DIGESTS = ("9f3739df", "13a63ce4")  # chip_smoke.py: the trivial Cyclefold after 2 next, z0 = [0x42]
MESHES = ["virtual_4_on_cuda0", "every_card"]


def _mesh(kind):
    """A virtual mesh of four shards on cuda:0, or a mesh of every card (a
    host with one card skips it)."""
    from sirius_tpu_torch.parallel import make_mesh

    if kind == "virtual_4_on_cuda0":
        return make_mesh(devices=["cuda:0"] * 4)
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    return make_mesh()


@pytest.fixture(scope="module")
def bench_keys():
    """The chip_smoke keys' points: the bn256 2^20 prefix of b"bench-primary"
    and the grumpkin 2^17 support key of b"bench-support", on cuda:0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return (CommitmentKey.setup(BN256_G1, 20, b"bench-primary", use_cache=False, device="cuda:0"),
            CommitmentKey.setup(GRUMPKIN, 17, b"bench-support", use_cache=False, device="cuda:0"))


def _canonical(rng, n, device):
    w = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.int64)
    w[:, 7] &= 0x0FFFFFFF  # 252-bit values: canonical Fr words, Montgomery or standard alike
    return torch.from_numpy(w).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", MESHES)
def test_sharded_commit_at_the_primary_w_equals_best_msm(bench_keys, kind):
    from sirius_tpu_torch.ops import _build
    from sirius_tpu_torch.parallel import mesh_context

    mesh = _mesh(kind)
    ck = bench_keys[0]
    n = 7 << 17  # the trivial Cyclefold's primary W: 917,504 scalars
    W = _canonical(np.random.default_rng(17), n, "cuda:0")
    want = best_msm(BN256_G1, FR.from_mont(W), Points(*(c[:n] for c in ck.points)))
    before = dict(_build.device_launches)
    with mesh_context(mesh):
        assert ck.commit_device(W) == want
    ran = {d: k - before.get((e, d), 0) for (e, d), k in _build.device_launches.items() if e == "msm_accumulate"}
    assert {d: k for d, k in ran.items() if k} == {str(d): mesh.devices.count(d) for d in mesh.distinct}


@pytest.mark.gpu
@pytest.mark.parametrize("kind", MESHES)
def test_fft_sharded_k20_equals_fft(kind):
    from sirius_tpu_torch.parallel import Mesh, gather_rows, shard_rows

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    mesh = _mesh(kind)
    if 1024 % mesh.size:  # the four-step across a mesh takes a power-of-two count of cards
        mesh = Mesh(mesh.devices[: 1 << (mesh.size.bit_length() - 1)])
    ctx = NTT(FR, 20, "cuda:0")
    a = _canonical(np.random.default_rng(20), 1 << 20, "cuda:0")
    for inverse in (False, True):
        blocks = ctx.fft_sharded(shard_rows(mesh, a), mesh, inverse)
        assert [b.device for b in blocks] == list(mesh.devices)
        assert torch.equal(gather_rows(mesh, blocks), ctx.fft(a, inverse))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", MESHES)
def test_trivial_cyclefold_under_a_mesh_equals_the_frozen_digests(bench_keys, kind):
    from sirius_tpu_torch.ivc.cyclefold_ivc import CyclefoldIVC, CyclefoldPublicParams
    from sirius_tpu_torch.ivc.step_circuit import TrivialStepCircuit
    from sirius_tpu_torch.nifs.protogalaxy import AccumulatorInstance
    from sirius_tpu_torch.parallel import mesh_context
    from sirius_tpu_torch.util.golden import pg_acc_digest, sangria_acc_digest

    mesh = _mesh(kind)
    ck1, ck2 = bench_keys
    pp = CyclefoldPublicParams(TrivialStepCircuit(arity=1), 17, ck1, ck2)
    plans = dict(bucket_plan.shapes)
    with mesh_context(mesh):
        ivc = CyclefoldIVC(pp, [0x42])
        ivc.next()
        ivc.next()
        assert ivc.verify() == []
    digests = (pg_acc_digest(AccumulatorInstance.from_acc(ivc.self_acc)), sangria_acc_digest(ivc.support_acc.U))
    assert [d[:8] for d in digests] == list(CYCLEFOLD_DIGESTS)
    new_plans = {m for m, k in bucket_plan.shapes.items() if k > plans.get(m, 0)}
    assert max(new_plans) <= -(-(7 << 17) // mesh.size)  # every commit went by shards
    _assert_row_blocks(mesh, [*ivc.primary_trace.w.W, *ivc.self_acc.trace.w.W, *ivc.support_acc.W.W,
                              ivc.support_acc.W.E])


def _assert_row_blocks(mesh, rounds):
    """Every round is row blocks (`parallel/rows.py`) on the mesh's devices."""
    from sirius_tpu_torch.parallel import RowBlocks

    for w in rounds:
        assert isinstance(w, RowBlocks) and w.mesh == mesh and w.devices == list(mesh.devices), w


@pytest.mark.gpu
@pytest.mark.parametrize("kind", MESHES)
def test_sangria_ivc_k16_under_a_mesh_equals_the_frozen_jax_digests(kind):
    """`test_sangria_ivc_k16_on_the_card_equals_the_frozen_jax_digests` with
    both sides' W rounds and E as row blocks of the mesh."""
    from sirius_tpu_torch.ivc.sangria_ivc import IVC, PublicParams
    from sirius_tpu_torch.ivc.step_circuit import TrivialStepCircuit
    from sirius_tpu_torch.parallel import mesh_context
    from sirius_tpu_torch.util import golden
    from sirius_tpu_torch.util.golden import sangria_acc_digest
    from sirius_tpu_torch.util.testing import MockCommitmentKey

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    mesh = _mesh(kind)
    pp = PublicParams(TrivialStepCircuit(1), TrivialStepCircuit(1), 16, 16, MockCommitmentKey(BN256_G1, "cuda:0"),
                      MockCommitmentKey(GRUMPKIN, "cuda:0"))
    with mesh_context(mesh):
        ivc = IVC(pp, [0x11], [0x22])
        accs = lambda: (sangria_acc_digest(ivc.primary_relaxed.U), sangria_acc_digest(ivc.secondary_relaxed.U))  # noqa: E731
        assert accs() == golden.SANGRIA_IVC_K16_NEW
        ivc.fold_step()
        assert ivc.verify() == []
    assert (pp.digest_coords(1), pp.digest_coords(2)) == (golden.SANGRIA_IVC_K16_PP_DIGEST_1,
                                                          golden.SANGRIA_IVC_K16_PP_DIGEST_2)
    assert accs() == golden.SANGRIA_IVC_K16_STEP
    _assert_row_blocks(mesh, [w for acc in (ivc.primary_relaxed, ivc.secondary_relaxed) for w in [*acc.W.W, acc.W.E]]
                       + list(ivc.secondary_trace.w.W))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", MESHES)
def test_dryrun_folds_under_a_mesh_on_the_card_equal_the_jax_package(kind):
    """The dry run's two Sangria folds (a 3-round SPS with a vector lookup:
    `m_count` on the first card) on its real key on cuda:0, under the mesh:
    `golden.DRYRUN_MC_FOLDS`, is_sat clean, W and E row blocks."""
    from sirius_tpu_torch.parallel import mesh_context
    from sirius_tpu_torch.util import golden
    from sirius_tpu_torch.util.testing import dryrun_sangria_folds

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    mesh = _mesh(kind)
    ck = CommitmentKey.setup(BN256_G1, 9, b"dryrun-mc", use_cache=False, device="cuda:0")
    with mesh_context(mesh):
        digests, errors, acc = dryrun_sangria_folds(ck)
    assert errors == [] and tuple(digests) == golden.DRYRUN_MC_FOLDS
    _assert_row_blocks(mesh, [*acc.W.W, acc.W.E])


@pytest.mark.gpu
def test_a_wrapper_launches_on_its_operands_card_while_another_is_current():
    """cuda:1 tensors with cuda:0 current: the launch runs under cuda:1 with
    cuda:1's stream (before the `_build.launch` helper it ran on the current
    device and failed with an invalid resource handle): mul_rows, B4 above
    48 KB of dynamic shared memory (its attribute set on cuda:1 too) and
    best_msm's B2/B3 give their plain twins' words."""
    from sirius_tpu_torch.ops import _build

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    one = torch.device("cuda:1")
    rng = np.random.default_rng(1)
    a, b = _canonical(rng, 4096, one), _canonical(rng, 4096, one)
    ctx = NTT(FR, 21, one)  # pass-1 columns of 2048: 64 KB of shared memory
    col = FR.random((ctx.n1, 8), rng, one)
    ck = CommitmentKey.setup(BN256_G1, 10, b"torch-gpu-test", use_cache=False, device=one)
    S = _canonical(rng, 1024, one)
    with torch.cuda.device(0):
        before = dict(_build.device_launches)
        got = fk.mul_rows(FR, a, b)
        assert got.device == one and torch.equal(got, fk.mul_rows_plain(FR, a, b))
        got = ntt_kernels.col_ntt(FR, col, ctx.rev_n1, ctx.inner[False])
        assert torch.equal(got, ntt_kernels.col_ntt_plain(FR, col, ctx.rev_n1, ctx.inner[False]))
        want = best_msm(BN256_G1, S.cpu(), Points(*(c.cpu() for c in ck.points)))
        assert best_msm(BN256_G1, S, ck.points) == want
        assert torch.cuda.current_device() == 0
    ran = {e for (e, d), k in _build.device_launches.items() if d == "cuda:1" and k > before.get((e, d), 0)}
    assert {"mul_rows", "col_ntt", "msm_bucket_count", "msm_accumulate", "msm_reduce", "msm_horner"} <= ran
