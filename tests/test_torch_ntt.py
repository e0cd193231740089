"""The port's NTT (`sirius_tpu_torch/ops/ntt.py`) against the JAX package's
`sirius_tpu/ops/ntt.py` on the same inputs, bit for bit: the reference
vector, the flat route (k < 10), the coset transforms, the four-step route
at k = 10 against the JAX `fft_lf`, and the plain B4 twin against
`col_ntt_pallas` in interpret mode.  The CUDA kernel against its twin is in
`test_torch_gpu.py`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sirius_tpu.fields.constants import bn256_fr as J_FR_SPEC
from sirius_tpu.fields.constants import pasta_fp as J_FP_SPEC
from sirius_tpu.fields.jfield import FR as J_FR
from sirius_tpu.fields.jfield import PASTA_FP as J_FP
from sirius_tpu.fields.jfield_lf import from_lf, to_lf
from sirius_tpu.ops import ntt as jntt
from sirius_tpu.ops.pallas_ntt import col_ntt_pallas
from sirius_tpu_torch.fields.constants import bn256_fr, pasta_fp
from sirius_tpu_torch.fields.jfield import FR, PASTA_FP
from sirius_tpu_torch.ops import ntt_kernels
from sirius_tpu_torch.ops.ntt import NTT, _bit_reverse_indices, ntt_ctx
from sirius_tpu_torch.util.interop import limbs_to_words, to_numpy, to_torch

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers

# reference src/fft.rs:241-252 (tests/test_ntt.py): fft([0..8]) over bn256 Fr
GOLDEN_FFT8 = [
    28,
    68918385373930674424918168212551896122229959265833979749191472831399925654,
    17631683881184975370165255887551781615748388533673675138856,
    68918385373930639161550405842601155791718184162270748252414405484049647934,
    21888242871839275222246405745257275088548364400416034343698204186575808495613,
    21819324486465344583084855339414673932756646216253763595445789781091758847675,
    21888242871839275204614721864072299718383108512864252727949815652902133356753,
    21819324486465344547821487577044723192426134441150200363949012713744408569955,
]


def _inputs(J, k, seed):
    """2^k Montgomery elements below 2^62 (bench.py's draw): the JAX (n, 16)
    limbs and the port's (n, 8) words of the same values."""
    xs = [int(x) for x in np.random.default_rng(seed).integers(0, 2**62, size=1 << k)]
    limbs = np.asarray(J.encode(xs))
    return xs, limbs, to_torch(limbs, "cpu")


def _same(t, j):
    return np.array_equal(to_numpy(t), np.asarray(j))


def test_reference_vector_k3():
    ctx = ntt_ctx(bn256_fr, 3, "cpu")
    assert FR.decode(ctx.fft(FR.encode(list(range(8)), "cpu"))) == GOLDEN_FFT8


@pytest.mark.parametrize("jspec,J,tspec,T,k", [
    (J_FR_SPEC, J_FR, bn256_fr, FR, 4),
    (J_FR_SPEC, J_FR, bn256_fr, FR, 6),
    (J_FP_SPEC, J_FP, pasta_fp, PASTA_FP, 4),
], ids=["bn256_fr-k4", "bn256_fr-k6", "pasta_fp-k4"])
def test_flat_route_matches_jax(jspec, J, tspec, T, k):
    xs, limbs, words = _inputs(J, k, 10 + k)
    jctx, tctx = jntt.ntt_ctx(jspec, k), ntt_ctx(tspec, k, "cpu")
    assert not tctx.use_four_step
    out = tctx.fft(words)
    assert _same(out, jctx.fft(limbs))
    assert _same(tctx.ifft(out), jctx.ifft(jctx.fft(limbs)))
    assert T.decode(tctx.ifft(out)) == xs


def test_coset_matches_jax_k5():
    xs, limbs, words = _inputs(J_FR, 5, 5)
    jctx, tctx = jntt.ntt_ctx(J_FR_SPEC, 5), ntt_ctx(bn256_fr, 5, "cpu")
    out = tctx.coset_fft(words)
    assert _same(out, jctx.coset_fft(limbs))
    assert _same(tctx.coset_ifft(out), jctx.coset_ifft(jctx.coset_fft(limbs)))
    assert FR.decode(tctx.coset_ifft(out)) == xs


def test_four_step_k10_matches_jax_fft_lf():
    xs, limbs, words = _inputs(J_FR, 10, 10)
    tctx = NTT(FR, 10, "cpu")
    assert tctx.use_four_step and (tctx.n1, tctx.n2) == (32, 32)
    jctx = jntt.NTT(J_FR, 10)
    want = from_lf(jctx.fft_lf(jnp.asarray(to_lf(limbs))))
    out = tctx.fft(words)
    assert _same(out, want)
    assert FR.decode(tctx.ifft(out)) == xs
    assert FR.decode(tctx.coset_ifft(tctx.coset_fft(words))) == xs


def test_col_ntt_twin_matches_pallas_interpret():
    """The (size 16, R 16) block of `tests/test_ntt.py:130-171`: the plain B4
    twin against `col_ntt_pallas(..., interpret=True)`."""
    k, size, R = 8, 16, 16
    p = J_FR_SPEC.modulus
    xs = [int(x) for x in np.random.default_rng(8).integers(0, 2**62, size=size * R)]
    a = jnp.asarray(to_lf(J_FR.encode(xs))).reshape(16, size, R)
    w = pow(jntt.gold.omega_for_k(J_FR_SPEC, k), R, p)  # order-`size` root
    table = np.asarray(J_FR.encode([pow(w, j, p) for j in range(size // 2)])).T.copy()  # (L, size/2)
    rev = _bit_reverse_indices(4)
    want = col_ntt_pallas(jntt.lf_for(J_FR), a, rev.astype(np.int32), table, interpret=True)

    def words(lf):  # (16, ...) limb-first -> (..., 8) words
        return torch.from_numpy(limbs_to_words(np.moveaxis(np.asarray(lf), 0, -1)))

    before = ntt_kernels.col_ntt.launches
    got = ntt_kernels.col_ntt(FR, words(a), torch.from_numpy(rev), words(table))
    assert ntt_kernels.col_ntt.launches == before  # CPU tensors: the plain twin, no launch
    assert torch.equal(got, words(want))


def test_nested_four_step_k10_matches_jax(monkeypatch):
    """With kernel columns of at most 16 elements, the k = 10 passes (32) run
    as nested four-steps (8 x 4) over their 32 columns at once: the same
    transforms as the JAX package's, bit for bit."""
    monkeypatch.setattr(ntt_kernels, "MAX_SIZE", 16)
    xs, limbs, words = _inputs(J_FR, 10, 11)
    tctx = NTT(FR, 10, "cpu")
    assert tctx.inner is None and tctx.outer is None
    jctx = jntt.ntt_ctx(J_FR_SPEC, 10)
    out = tctx.fft(words)
    assert _same(out, jctx.fft(limbs))
    assert sorted(tctx._nested) == [32]
    assert _same(tctx.ifft(out), jctx.ifft(jctx.fft(limbs)))
    assert FR.decode(tctx.ifft(out)) == xs
    coset = tctx.coset_fft(words)
    assert _same(coset, jctx.coset_fft(limbs))
    assert FR.decode(tctx.coset_ifft(coset)) == xs


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_col_ntt_epilogue_twin_matches_pallas_mid_and_swap(inverse):
    """The epilogue pass's twin (the ladder, times the mid twiddle,
    transposed) on a (size 16, R 16) block equals the JAX four-step's
    `col_ntt_pallas(..., interpret=True)`, `lf.mul(A, mid)` and `swapaxes`
    (`sirius_tpu/ops/ntt.py:185-187`) on T[o1, i2] = w^(+-o1*i2), times 1/n
    for the inverse, as `_mid_twiddle` builds it for n = 2^8."""
    k, size, R = 8, 16, 16
    p = J_FR_SPEC.modulus
    xs = [int(x) for x in np.random.default_rng(80 + inverse).integers(0, 2**62, size=size * R)]
    a = jnp.asarray(to_lf(J_FR.encode(xs))).reshape(16, size, R)
    w = jntt.gold.omega_for_k(J_FR_SPEC, k)
    w = pow(w, -1, p) if inverse else w
    scale = pow(size * R, -1, p) if inverse else 1
    w_in = pow(w, R, p)  # order `size`
    table = np.asarray(J_FR.encode([pow(w_in, j, p) for j in range(size // 2)])).T.copy()  # (L, size/2)
    mid = np.asarray(J_FR.encode([scale * pow(w, o1 * i2, p) % p for o1 in range(size) for i2 in range(R)]))
    rev = _bit_reverse_indices(4)
    lf = jntt.lf_for(J_FR)
    A = col_ntt_pallas(lf, a, rev.astype(np.int32), table, interpret=True)
    want = jnp.swapaxes(lf.mul(A, jnp.asarray(mid.T.copy()).reshape(16, size, R)), 1, 2)  # (L, i2, o1)

    def words(lf_arr):  # (16, ...) limb-first -> (..., 8) words
        return torch.from_numpy(limbs_to_words(np.moveaxis(np.asarray(lf_arr), 0, -1)))

    before = ntt_kernels.col_ntt.launches
    got = ntt_kernels.col_ntt(FR, words(a), torch.from_numpy(rev), words(table), to_torch(mid, "cpu"))
    assert ntt_kernels.col_ntt.launches == before  # CPU tensors: the plain twin, no launch
    assert got.shape == (R, size, 8)
    assert torch.equal(got, words(want))


@pytest.mark.parametrize("k", [10, 11], ids=["k10", "k11_n1_ne_n2"])
def test_four_step_matches_jax_fft_ifft_coset(k):
    """The four-step route (pass 1 with the mid twiddle and transpose in its
    epilogue, then pass 2) equals the JAX package's fft_lf, ifft and
    coset_fft bit for bit, at n1 = n2 and at n1 = 2 n2."""
    xs, limbs, words = _inputs(J_FR, k, 100 + k)
    tctx = NTT(FR, k, "cpu")
    assert tctx.use_four_step and tctx.inner is not None and tctx.n1 == tctx.n2 << (k % 2)
    jctx = jntt.NTT(J_FR, k)
    out = tctx.fft(words)
    assert _same(out, from_lf(jctx.fft_lf(jnp.asarray(to_lf(limbs)))))
    assert _same(tctx.ifft(words), jctx.ifft(limbs))
    assert _same(tctx.coset_fft(words), jctx.coset_fft(limbs))
    assert FR.decode(tctx.ifft(out)) == xs


def test_mul_rows_repeat_on_every_product_matches_jax():
    """mul_rows with rep > 1 (the nested route's broadcast mid twiddle), now
    on every product: each equals the unrolled one and the JAX package's
    product on the repeated rows."""
    from sirius_tpu_torch.ops import field_kernels as fk

    rng = np.random.default_rng(31)
    n, nb, rep = 60, 4, 5  # b row (i // 5) mod 4
    a = np.asarray(J_FR.random((n,), rng))
    b = np.asarray(J_FR.random((nb,), rng))
    want = np.asarray(J_FR.mul(a, np.tile(np.repeat(b, rep, 0), (n // (nb * rep), 1))))
    for product in fk.PRODUCTS:
        got = fk.mul_rows(FR, to_torch(a, "cpu"), to_torch(b, "cpu"), rep=rep, product=product)
        assert np.array_equal(to_numpy(got), want), product
