"""The port's MSM and signed digits vs the JAX package's
`msm_bucket_fused` and `_extract_digits_signed` on the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sirius_tpu.curves.jpoint import BN256_G1 as J_BN256
from sirius_tpu.curves.jpoint import Points as JPoints
from sirius_tpu.ops.msm import _extract_digits_signed as jax_signed_digits
from sirius_tpu.ops.msm import msm_bucket_fused
from sirius_tpu_torch.curves.jpoint import BN256_G1, Points
from sirius_tpu_torch.ops.commitment import CommitmentKey
from sirius_tpu_torch.ops.msm import _extract_digits_signed, best_msm
from sirius_tpu_torch.util.interop import affine_from, limbs_to_words, words_to_limbs

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers


def test_vs_jax_msm_bucket_fused_and_digits():
    n = 64
    ck = CommitmentKey.setup(BN256_G1, 6, b"torch-msm-jax", use_cache=False, device="cpu")
    rng = np.random.default_rng(42)
    limbs = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.uint32)
    limbs[:, 15] &= 0x0FFF
    limbs[3] = limbs[4]
    limbs[7] = 0
    S = torch.from_numpy(limbs_to_words(limbs))
    jpts = JPoints(*(jnp.asarray(words_to_limbs(c[:n])) for c in ck.points))
    want = msm_bucket_fused(J_BN256, jnp.asarray(limbs), jpts, window_bits=4, group_count=8, assume_distinct=True)
    assert best_msm(BN256_G1, S, Points(*(c[:n] for c in ck.points))) == affine_from(want)
    for c in (4, 10):
        mags, negs = _extract_digits_signed(S, c)
        jm, jn = jax.jit(jax_signed_digits, static_argnums=1)(jnp.asarray(limbs), c)
        assert np.array_equal(mags.numpy(), np.asarray(jm)) and np.array_equal(negs.numpy(), np.asarray(jn))
