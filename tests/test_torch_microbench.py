"""S2, S3, S4: the plain twins of the field-rate and build probes against
the JAX package's `Field.mul` chain (`scripts/tpu_microbench.py:mul_kernel`),
numpy uint32 arithmetic (`raw_kernel`) and x + 1 (`scripts/lower_dump.py:tiny`).
The CUDA kernels against their twins are in `test_torch_gpu.py`."""

import numpy as np
import pytest
import torch

from sirius_tpu.fields import jfield as jf
from sirius_tpu_torch.fields import jfield as tf
from sirius_tpu_torch.ops import field_kernels as fk
from sirius_tpu_torch.ops import microbench as mb
from sirius_tpu_torch.util.interop import to_numpy, to_torch

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers


@pytest.mark.parametrize("name", ["bn256_fr", "bn256_fq"])
@pytest.mark.parametrize("nb", [40, 3])
def test_mul_chain_twin_matches_jax_mul_chain(name, nb):
    """K = 8 chained Montgomery products a <- a * b, b row i mod nb."""
    J, T = jf._FIELDS[name], tf._FIELDS[name]
    rng = np.random.default_rng(nb)
    a = np.asarray(J.random((40,), rng))
    b = np.asarray(J.random((nb,), rng))
    want = a
    for _ in range(8):
        want = J.mul(want, np.tile(b, (40 // nb + 1, 1))[:40])
    before = fk.mul_rows.launches
    got = mb.mul_chain(T, to_torch(a, "cpu"), to_torch(b, "cpu"), K=8)
    assert fk.mul_rows.launches == before  # CPU tensors: the plain twin
    assert np.array_equal(to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("product", fk.PRODUCTS)
def test_mul_chain_twin_on_every_product_matches_jax(product):
    """The wrapper on CPU tensors takes the plain twin whatever product it is
    asked for (each kernel product gives the same words): K = 8 over bn256
    Fr, against the JAX package's chain."""
    J, T = jf._FIELDS["bn256_fr"], tf._FIELDS["bn256_fr"]
    rng = np.random.default_rng(len(product))
    a, b = np.asarray(J.random((16,), rng)), np.asarray(J.random((16,), rng))
    want = a
    for _ in range(8):
        want = J.mul(want, b)
    before = fk.mul_rows.launches
    got = mb.mul_chain(T, to_torch(a, "cpu"), to_torch(b, "cpu"), K=8, product=product)
    assert fk.mul_rows.launches == before
    assert np.array_equal(to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("op", ["mul", "add"])
def test_raw_u32_twin_matches_numpy_uint32(op):
    """The twin on int32 words holding the u32 bits (the kernel's contract),
    at the timed 64 reps and the long run's 4096, against numpy uint32."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64).astype(np.uint32)
    a[:3] = [0, 1, 0xFFFFFFFF]
    for reps in (64, 4096):
        b = a.copy()
        with np.errstate(over="ignore"):
            for _ in range(reps):
                b = b * a if op == "mul" else b + a
        got = mb.raw_u32(torch.from_numpy(a.view(np.int32)), op, reps=reps)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy().view(np.uint32), b)
    with pytest.raises(ValueError):
        mb.raw_u32(torch.zeros(4, dtype=torch.int32), "sub")
    with pytest.raises(ValueError):  # u32 words come as int32 since the kernel moves 4-byte words
        mb.raw_u32(torch.zeros(4, dtype=torch.int64), op)


def test_probe_add_one_twin_is_x_plus_one():
    x = np.random.default_rng(4).integers(0, 1 << 32, size=(8, 128), dtype=np.uint64).astype(np.uint32)
    x[0, :2] = [0, 0xFFFFFFFF]
    got = mb.probe_add_one(torch.from_numpy(x.astype(np.int64)))
    with np.errstate(over="ignore"):
        assert np.array_equal(got.numpy(), (x + np.uint32(1)).astype(np.int64))
