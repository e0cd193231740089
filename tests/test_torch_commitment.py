"""Commitment keys: the port's key equals the JAX key (through interop),
the batched SVDW map equals the host hash-to-curve, and the npz key cache
is shared both ways between the packages."""

import hashlib

import numpy as np
import pytest
import torch

from sirius_tpu.curves import hash_to_curve as jh2c
from sirius_tpu.curves.jpoint import BN256_G1 as J_BN256
from sirius_tpu.curves.jpoint import GRUMPKIN as J_GRUMPKIN
from sirius_tpu.ops import commitment as jcommit
from sirius_tpu_torch.curves.hash_to_curve import hash_bytes_to_point, hash_bytes_to_points_device
from sirius_tpu_torch.curves.jpoint import BN256_G1, GRUMPKIN
from sirius_tpu_torch.ops import commitment as tcommit
from sirius_tpu_torch.util.interop import affine_from, key_from_numpy, to_numpy

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers

PAIRS = [(J_BN256, BN256_G1), (J_GRUMPKIN, GRUMPKIN)]
IDS = ["bn256_g1", "grumpkin"]


@pytest.mark.parametrize("jc,tc", PAIRS, ids=IDS)
def test_key_equals_jax_key_at_k7(jc, tc):
    jck = jcommit.CommitmentKey.setup(jc, 7, b"torch-key-eq", use_cache=False)
    tck = tcommit.CommitmentKey.setup(tc, 7, b"torch-key-eq", use_cache=False, device="cpu")
    for t, j in zip(tck.points, jck.points):
        assert np.array_equal(to_numpy(t), np.asarray(j))
    carried = key_from_numpy(jc.spec, np.asarray(jck.points.x), np.asarray(jck.points.y), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(carried, tck.points))


@pytest.mark.parametrize("jc,tc", PAIRS, ids=IDS)
def test_device_svdw_equals_host_map(jc, tc):
    n = 64
    stream = hashlib.shake_256(b"svdw-" + tc.spec.name.encode()).digest(64 * n)
    host = [affine_from(jh2c.hash_bytes_to_point(jc.spec, stream[64 * i : 64 * (i + 1)])) for i in range(n)]
    assert [hash_bytes_to_point(tc.spec, stream[64 * i : 64 * (i + 1)]) for i in range(n)] == host
    assert tc.decode(hash_bytes_to_points_device(tc, stream, "cpu")) == host


def test_npz_cache_shared_both_ways(tmp_path, monkeypatch):
    monkeypatch.setattr(jcommit, "CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(tcommit, "CACHE_DIR", str(tmp_path))
    # written by the JAX package, read by the port
    jck = jcommit.CommitmentKey.setup(J_GRUMPKIN, 6, b"shared-a", use_cache=True)
    tck = tcommit.CommitmentKey.setup(GRUMPKIN, 6, b"shared-a", use_cache=True, device="cpu")
    for t, j in zip(tck.points, jck.points):
        assert np.array_equal(to_numpy(t), np.asarray(j))
    # written by the port, read by the JAX package
    tck = tcommit.CommitmentKey.setup(BN256_G1, 6, b"shared-b", use_cache=True, device="cpu")
    path = tmp_path / "bn256_g1-shared-b-6.npz"
    assert path.exists()
    with np.load(path) as data:
        assert data["xw"].dtype == np.uint32 and data["xw"].shape == (64, 8)
    jck = jcommit.CommitmentKey.setup(J_BN256, 6, b"shared-b", use_cache=True)
    for t, j in zip(tck.points, jck.points):
        assert np.array_equal(to_numpy(t), np.asarray(j))
