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
from sirius_tpu_torch.curves import hash_to_curve as h2c
from sirius_tpu_torch.curves.hash_to_curve import hash_bytes_to_point, hash_bytes_to_points_device
from sirius_tpu_torch.curves.jpoint import BN256_G1, GRUMPKIN
from sirius_tpu_torch.ops import commitment as tcommit
from sirius_tpu_torch.util.interop import affine_from, key_from_numpy, to_numpy, words_to_limbs

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


def _save_legacy(path, x, y, z):
    """The JAX package's legacy key cache: (n, 16) 16-bit limb arrays."""
    np.savez(path, x=words_to_limbs(x), y=words_to_limbs(y), z=words_to_limbs(z))


@pytest.mark.parametrize("jc,tc", PAIRS, ids=IDS)
def test_legacy_limb_cache_loads_as_the_packed_cache(tmp_path, monkeypatch, jc, tc):
    """A legacy (x, y, z) limb-array cache written from the JAX package's key
    loads in the port to the same words as the packed cache of the same
    label and as the JAX package's points."""
    monkeypatch.setattr(jcommit, "CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(tcommit, "CACHE_DIR", str(tmp_path))
    jck = jcommit.CommitmentKey.setup(jc, 5, b"legacy", use_cache=False)
    path = tmp_path / f"{tc.spec.name}-legacy-5.npz"
    np.savez(path, **{c: np.asarray(getattr(jck.points, c)) for c in ("x", "y", "z")})
    got = tcommit.CommitmentKey.setup(tc, 5, b"legacy", use_cache=True, device="cpu")
    fresh = tcommit.CommitmentKey.setup(tc, 5, b"legacy", use_cache=False, device="cpu")
    path.unlink()
    tcommit.CommitmentKey.setup(tc, 5, b"legacy", use_cache=True, device="cpu")  # writes the packed cache
    with np.load(path) as data:
        assert "xw" in data and "x" not in data
    packed = tcommit.CommitmentKey.setup(tc, 5, b"legacy", use_cache=True, device="cpu")
    for a, b, c in zip(got.points, fresh.points, packed.points):
        assert torch.equal(a, b) and torch.equal(a, c)
    for t, j in zip(got.points, jck.points):
        assert np.array_equal(to_numpy(t), np.asarray(j))


def test_legacy_limb_cache_with_jacobian_points_is_normalized(tmp_path, monkeypatch):
    """Legacy points with z != 1 (the key scaled to (l^2 x, l^3 y, l)) load
    as the affine key (z = 1); a point at infinity is refused."""
    monkeypatch.setattr(tcommit, "CACHE_DIR", str(tmp_path))
    tc = BN256_G1
    f = tc.fb
    key = tcommit.CommitmentKey.setup(tc, 4, b"affine", use_cache=False, device="cpu").points
    lam = f.encode([int(v) for v in np.random.default_rng(4).integers(2, 2**62, size=16)], "cpu")
    lam[0] = f.ones((1,), "cpu")[0]  # a row with z = 1 among the others
    lam2 = f.square(lam)
    _save_legacy(tmp_path / "bn256_g1-jac-4.npz", f.mul(key.x, lam2), f.mul(key.y, f.mul(lam2, lam)), lam)
    got = tcommit.CommitmentKey.setup(tc, 4, b"jac", use_cache=True, device="cpu").points
    for a, b in zip(got, key):
        assert torch.equal(a, b)
    z = key.z.clone()
    z[3] = 0
    _save_legacy(tmp_path / "bn256_g1-inf-4.npz", key.x, key.y, z)
    with pytest.raises(tcommit.CommitmentError, match="infinity"):
        tcommit.CommitmentKey.setup(tc, 4, b"inf", use_cache=True, device="cpu")


@pytest.mark.parametrize("jc,tc", PAIRS, ids=IDS)
def test_chunked_device_setup_equals_one_map(monkeypatch, jc, tc):
    """The device setup maps the stream in chunks of DEVICE_SETUP_CHUNK
    points: lowered to 8 (and DEVICE_SETUP_MIN to 8) at 2^5 points, four
    chunks and a boundary every 8 points, the key equals one map of the
    whole stream and the JAX package's key word for word."""
    n = 1 << 5
    monkeypatch.setattr(tcommit, "DEVICE_SETUP_MIN", 8)
    monkeypatch.setattr(tcommit, "DEVICE_SETUP_CHUNK", 8)
    chunked = tcommit.CommitmentKey.setup(tc, 5, b"chunked", use_cache=False, device="cpu").points
    stream = hashlib.shake_256(b"chunked").digest(64 * n)
    whole = hash_bytes_to_points_device(tc, stream, "cpu")
    for a, b in zip(chunked, whole):
        assert a.shape == (n, 8) and torch.equal(a, b)
    jck = jcommit.CommitmentKey.setup(jc, 5, b"chunked", use_cache=False)
    for t, j in zip(chunked, jck.points):
        assert np.array_equal(to_numpy(t), np.asarray(j))


def _sqrt_two_exponentiations(f, a):
    """The square root as it was: Tonelli-Shanks started from a^Q and
    a^((Q + 1) / 2), two exponentiations."""
    S, Q, z = h2c._ts_constants(f.p)
    shape = a.shape[:-1]
    one = f.ones(shape, "cpu")
    c = f.const(pow(z, Q, f.p), shape, "cpu")
    t = f.pow_int(a, Q)
    R = f.pow_int(a, (Q + 1) // 2)
    for i in range(S - 1, 0, -1):
        b = t
        for _ in range(i - 1):
            b = f.square(b)
        flag = ~f.eq(b, one)
        R = f.select(flag, f.mul(R, c), R)
        c = f.square(c)
        t = f.select(flag, f.mul(t, c), t)
    return R


def test_sqrt_from_one_exponentiation_equals_the_two_exponentiation_form():
    """grumpkin's base field (bn256 Fr, p = 1 mod 4, 2-adicity 28): the root
    from x = a^((Q - 1) / 2), R = a x, t = R x gives the old words on
    residues, non-residues and 0, and squares back on the residues."""
    f = GRUMPKIN.fb
    p = f.p
    rng = np.random.default_rng(11)
    vals = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(12)]
    vals += [v * v % p for v in vals[:6]] + [0, 1, p - 1]
    residue = [v == 0 or pow(v, (p - 1) // 2, p) == 1 for v in vals]
    assert any(residue) and not all(residue)
    a = f.encode(vals, "cpu")
    got = h2c._sqrt_device(f, a)
    assert torch.equal(got, _sqrt_two_exponentiations(f, a))
    sq = f.decode(f.square(got))
    assert [s for s, ok in zip(sq, residue) if ok] == [v for v, ok in zip(vals, residue) if ok]
