"""The plain reference against hand-worked cases at a tiny size (CPU)."""

from __future__ import annotations

import hashlib
import struct

import numpy as np
import pytest

from port_bench import harness, judge
from port_bench.reference.sirius_plain.curves.jpoint import BN256_G1, GRUMPKIN
from port_bench.reference.sirius_plain.fields import gold
from port_bench.reference.sirius_plain.fields.constants import bn256_fr
from port_bench.reference.sirius_plain.fields.jfield import FR
from port_bench.reference.sirius_plain.gadgets.sha256_step_circuit import IV, sha256_compress, step_fn
from port_bench.reference.sirius_plain.ops import commitment


def test_field_product_by_hand():
    p = bn256_fr.modulus
    a, b = [3, p - 1, 2**200 + 7], [5, p - 1, 2**100 + 11]
    got = FR.decode(FR.mul(FR.encode(a, "cpu"), FR.encode(b, "cpu")))
    assert got == [15, 1, (2**200 + 7) * (2**100 + 11) % p]


def test_sha256_compression_is_fips_on_abc():
    block = b"abc" + b"\x80" + b"\x00" * 52 + struct.pack(">Q", 24)
    words = list(struct.unpack(">16I", block))
    digest = struct.pack(">8I", *sha256_compress(IV, words))
    assert digest == hashlib.sha256(b"abc").digest()


def test_expected_z_follows_each_configuration_step():
    z0 = [12345]
    assert judge.expected_z(harness.load_config("cf_trivial_k17"), z0, 5) == z0
    sha = harness.load_config("cf_sha256_k18")
    p = bn256_fr.modulus
    assert judge.expected_z(sha, z0, 2) == [step_fn(step_fn(12345, p), p)]


def test_plain_msm_against_host_scalar_products():
    """Key points with no known relation (the MSM's incomplete additions
    need it), 16 scalars, the sum of their host products."""
    for curve in (BN256_G1, GRUMPKIN):
        key = commitment.CommitmentKey.setup(curve, 4, b"port-bench-msm", use_cache=False, device="cpu")
        pts = key.host_points()
        scalars = [(7919 * i + 3) ** 5 % curve.fs.p for i in range(16)]
        want = gold.identity(curve.spec)
        for s, P in zip(scalars, pts):
            want = want.add(P.mul(s))
        assert key.commit(scalars) == want


def test_key_points_off_counts_points_that_are_not_the_labels(tmp_path, monkeypatch):
    monkeypatch.setattr(commitment, "CACHE_DIR", str(tmp_path))
    ck = commitment.CommitmentKey.setup(BN256_G1, 6, b"port-bench-test", device="cpu")
    assert judge.key_points_off(ck, np.random.default_rng(1)) == 0
    wrong = BN256_G1.encode([gold.generator(BN256_G1.spec)], "cpu")
    for c, w in zip(ck.points, wrong):
        c[0] = w[0]  # the first point is always in the sample
    assert judge.key_points_off(ck, np.random.default_rng(1)) == 1


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 3_000_000_019])
def test_z0_lies_in_the_field(seed):
    z = harness.z0_of(harness.load_config("cf_sha256_k18"), seed, bn256_fr.modulus)
    assert len(z) == 1 and 0 <= z[0] < 2**252  # the SHA-256 step's packed state: w7 < 2^28
    z = harness.z0_of(harness.load_config("cf_trivial_k17"), seed, bn256_fr.modulus)
    assert len(z) == 1 and 0 <= z[0] < bn256_fr.modulus
