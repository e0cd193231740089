"""Pedersen vector commitments over a fixed generator key.

Counterpart of `sirius_tpu/ops/commitment.py`.  `setup` derives 2^k
generators from a Shake256 XOF over the label through SVDW hash-to-curve
on the host (the benchmark's keys are built by the program and loaded
here from its cache, `_load_cached`); commits are MSMs over the first
len(v) generators (`ops/msm.py`).  Keys
cache as `CACHE_DIR/<curve>-<label>-<k>.npz` with the JAX package's packed
format ((n, 8) uint32 Montgomery words `xw`, `yw`; z = 1 implied), so a key
written by either package loads in the other.  A legacy cache of the JAX
package ((n, 16) 16-bit limb arrays `x`, `y`, `z`) loads too: the limbs pack
into the same Montgomery words (R = 2^256 at both widths), and points with
z != 1 are normalized to affine on the device.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

import numpy as np
import torch

from . import msm as msm_ops
from ..curves.hash_to_curve import hash_bytes_to_point
from ..curves.jpoint import Curve, Points
from ..fields import gold
from ..fields.jfield import field_for, ints_to_words
from ..util.device import resolve
from ..util.ro import NUM_CHALLENGE_BITS
from .poseidon import PoseidonHash, poseidon_spec

CACHE_DIR = os.environ.get("SIRIUS_TPU_CACHE", os.path.expanduser("~/.cache/sirius_tpu"))

class CommitmentError(Exception):
    pass


class TooLongInput(CommitmentError):
    def __init__(self, input_len, limit):
        super().__init__(f"input len {input_len} > key size {limit}")


def _limb_words(limbs: np.ndarray) -> torch.Tensor:
    """(n, 16) 16-bit limbs -> (n, 8) int64 32-bit words (the same value)."""
    a = limbs.astype(np.int64)
    return torch.from_numpy(a[:, 0::2] | (a[:, 1::2] << 16))


def _load_cached(curve: Curve, path: str, device) -> Points:
    """The key points of a cache file, packed (`xw`, `yw`) or legacy limb
    arrays (`x`, `y`, `z`), as a Jacobian batch with z = 1 on `device`."""
    f = curve.fb
    with np.load(path) as data:
        if "xw" in data:
            px, py = (torch.from_numpy(data[c].astype(np.int64)).to(device) for c in ("xw", "yw"))
            return Points(px, py, f.ones((px.shape[0],), device))
        px, py, pz = (_limb_words(data[c]).to(device) for c in ("x", "y", "z"))
    one = f.ones((px.shape[0],), device)
    if f.eq(pz, one).all():
        return Points(px, py, one)
    if f.is_zero(pz).any():
        raise CommitmentError(f"{path}: a key point at infinity (z = 0) cannot be a generator")
    zi = f.batch_inv(pz)
    zi2 = f.square(zi)
    return Points(f.mul(px, zi2), f.mul(py, f.mul(zi2, zi)), one)


@dataclass
class CommitmentKey:
    """2^k generators on `points.device` as a Jacobian batch with z = 1."""

    curve: Curve
    points: Points
    label: bytes
    k: int

    def __len__(self):
        return self.points.x.shape[0]

    @property
    def device(self):
        return self.points.x.device

    @staticmethod
    def cache_file(curve: Curve, k: int, label: bytes) -> str:
        return os.path.join(CACHE_DIR, f"{curve.spec.name}-{label.decode(errors='ignore')}-{k}.npz")

    @staticmethod
    def setup(curve: Curve, k: int, label: bytes, use_cache: bool = True, device=None) -> "CommitmentKey":
        n = 1 << k
        device = resolve(device)
        path = CommitmentKey.cache_file(curve, k, label)
        if use_cache and os.path.exists(path):
            return CommitmentKey(curve, _load_cached(curve, path, device), label, k)

        stream = hashlib.shake_256(label).digest(64 * n)
        affine = [hash_bytes_to_point(curve.spec, stream[64 * i : 64 * (i + 1)]) for i in range(n)]
        pts = curve.encode(affine, device)
        if use_cache:
            os.makedirs(CACHE_DIR, exist_ok=True)
            np.savez(path, xw=pts.x.cpu().numpy().astype(np.uint32),
                     yw=pts.y.cpu().numpy().astype(np.uint32))
        return CommitmentKey(curve, pts, label, k)

    def _prefix(self, n: int) -> Points:
        if n > len(self):
            raise TooLongInput(n, len(self))
        return Points(*(c[:n] for c in self.points))

    def commit_device(self, w_mont) -> gold.AffinePoint:
        """Commit to a (size, 8) Montgomery tensor."""
        n = w_mont.shape[0]
        pts = self._prefix(n)
        if n == 0:
            return gold.identity(self.curve.spec)
        return msm_ops.best_msm(self.curve, self.curve.fs.from_mont(w_mont), pts)

    def batched_commit_check(self, pairs) -> list[int]:
        """Check commit(W_i) == C_i for all pairs with one MSM: Fiat-Shamir
        rho_i from a Poseidon transcript over the claimed commitments, then
        commit(sum rho_i W_i) == sum rho_i C_i (sound up to 2^-128).  Returns
        the failing indices ([] = all pass), localised pair by pair on a
        mismatch."""
        pairs = list(pairs)
        if not pairs:
            return []
        if len(pairs) == 1:
            W, C = pairs[0]
            return [] if self.commit_device(W) == C else [0]
        fs = field_for(self.curve.fs.spec)
        ro = PoseidonHash(poseidon_spec(self.curve.spec.scalar, 3, 2, 4, 3))
        for _, C in pairs:
            x, y = (0, 0) if C.is_identity else (C.x, C.y)
            ro.absorb_field(x % fs.p)
            ro.absorb_field(y % fs.p)
        rhos = [ro.squeeze(NUM_CHALLENGE_BITS) % fs.p for _ in pairs]

        max_n = max(int(W.shape[0]) for W, _ in pairs)
        dev = pairs[0][0].device
        acc = fs.zeros((max_n,), dev)
        for rho, (W, _) in zip(rhos, pairs):
            term = fs.mul(W, fs.encode(rho, dev))
            acc = torch.cat([fs.add(acc[: W.shape[0]], term), acc[W.shape[0] :]])
        expected = gold.identity(self.curve.spec)
        for rho, (_, C) in zip(rhos, pairs):
            expected = expected.add(C.mul(rho))
        if self.commit_device(acc) == expected:
            return []
        return [i for i, (W, C) in enumerate(pairs) if self.commit_device(W) != C]

    def commit(self, v) -> gold.AffinePoint:
        """Commit to host ints or an (n, 8) standard-form word tensor."""
        if isinstance(v, (list, tuple)):
            p = self.curve.fs.p
            v = torch.from_numpy(ints_to_words([x % p for x in v])).to(self.device)
        pts = self._prefix(v.shape[0])
        if v.shape[0] == 0:
            return gold.identity(self.curve.spec)
        return msm_ops.best_msm(self.curve, v, pts)

    def host_points(self) -> list[gold.AffinePoint]:
        return self.curve.decode(self.points)
