"""Pedersen vector commitments over a fixed generator key.

Counterpart of `sirius_tpu/ops/commitment.py`.  `setup` derives 2^k
generators from a Shake256 XOF over the label through SVDW hash-to-curve
(on the device in chunks of `DEVICE_SETUP_CHUNK` points);
commits are MSMs over the first len(v) generators (`ops/msm.py`); under an
active mesh of more than one entry (`parallel/context.py`) `commit_device`
cuts them by rows over the mesh (`msm_sharded`).  A round held as row
blocks (`parallel/rows.py`) commits block by block: block d's scalars,
converted from Montgomery form on its device, pair with the key points of
its table rows in every column (`row_shards`).  Keys
cache as `CACHE_DIR/<curve>-<label>-<k>.npz` with the JAX package's packed
format ((n, 8) uint32 Montgomery words `xw`, `yw`; z = 1 implied), so a key
written by either package loads in the other.  A legacy cache of the JAX
package ((n, 16) 16-bit limb arrays `x`, `y`, `z`) loads too: the limbs pack
into the same Montgomery words (R = 2^256 at both widths), and points with
z != 1 are normalized to affine on the device.  With the profiler on
(`util/profiling`), `setup` runs in a `commitment_key` span and each
outermost commit in a `commit` span that counts what it reads and writes.
"""

from __future__ import annotations

import functools
import hashlib
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from . import msm as msm_ops
from ..curves.hash_to_curve import hash_bytes_to_point, hash_bytes_to_points_device
from ..curves.jpoint import Curve, Points
from ..fields import gold
from ..fields.jfield import field_for, ints_to_words
from ..parallel.context import get_mesh
from ..parallel.mesh import Mesh
from ..parallel.rows import RowBlocks
from ..util.device import resolve
from ..util.profiling import profiler, span
from ..util.ro import NUM_CHALLENGE_BITS
from .poseidon import PoseidonHash, poseidon_spec

CACHE_DIR = os.environ.get("SIRIUS_TPU_CACHE", os.path.expanduser("~/.cache/sirius_tpu"))

# below this size the host map is cheaper than a batched device map
DEVICE_SETUP_MIN = 4096
# points per batched device map: its working set bounds the setup's peak
# device memory whatever the key size (a field product over the 6 x chunk
# rows of the square roots builds a (16, 16, 6 x chunk) int64 tensor: 0.8 GB
# at 2^16); the JAX package maps in the same chunks
DEVICE_SETUP_CHUNK = 1 << 16


class CommitmentError(Exception):
    pass


class TooLongInput(CommitmentError):
    def __init__(self, input_len, limit):
        super().__init__(f"input len {input_len} > key size {limit}")


def _rows(w) -> int:
    """Scalars of a round: a (size, 8) tensor's rows or row blocks' n x cols."""
    return w.n * w.cols if isinstance(w, RowBlocks) else int(w.shape[0])


def _commit_span(size):
    """Decorate a commit entry point: an outermost call (no `commit` span
    open on its thread) runs in a `commit` span counting the (scalars read,
    key points read, points written) that `size` gives of its argument.
    Nothing is counted while the profiler is off."""

    def wrap(fn):
        @functools.wraps(fn)
        def traced(key, arg):
            if not profiler.enabled or profiler.is_open("commit"):
                return fn(key, arg)
            if not isinstance(arg, (torch.Tensor, RowBlocks)):
                arg = list(arg)  # the batched check's pairs may be an iterator
            counts = dict(zip(("scalars", "points", "results"), size(arg)))
            with span("commit", counts=counts):
                return fn(key, arg)

        return traced

    return wrap


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
    # the row shards of the first n points on each mesh entry's device, by (mesh, n), and the points
    # of a round's row blocks of cols > 1 columns of n rows, by (mesh, (n, cols))
    shard_cache: dict = field(default_factory=dict, repr=False, compare=False)

    def __len__(self):
        return self.points.x.shape[0]

    @property
    def device(self):
        return self.points.x.device

    @staticmethod
    def cache_file(curve: Curve, k: int, label: bytes) -> str:
        return os.path.join(CACHE_DIR, f"{curve.spec.name}-{label.decode(errors='ignore')}-{k}.npz")

    @staticmethod
    @span("commitment_key")
    def setup(curve: Curve, k: int, label: bytes, use_cache: bool = True, device=None) -> "CommitmentKey":
        """The key of 2^k points from the cache (span `ck_load`), else derived
        from the label by hash-to-curve and cached (span `ck_derive`)."""
        n = 1 << k
        device = resolve(device)
        path = CommitmentKey.cache_file(curve, k, label)
        if use_cache and os.path.exists(path):
            with span("ck_load"):
                return CommitmentKey(curve, _load_cached(curve, path, device), label, k)

        with span("ck_derive"):
            stream = hashlib.shake_256(label).digest(64 * n)
            if n >= DEVICE_SETUP_MIN:
                step = DEVICE_SETUP_CHUNK
                parts = [hash_bytes_to_points_device(curve, stream[64 * i : 64 * (i + step)], device)
                         for i in range(0, n, step)]
                pts = Points(*(torch.cat(coords) for coords in zip(*parts)))
            else:
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

    def shards(self, mesh: Mesh, n: int) -> list[Points]:
        """The first n points cut into the mesh's row blocks, each on its
        mesh entry's device (views on the key's own device), placed once per
        (mesh, n) and kept."""
        if (mesh, n) not in self.shard_cache:
            self.shard_cache[(mesh, n)] = msm_ops.shard_points(mesh, self._prefix(n))
        return self.shard_cache[(mesh, n)]

    def row_shards(self, mesh: Mesh, n: int, cols: int) -> list[Points]:
        """The key points that pair with the row blocks of a round of `cols`
        columns of n table rows: block d's are points {c n + r : c < cols,
        r in its rows}, column-major, on its device; gathered once per
        (mesh, n, cols) and kept (one column: `shards`)."""
        if cols == 1:
            return self.shards(mesh, n)
        key = (mesh, (n, cols))
        if key not in self.shard_cache:
            pts, nb = self._prefix(cols * n), n // mesh.size
            col0 = torch.arange(cols, device=self.device)[:, None] * n
            self.shard_cache[key] = [
                Points(*(c[(col0 + torch.arange(d * nb, (d + 1) * nb, device=self.device)).reshape(-1)].to(dev)
                         for c in pts))
                for d, dev in enumerate(mesh.devices)]
        return self.shard_cache[key]

    @_commit_span(lambda w: (_rows(w), _rows(w), 1))
    def commit_device(self, w_mont) -> gold.AffinePoint:
        """Commit to a (size, 8) Montgomery tensor.  The conversion to
        standard form runs on W's device; under an active mesh of more than
        one entry the standard words and the key go by rows to the mesh's
        devices (`msm_sharded`).  Row blocks commit block by block on their
        own mesh (`row_shards`)."""
        if isinstance(w_mont, RowBlocks):
            scalars = [self.curve.fs.from_mont(b) for b in w_mont.blocks]
            return msm_ops.msm_sharded(self.curve, scalars, self.row_shards(w_mont.mesh, w_mont.n, w_mont.cols),
                                       w_mont.mesh)
        n = w_mont.shape[0]
        pts = self._prefix(n)
        if n == 0:
            return gold.identity(self.curve.spec)
        scalars = self.curve.fs.from_mont(w_mont)
        mesh = get_mesh()
        if mesh is not None and mesh.size > 1:
            return msm_ops.msm_sharded(self.curve, scalars, self.shards(mesh, n), mesh)
        return msm_ops.best_msm(self.curve, scalars, pts)

    @_commit_span(lambda ws: (int(ws.shape[0]) * int(ws.shape[1]), int(ws.shape[1]), int(ws.shape[0])))
    def commit_device_many(self, w_monts: torch.Tensor) -> list:
        """Commit to a (t, size, 8) batch over the shared key prefix, on the
        key's device under a mesh too (as the JAX package's)."""
        pts = self._prefix(w_monts.shape[1])
        return msm_ops.msm_many(self.curve, self.curve.fs.from_mont(w_monts), pts)

    @_commit_span(lambda pairs: (sum(_rows(W) for W, _ in pairs), max((_rows(W) for W, _ in pairs), default=0), 1))
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

        blocked = [W for W, _ in pairs if isinstance(W, RowBlocks)]
        if blocked:
            acc = self._rlc_blocks(fs, rhos, [W for W, _ in pairs], max(blocked, key=lambda W: W.cols))
        else:
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

    @staticmethod
    def _rlc_blocks(fs, rhos, Ws, widest: RowBlocks) -> RowBlocks:
        """sum rho_i W_i of rounds of different column counts, block by block
        in the layout of the round with the most columns: a round of c
        columns is the first c columns of every block, as it is the first
        c n rows of the unsharded sum."""
        mesh, n, nb = widest.mesh, widest.n, widest.nb
        Ws = [W if isinstance(W, RowBlocks) else RowBlocks.shard(mesh, W, n) for W in Ws]
        blocks = []
        for d, dev in enumerate(mesh.devices):
            acc = fs.zeros((widest.cols * nb,), dev)
            for rho, W in zip(rhos, Ws):
                part = W.blocks[d]
                term = fs.mul(part, fs.encode(rho, dev))
                acc = torch.cat([fs.add(acc[: part.shape[0]], term), acc[part.shape[0] :]])
            blocks.append(acc)
        return RowBlocks(mesh, n, widest.cols, blocks)

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
