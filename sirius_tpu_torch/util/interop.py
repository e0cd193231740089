"""State carried across the two packages.

The JAX package stores a field element as (..., 16) uint32 16-bit limbs;
this port as (..., 8) int64 32-bit words.  Both are little-endian and in the
same Montgomery domain (R = 2^256), so conversion is pure repacking.  Data
crosses as numpy arrays: the port never imports jax or `sirius_tpu`, and the
tests hand `np.asarray(jax_array)` in and take `.numpy()` out.  Host objects
(affine points, curve specs) cross by value: `affine_from` rebuilds any
affine point with `.curve.name`, `.x` and `.y` as the port's own.

State carried across: the `*_from` functions rebuild the port's objects
(plain and relaxed instances and traces, a ProtoGalaxy accumulator, the
whole state of a `CyclefoldIVC` or of a Sangria `IVC`) from the JAX
package's by value, so a test can start both packages from one state and
step them side by side.
"""

from __future__ import annotations

import numpy as np
import torch

from ..curves.jpoint import Points, curve_for
from ..fields import gold
from ..fields.jfield import WORDS
from .device import resolve


def limbs_to_words(limbs) -> np.ndarray:
    """(..., 16) 16-bit limbs -> (..., 8) int64 32-bit words."""
    a = np.asarray(limbs).astype(np.int64)
    return a[..., 0::2] | (a[..., 1::2] << 16)


def words_to_limbs(words) -> np.ndarray:
    """(..., 8) 32-bit words (numpy or torch) -> (..., 16) uint32 limbs."""
    if isinstance(words, torch.Tensor):
        words = words.detach().cpu().numpy()
    w = np.asarray(words).astype(np.int64)
    out = np.stack([w & 0xFFFF, w >> 16], axis=-1)
    return out.reshape(w.shape[:-1] + (2 * WORDS,)).astype(np.uint32)


def to_torch(limbs, device=None) -> torch.Tensor:
    """JAX-layout limb array -> port word tensor on `device`."""
    return torch.from_numpy(limbs_to_words(limbs)).to(resolve(device))


def to_numpy(words: torch.Tensor) -> np.ndarray:
    """Port word tensor -> JAX-layout (..., 16) uint32 limb array."""
    return words_to_limbs(words)


def key_from_numpy(curve_spec, x, y, device=None) -> Points:
    """Affine Montgomery key coordinates in either layout ((n, 16) limbs or
    (n, 8) words) -> the port's Jacobian key points (z = 1)."""
    curve = curve_for(curve_spec)
    device = resolve(device)

    def conv(a):
        a = np.asarray(a)
        return torch.from_numpy(limbs_to_words(a) if a.shape[-1] == 2 * WORDS else a.astype(np.int64))

    px, py = conv(x).to(device), conv(y).to(device)
    return Points(px, py, curve.fb.ones(px.shape[:-1], device))


def witness_to_torch(arrays, device=None) -> list[torch.Tensor]:
    """Per-round witness arrays of a JAX `PlonkWitness` / `RelaxedPlonkWitness`
    (list of (size, 16) limb arrays) -> list of port word tensors."""
    device = resolve(device)
    return [to_torch(np.asarray(a), device) for a in arrays]


def witness_to_numpy(tensors) -> list[np.ndarray]:
    """Inverse of `witness_to_torch`."""
    return [to_numpy(t) for t in tensors]


def affine_from(pt) -> gold.AffinePoint:
    """An affine point of either package -> the port's `gold.AffinePoint`
    (by curve name and coordinates; the identity stays the identity)."""
    spec = curve_for(pt.curve).spec
    return gold.identity(spec) if pt.is_identity else gold.AffinePoint(spec, pt.x, pt.y)


def plonk_instance_from(u):
    """A `PlonkInstance` of either package -> the port's."""
    from ..plonk.structure import PlonkInstance

    return PlonkInstance([affine_from(c) for c in u.W_commitments], [list(i) for i in u.instances],
                         list(u.challenges))


def plonk_trace_from(trace, device=None):
    """A `PlonkTrace` (instance + per-round witness arrays) -> the port's."""
    from ..plonk.structure import PlonkTrace, PlonkWitness

    return PlonkTrace(plonk_instance_from(trace.u), PlonkWitness(witness_to_torch(trace.w.W, device)))


def pg_accumulator_from(acc, device=None):
    """A ProtoGalaxy `Accumulator` -> the port's."""
    from ..nifs.protogalaxy import Accumulator

    return Accumulator(plonk_trace_from(acc.trace, device), list(acc.betas), acc.e)


def relaxed_instance_from(U):
    """A Sangria `RelaxedPlonkInstance` -> the port's."""
    from ..nifs.sangria import RelaxedPlonkInstance

    return RelaxedPlonkInstance([affine_from(c) for c in U.W_commitments], list(U.consistency_markers),
                                list(U.challenges), affine_from(U.E_commitment), U.u, U.sc_instances_hash_acc)


def relaxed_trace_from(acc, device=None):
    """A Sangria `RelaxedPlonkTrace` (instance, W rounds, E) -> the port's."""
    from ..nifs.sangria import RelaxedPlonkTrace, RelaxedPlonkWitness

    W = witness_to_torch([*acc.W.W, acc.W.E], device)
    return RelaxedPlonkTrace(relaxed_instance_from(acc.U), RelaxedPlonkWitness(W[:-1], W[-1]))


def cyclefold_ivc_from(pp, ivc, device=None):
    """The state of a `CyclefoldIVC` of either package (self_acc,
    support_acc, primary_trace, z_0, z_i, step, support_pub_instances) on
    the port's public parameters `pp`: a port `CyclefoldIVC` that continues
    from it."""
    from ..ivc.cyclefold_ivc import CyclefoldIVC
    from ..ivc.support_fold import SupportFoldChain

    out = CyclefoldIVC.__new__(CyclefoldIVC)
    out.pp = pp
    out.step = ivc.step
    out.z_0, out.z_i = list(ivc.z_0), list(ivc.z_i)
    out.self_acc = pg_accumulator_from(ivc.self_acc, device)
    out.primary_trace = plonk_trace_from(ivc.primary_trace, device)
    out.support = SupportFoldChain(pp.ck2, pp.S_support, pp.support_taped, pp_digest=pp.digest)
    out.support.acc = relaxed_trace_from(ivc.support_acc, device)
    out.support.pub_instances = [[list(i) for i in inst] for inst in ivc.support_pub_instances]
    return out


def sangria_ivc_from(pp, ivc, device=None):
    """The state of a Sangria `IVC` of either package (both relaxed traces,
    the pending secondary trace, z_0 / z_i of both sides, step and the
    public-instance lists) on the port's public parameters `pp`: a port
    `IVC` that continues from it."""
    from ..ivc.sangria_ivc import IVC
    from ..nifs.sangria import VanillaFS

    out = IVC.__new__(IVC)
    out.pp = pp
    out.step = ivc.step
    out.primary_nifs_pp, _ = VanillaFS.setup_params(pp.digest_1, pp.primary.S)
    out.secondary_nifs_pp, _ = VanillaFS.setup_params(pp.digest_2, pp.secondary.S)
    out.primary_z_0, out.primary_z_i = list(ivc.primary_z_0), list(ivc.primary_z_i)
    out.secondary_z_0, out.secondary_z_i = list(ivc.secondary_z_0), list(ivc.secondary_z_i)
    out.primary_relaxed = relaxed_trace_from(ivc.primary_relaxed, device)
    out.secondary_relaxed = relaxed_trace_from(ivc.secondary_relaxed, device)
    out.secondary_trace = plonk_trace_from(ivc.secondary_trace, device)
    out.primary_pub_instances = [[list(i) for i in inst] for inst in ivc.primary_pub_instances]
    out.secondary_pub_instances = [[list(i) for i in inst] for inst in ivc.secondary_pub_instances]
    return out
